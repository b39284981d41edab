"""Shadow/canary policy rollout: automated promote/rollback rails (port
of `repro.service.rollout`).

`ShadowServer` fronts two `AutotuneServer`s — the *primary* serving the
promoted snapshot and, while a rollout is in flight, a *candidate*
serving a challenger snapshot. Traffic is split deterministically:

  * a configurable **canary slice** (``canary_frac``) is answered by the
    candidate (client-visible — its responses carry the candidate's
    ``policy_version``);
  * every primary-slice request is optionally **mirrored** into the
    candidate as shadow evaluation: the candidate solves and learns from
    it, but the shadow response is discarded and never answers a client.

Promotion is staged through the registry: `start_rollout` promotes the
candidate version immediately (CURRENT flips — which is exactly what
makes `PolicyRegistry.rollback()` the degradation path), while the
primary keeps serving the prior snapshot to the non-canary slice. Every
``decision_window`` candidate responses the gate runs against hard
floors whose baselines come from the *baseline snapshot's meta*
(embedded there by ``AutotuneServer.snapshot()``; live primary
telemetry is the fallback for warm-start versions without evidence):

  * minimum candidate sample count (hold until reached);
  * candidate reward EWMA within ``reward_margin`` of the baseline's;
  * ferr/nbe pass rate (fraction of CONVERGED outcomes) above
    ``pass_rate_floor`` (and within ``pass_rate_margin`` of baseline);
  * per-bucket p99 latency within ``p99_bound`` × the baseline's.

Any gate failure rolls back immediately (`registry.rollback()` restores
the prior version, the candidate is drained and retired); a sustained
pass over ``promote_windows`` consecutive windows confirms the
promotion and the candidate takes all traffic. Every decision is
counted in ``repro_rollout_decisions_total{outcome}`` and appended to a
decision-trail JSONL when ``decision_log_path`` is set.

With ``ope_gate=True`` a candidate must additionally clear an
*off-policy* gate before `start_rollout` admits it at all (DESIGN.md
§10.3): its doubly-robust reward estimate over the logged trajectory
stream (`eval.ope`, propensities reconstructed from the logged
epsilon/explore fields) must have a lower confidence bound no worse
than the incumbent's estimate minus ``ope_margin``. A refused
candidate never takes a canary slice: `start_rollout` raises
`OPEGateRejected`, the refusal is appended to the decision trail and
counted as ``outcome="ope_reject"``, and the verdict (estimates, CIs)
is annotated into the candidate version's registry meta.

Single-threaded like everything in `service/`: routing, gating, and
promotion all run on the caller's thread (the HTTP front door serializes
through its worker). Both arms solve on the task's device. AOT warmup
and the build directory (`warmup`, `warmup_buckets`,
`compile_cache_dir`) apply to the primary, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.rewards import RewardConfig
from repro_torch.obs import Observability, TrajectoryLog
from repro_torch.service.batcher import BatcherConfig
from repro_torch.service.instrument import RolloutInstruments
from repro_torch.service.online import OnlineConfig
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.server import AutotuneServer, SolveResponse


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    canary_frac: float = 0.25     # client traffic slice answered by the
                                  # candidate
    shadow: bool = True           # mirror primary-slice traffic into the
                                  # candidate (evaluation only)
    decision_window: int = 32     # candidate responses between gate runs
    min_samples: int = 16         # hard floor: hold until this many
    promote_windows: int = 2      # consecutive passing windows to confirm
    reward_margin: float = 0.5    # candidate reward EWMA may trail the
                                  # baseline by at most this
    pass_rate_floor: float = 0.75  # absolute ferr/nbe pass-rate floor
    pass_rate_margin: float = 0.25  # allowed pass-rate drop vs baseline
    p99_bound: float = 3.0        # per-bucket p99 <= bound * baseline p99
    min_bucket_samples: int = 8   # p99 compared only for buckets with
                                  # this many candidate samples
    seed: int = 0                 # routing rng (deterministic slices)
    # -- off-policy evaluation gate (eval.ope, DESIGN.md §10.3) --------
    ope_gate: bool = False        # score candidates on the trajectory
                                  # log before any canary traffic
    ope_margin: float = 0.5       # candidate DR LCB must reach
                                  # incumbent DR estimate - margin
    ope_min_records: int = 64     # below this many logged records the
                                  # gate abstains (canary gates rule)
    ope_bootstrap: int = 200      # bootstrap resamples for the CI
    ope_ci: float = 0.90          # two-sided CI coverage
    ope_weight_clip: float = 100.0  # IPS/DR importance-weight cap


@dataclasses.dataclass
class RolloutDecision:
    outcome: str                  # "hold" | "promote" | "rollback"
                                  # | "ope_accept" | "ope_reject"
    responses: int                # candidate responses at decision time
    windows_passed: int
    failures: List[str]
    evidence: Dict[str, object]
    candidate_version: str
    baseline_version: Optional[str]


class OPEGateRejected(RuntimeError):
    """Candidate refused a canary slice by the off-policy gate.

    Carries the full `OPEGateReport` so callers (and the HTTP front
    door's error payloads) can show the numbers the refusal rests on."""

    def __init__(self, report):
        self.report = report
        lcb = (report.candidate["dr"].ci_lo
               if report.candidate else None)
        super().__init__(
            f"candidate refused by OPE gate ({report.reason}): "
            f"DR lower confidence bound {lcb} < floor {report.floor}")


class ShadowServer:
    """Canary router + rollout controller over two `AutotuneServer`s."""

    def __init__(self,
                 registry: PolicyRegistry,
                 task=None,
                 reward_cfg: RewardConfig = RewardConfig(),
                 batcher_cfg: BatcherConfig = BatcherConfig(),
                 online_cfg: OnlineConfig = OnlineConfig(),
                 rollout_cfg: RolloutConfig = RolloutConfig(),
                 clock: Callable[[], float] = _time.monotonic,
                 seed: int = 0,
                 executor=None,
                 obs=None,
                 decision_log_path: Optional[str] = None,
                 warmup: Optional[str] = None,
                 warmup_buckets: Optional[List[int]] = None,
                 compile_cache_dir: Optional[str] = None):
        self.registry = registry
        self.rollout_cfg = rollout_cfg
        self.clock = clock
        self.seed = seed
        self._task_arg = task
        self._reward_cfg = reward_cfg
        self._batcher_cfg = batcher_cfg
        self._online_cfg = online_cfg
        self._executor = executor
        # AOT warmup / build-directory wiring (DESIGN.md §12) applies to
        # the primary only: candidate servers are built in the same
        # process later, when the cells are already warm (the
        # dispatchers in `core.executor` are process-wide).
        self.primary = AutotuneServer(
            registry, task=task, reward_cfg=reward_cfg,
            batcher_cfg=batcher_cfg, online_cfg=online_cfg, clock=clock,
            seed=seed, executor=executor, obs=obs, warmup=warmup,
            warmup_buckets=warmup_buckets,
            compile_cache_dir=compile_cache_dir)
        self.candidate: Optional[AutotuneServer] = None
        self.phase = "idle"       # idle|canary|promoted|rolled_back
        self.candidate_version: Optional[str] = None
        self.baseline_version: Optional[str] = None
        self.windows_passed = 0
        self.decisions: List[RolloutDecision] = []
        self._decision_counts: Dict[str, int] = {}
        self._baseline_tel: Optional[dict] = None
        self._route_rng = np.random.default_rng(rollout_cfg.seed)
        self._ids = 0             # client-visible ids (>= 0)
        self._shadow_ids = -1     # mirrored ids (< 0, never client-visible)
        self._owner: Dict[int, AutotuneServer] = {}
        self._last_window_at = 0  # candidate responses at last gate run
        self._decision_due = False
        self._instr = (RolloutInstruments(
            self.primary.obs, getattr(self.primary.task, "name", "unknown"))
            if self.primary.obs is not None else None)
        self._decision_log = (TrajectoryLog(decision_log_path)
                              if decision_log_path else None)
        # Push-style subscriber for client-visible responses (primary +
        # canary slices, never shadow), mirroring AutotuneServer.
        self.on_response: Optional[Callable[[SolveResponse], None]] = None
        self.primary.on_response = self._on_primary_response

    # -- delegation ---------------------------------------------------------
    @property
    def task(self):
        return self.primary.task

    @property
    def obs(self):
        return self.primary.obs

    @property
    def telemetry(self):
        return self.primary.telemetry

    @property
    def policy_version(self) -> str:
        return self.primary.policy_version

    @property
    def pending(self) -> int:
        n = self.primary.pending
        if self.candidate is not None:
            n += self.candidate.pending
        return n

    @property
    def ready(self) -> bool:
        return self.primary.ready

    @property
    def breakers(self):
        return self.primary.breakers

    @property
    def last_recovery(self):
        return self.primary.last_recovery

    def degradation_state(self) -> dict:
        return self.primary.degradation_state()

    @property
    def auto_step(self) -> bool:
        return self.primary.auto_step

    @auto_step.setter
    def auto_step(self, value: bool) -> None:
        self.primary.auto_step = value
        if self.candidate is not None:
            self.candidate.auto_step = value

    # -- rollout lifecycle --------------------------------------------------
    def start_rollout(self, version: str,
                      trajectories: Optional[List[dict]] = None) -> None:
        """Promote `version` as the canary candidate and start routing a
        traffic slice to it; the prior CURRENT becomes the rollback
        target and its snapshot meta the gate baseline.

        With ``rollout_cfg.ope_gate`` the candidate is first scored
        off-policy against the incumbent on `trajectories` (default:
        this server's own trajectory log) and refused — no promotion,
        no canary traffic — with `OPEGateRejected` if its DR lower
        confidence bound misses the floor (DESIGN.md §10.3)."""
        if self.phase == "canary":
            raise RuntimeError("a rollout is already in flight")
        baseline = self.registry.current_version()
        if self.rollout_cfg.ope_gate:
            self._run_ope_gate(version, baseline, trajectories)
        policy = self.registry.load(version)
        self.registry.promote(version)      # rollback() now restores prior
        cand = AutotuneServer(
            policy, task=self._task_arg, reward_cfg=self._reward_cfg,
            batcher_cfg=self._batcher_cfg, online_cfg=self._online_cfg,
            clock=self.clock, seed=self.seed + 1, executor=self._executor,
            obs=False)
        cand.registry = self.registry
        cand.policy_version = version
        cand.auto_step = self.primary.auto_step
        cand.on_response = self._on_candidate_response
        self.candidate = cand
        self.candidate_version = version
        self.baseline_version = baseline
        self._baseline_tel = None
        if baseline is not None:
            try:
                self._baseline_tel = self.registry.meta(baseline).get(
                    "telemetry")
            except (OSError, ValueError, KeyError):
                self._baseline_tel = None
        self.phase = "canary"
        self.windows_passed = 0
        self._last_window_at = 0
        if self._instr is not None:
            self._instr.on_state(True, 0, 0)
        self._log_event({"event": "start", "candidate": version,
                         "baseline": baseline,
                         "canary_frac": self.rollout_cfg.canary_frac,
                         "shadow": self.rollout_cfg.shadow})

    # -- off-policy gate ----------------------------------------------------
    def _logged_trajectories(self) -> List[dict]:
        """Complete OPE-schema records from the primary's own trajectory
        log (all live segments). Empty when the server runs without a
        trajectory log — the gate then abstains via its
        insufficient-records rule."""
        obs = self.primary.obs
        if obs is None or obs.trajlog is None:
            return []
        try:
            return TrajectoryLog.read_complete(
                obs.trajlog.path,
                task=getattr(self.primary.task, "name", None))
        except OSError:
            return []

    def _run_ope_gate(self, version: str, baseline: Optional[str],
                      trajectories: Optional[List[dict]]) -> None:
        """Score the candidate off-policy and raise `OPEGateRejected`
        on refusal. Runs before `registry.promote`, so a refused
        candidate never becomes CURRENT and never sees traffic."""
        from repro_torch.eval.ope import OPEConfig, SnapshotCandidate, ope_gate
        cfg = self.rollout_cfg
        records = (list(trajectories) if trajectories is not None
                   else self._logged_trajectories())
        cand = SnapshotCandidate.from_registry(self.registry, version)
        inc = (SnapshotCandidate.from_registry(self.registry, baseline)
               if baseline is not None else None)
        report = ope_gate(
            records, inc, cand, n_actions=cand.n_actions,
            margin=cfg.ope_margin, min_records=cfg.ope_min_records,
            cfg=OPEConfig(n_bootstrap=cfg.ope_bootstrap, ci=cfg.ope_ci,
                          seed=cfg.seed, weight_clip=cfg.ope_weight_clip))
        outcome = "ope_accept" if report.accept else "ope_reject"
        event = report.to_event()
        decision = RolloutDecision(
            outcome=outcome, responses=0, windows_passed=0,
            failures=([] if report.accept else [report.reason]),
            evidence=event, candidate_version=version,
            baseline_version=baseline)
        self.decisions.append(decision)
        self._decision_counts[outcome] = \
            self._decision_counts.get(outcome, 0) + 1
        if self._instr is not None:
            self._instr.on_decision(outcome)
        self._log_event({"event": "ope_gate", "outcome": outcome,
                         "candidate": version, "baseline": baseline,
                         "reason": report.reason, "gate": event})
        try:                        # audit trail in the version's meta
            self.registry.annotate(version, "ope_gate", event)
        except Exception:
            pass                    # fail-open: evidence, not control flow
        if not report.accept:
            raise OPEGateRejected(report)

    # -- request path -------------------------------------------------------
    def submit(self, instance) -> int:
        rid = self._ids
        self._ids += 1
        cfg = self.rollout_cfg
        canary = (self.phase == "canary"
                  and float(self._route_rng.random()) < cfg.canary_frac)
        if canary:
            self._owner[rid] = self.candidate
            self.candidate.submit(instance, req_id=rid)
            if self._instr is not None:
                self._instr.on_route("candidate")
        else:
            self._owner[rid] = self.primary
            self.primary.submit(instance, req_id=rid)
            if self._instr is not None:
                self._instr.on_route("primary")
            if self.phase == "canary" and cfg.shadow:
                sid = self._shadow_ids
                self._shadow_ids -= 1
                self.candidate.submit(instance, req_id=sid)
                if self._instr is not None:
                    self._instr.on_route("shadow")
        self._maybe_decide()
        return rid

    def step(self, force: bool = False) -> List[SolveResponse]:
        done = self.primary.step(force=force)
        if self.candidate is not None:
            done += [r for r in self.candidate.step(force=force)
                     if r.request_id >= 0]
        self._maybe_decide()
        return done

    def drain(self) -> List[SolveResponse]:
        return self.step(force=True)

    def poll(self, req_id: int) -> Optional[SolveResponse]:
        server = self._owner.get(req_id)
        if server is None:
            return None
        resp = server.poll(req_id)
        if resp is not None:
            del self._owner[req_id]
        return resp

    # -- completion hooks ---------------------------------------------------
    def _on_primary_response(self, resp: SolveResponse) -> None:
        if resp.request_id < 0:             # defensively drop shadow ids
            self.primary.poll(resp.request_id)
            return
        if self.on_response is not None:
            self.on_response(resp)

    def _on_candidate_response(self, resp: SolveResponse) -> None:
        cand = self.candidate
        if resp.request_id < 0:
            if cand is not None:
                cand.poll(resp.request_id)  # discard: shadow, never answered
        elif self.on_response is not None:
            self.on_response(resp)
        if (self.phase == "canary" and cand is not None
                and cand.telemetry.responses - self._last_window_at
                >= self.rollout_cfg.decision_window):
            self._decision_due = True
        if self._instr is not None and cand is not None:
            self._instr.on_state(self.phase == "canary",
                                 self.windows_passed,
                                 cand.telemetry.responses)

    # -- gating -------------------------------------------------------------
    def _maybe_decide(self) -> Optional[RolloutDecision]:
        """Run the gate if a decision window elapsed. Deferred out of the
        completion hook so promote/rollback never tear a server down
        mid-`step()`."""
        if not self._decision_due or self.phase != "canary":
            self._decision_due = False
            return None
        self._decision_due = False
        self._last_window_at = self.candidate.telemetry.responses
        decision = self._evaluate_gates()
        self._record(decision)
        if decision.outcome == "rollback":
            self._rollback()
        elif decision.outcome == "promote":
            self._promote()
        return decision

    def _evaluate_gates(self) -> RolloutDecision:
        cfg = self.rollout_cfg
        tel = self.candidate.telemetry
        n = tel.responses
        failures: List[str] = []
        evidence: Dict[str, object] = {"responses": n}
        base = self._baseline_tel or {}
        if not base and self.primary.telemetry.responses:
            # Warm-start versions carry no telemetry evidence; fall back
            # to the live primary arm observed on the same stream.
            ptel = self.primary.telemetry
            base = {"reward_ewma": ptel.reward_ewma.value,
                    "converged_frac": ptel.converged_frac,
                    "latency_s_per_bucket":
                        {str(b): p for b, p in
                         ptel.latency_percentiles_per_bucket().items()}}
            evidence["baseline_source"] = "primary_live"
        else:
            evidence["baseline_source"] = ("snapshot_meta" if base
                                           else "none")
        if n < cfg.min_samples:
            evidence["min_samples"] = cfg.min_samples
            return self._decision("hold", failures + ["min_samples"],
                                  evidence)
        base_reward = base.get("reward_ewma")
        cand_reward = tel.reward_ewma.value
        evidence["reward_ewma"] = {"candidate": cand_reward,
                                   "baseline": base_reward,
                                   "margin": cfg.reward_margin}
        if (base_reward is not None
                and cand_reward < base_reward - cfg.reward_margin):
            failures.append("reward_ewma")
        pass_floor = cfg.pass_rate_floor
        base_pass = base.get("converged_frac")
        if base_pass is not None:
            pass_floor = max(pass_floor, base_pass - cfg.pass_rate_margin)
        evidence["pass_rate"] = {"candidate": tel.converged_frac,
                                 "baseline": base_pass,
                                 "floor": pass_floor}
        if tel.converged_frac < pass_floor:
            failures.append("pass_rate")
        base_p99 = base.get("latency_s_per_bucket") or {}
        cand_p99 = tel.latency_percentiles_per_bucket()
        p99_ev = {}
        for bucket, pct in cand_p99.items():
            res = tel._latencies_per_bucket.get(bucket)
            if res is None or len(res) < cfg.min_bucket_samples:
                continue
            bp = base_p99.get(str(bucket), {}).get("p99")
            if bp is None or bp <= 0:
                continue
            p99_ev[str(bucket)] = {"candidate": pct["p99"],
                                   "baseline": bp,
                                   "bound": cfg.p99_bound}
            if pct["p99"] > cfg.p99_bound * bp:
                failures.append(f"p99_bucket_{bucket}")
        evidence["p99_per_bucket"] = p99_ev
        if failures:
            return self._decision("rollback", failures, evidence)
        windows = self.windows_passed + 1
        if windows >= cfg.promote_windows:
            return self._decision("promote", [], evidence,
                                  windows_passed=windows)
        return self._decision("hold", [], evidence, windows_passed=windows)

    def _decision(self, outcome: str, failures: List[str],
                  evidence: Dict[str, object],
                  windows_passed: Optional[int] = None) -> RolloutDecision:
        return RolloutDecision(
            outcome=outcome,
            responses=self.candidate.telemetry.responses,
            windows_passed=(self.windows_passed if windows_passed is None
                            else windows_passed),
            failures=failures, evidence=evidence,
            candidate_version=self.candidate_version,
            baseline_version=self.baseline_version)

    def _record(self, decision: RolloutDecision) -> None:
        self.windows_passed = decision.windows_passed
        self.decisions.append(decision)
        self._decision_counts[decision.outcome] = \
            self._decision_counts.get(decision.outcome, 0) + 1
        if self._instr is not None:
            self._instr.on_decision(decision.outcome)
        self._log_event({"event": "decision",
                         "outcome": decision.outcome,
                         "responses": decision.responses,
                         "windows_passed": decision.windows_passed,
                         "failures": decision.failures,
                         "evidence": decision.evidence,
                         "candidate": decision.candidate_version,
                         "baseline": decision.baseline_version})

    # -- transitions --------------------------------------------------------
    def _rollback(self) -> None:
        """Degraded candidate: restore the prior version and retire the
        candidate (drained so in-flight canary requests still answer)."""
        restored = self.registry.rollback()
        cand, self.candidate = self.candidate, None
        cand.drain()
        self.phase = "rolled_back"
        if self._instr is not None:
            self._instr.on_state(False, self.windows_passed, 0)
        self._log_event({"event": "rollback", "restored": restored,
                         "candidate": self.candidate_version})

    def _promote(self) -> None:
        """Confirmed candidate: it takes all traffic (the registry CURRENT
        already points at it since `start_rollout`)."""
        # Drain both arms before the swap so leftover shadow requests are
        # discarded by the candidate hook and the primary slice's
        # in-flight requests answer under the old policy they selected.
        self.candidate.drain()
        old = self.primary
        old.drain()
        self.primary, self.candidate = self.candidate, None
        self.primary.on_response = self._on_primary_response
        self.phase = "promoted"
        if self._instr is not None:
            self._instr.on_state(False, self.windows_passed,
                                 self.primary.telemetry.responses)
        self._log_event({"event": "promote",
                         "candidate": self.candidate_version,
                         "baseline": self.baseline_version})

    # -- reporting ----------------------------------------------------------
    def rollout_state(self) -> dict:
        cand = self.candidate
        return {
            "phase": self.phase,
            "active": self.phase == "canary",
            "candidate_version": self.candidate_version,
            "baseline_version": self.baseline_version,
            "current_version": self.registry.current_version(),
            "canary_frac": self.rollout_cfg.canary_frac,
            "shadow": self.rollout_cfg.shadow,
            "candidate_responses": (cand.telemetry.responses
                                    if cand is not None else 0),
            "windows_passed": self.windows_passed,
            "decision_counts": dict(self._decision_counts),
            "last_decision": (dataclasses.asdict(self.decisions[-1])
                              if self.decisions else None),
        }

    def serve_obs(self, host: str = "127.0.0.1", port: int = 0):
        """Observability surface with rollout state: `/telemetry` gains a
        ``rollout`` key and `/rollout` serves the controller state."""
        if self.obs is None:
            raise RuntimeError("server was built with obs=False")
        return self.obs.serve(host=host, port=port,
                              ready_fn=lambda: self.ready,
                              telemetry_fn=self.telemetry.snapshot,
                              rollout_fn=self.rollout_state,
                              health_fn=self.degradation_state)

    def close(self) -> None:
        if self._decision_log is not None:
            self._decision_log.close()

    def _log_event(self, rec: dict) -> None:
        if self._decision_log is None:
            return
        try:
            self._decision_log.append({"ts": _time.time(), **rec})
        except Exception:
            pass                    # fail-open, like everything in obs
