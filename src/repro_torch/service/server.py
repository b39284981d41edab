"""Streaming autotuning server — one server, any `TunableTask` (port of
`repro.service.server`).

Lifecycle of one request (all single-threaded, pump-driven):

  submit(instance) ── context features via the task's `feature_of` →
      epsilon-greedy action from the *live* policy through the shared
      `AutotuneEngine` (greedy side goes through PrecisionPolicy's
      nearest-visited-bin fallback) → enqueued in the per-bucket
      micro-batcher, which delegates all shape/solve semantics to the
      task.

  step() ── flushes due buckets (full batch or deadline), and for every
      solved row: task reward from the observed `Outcome` → online
      Q-update (continual epsilon + drift detection, service.online) →
      telemetry → an Outcome-carrying response retrievable via poll().

The server contains no algorithm-specific code: GMRES-IR, CG-IR, or any
user task is hosted identically (legacy solver configs are adapted via
`core.task.coerce_task`). The live Q-table starts as a copy of the
promoted registry snapshot, so the snapshot stays immutable;
`snapshot()` publishes the live state back as a new version (and
promotes it) — crash recovery is just "reload CURRENT".

Every lifecycle event is mirrored into the fail-open observability
layer (`repro.obs`, DESIGN.md §8) through `ServiceInstruments`:
metrics, per-request trace spans, and the JSONL trajectory log. A
fault anywhere in that layer is swallowed and counted, never surfaced
to a caller of `submit()`/`step()`; `serve_obs()` opens the HTTP
front door (`/metrics`, `/healthz`, `/readyz`).

AOT warmup (DESIGN.md §12, `core.aot`): `warmup="sync"` runs each
expected bucket's warm batches (`tasks.base.precompile_bucket`) before
the constructor returns, `warmup="background"` on a daemon thread paced
by `warmup_pace`, in trajectory-traffic order; `compile_cache_dir` (or
``REPRO_COMPILE_CACHE_DIR``) is the kernel library's build directory, so
a restart over it runs no nvcc. A bucket is warm once it has flushed a
live batch or been warmed; with a warmup grid, `/readyz` holds at 503
until the whole grid is warm, and a server that reports ready launches
no cold kernel instance for its first request in a warmed bucket.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import faults
from repro_torch.core import aot
from repro_torch.core.bandit import QTable
from repro_torch.core.engine import AutotuneEngine
from repro_torch.core.executor import resolve_executor
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.rewards import RewardConfig
from repro_torch.core.task import FAILED, Outcome, coerce_task
from repro_torch.obs import Observability
from repro_torch.service.batcher import BatcherConfig, MicroBatcher
from repro_torch.service.breaker import (CLOSED, BreakerConfig,
                                         CircuitBreakers)
from repro_torch.service.instrument import ServiceInstruments
from repro_torch.service.online import OnlineConfig, OnlineLearner
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.telemetry import Telemetry


@dataclasses.dataclass
class SolveResponse:
    request_id: int
    action: int                      # index into the action space
    action_names: Tuple[str, ...]    # per-step format names
    record: Outcome
    reward: float
    state: int
    eps: float                       # epsilon in force when selected
    policy_version: str
    bucket: int
    latency_s: float
    drift: bool                      # this update triggered re-exploration
    # Fault-tolerance surface (DESIGN.md §11). `seq` is the WAL
    # sequence number stamped into the trajectory log; recovery replays
    # records with seq > the last snapshot's. `quarantined` marks a
    # reward that did NOT train the Q-table (breaker open, non-finite
    # reward, or deadline expiry).
    seq: int = 0
    quarantined: bool = False
    pinned: bool = False             # selection forced to the safe arm
    probe: bool = False              # half-open probe of the learned policy
    expired: bool = False            # request deadline hit before solve


@dataclasses.dataclass
class _InFlight:
    instance: object
    state: int
    action: int
    eps: float
    explore: bool               # epsilon coin fired (random action)
    submitted_at: float
    bucket: int
    features: object = None     # context vector (trajectory log)
    t_accept: float = 0.0       # submit() entry (trace: selection span)
    pinned: bool = False        # breaker forced the safe arm
    probe: bool = False         # breaker probe (learned policy on trial)


def _live_qtable(snapshot: QTable, alpha, seed: int) -> QTable:
    qt = QTable(snapshot.n_states, snapshot.n_actions, alpha, seed)
    qt.Q = snapshot.Q.copy()
    qt.N = snapshot.N.copy()
    return qt


class AutotuneServer:
    def __init__(self,
                 registry: Union[PolicyRegistry, PrecisionPolicy],
                 task=None,
                 reward_cfg: RewardConfig = RewardConfig(),
                 batcher_cfg: BatcherConfig = BatcherConfig(),
                 online_cfg: OnlineConfig = OnlineConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0,
                 max_retained_responses: int = 65536,
                 executor=None,
                 obs: Union[None, bool, Observability] = None,
                 auto_step: bool = True,
                 breaker_cfg: BreakerConfig = BreakerConfig(),
                 warmup: Optional[str] = None,
                 warmup_buckets: Optional[List[int]] = None,
                 compile_cache_dir: Optional[str] = None,
                 warmup_pace: Optional[Callable] = None):
        if isinstance(registry, PolicyRegistry):
            self.registry: Optional[PolicyRegistry] = registry
            snapshot = registry.load()
            self.policy_version = registry.current_version() or "unversioned"
        else:
            self.registry = None
            snapshot = registry
            self.policy_version = "unversioned"
        # Accept a TunableTask or a solver config (adapted, using this
        # server's batcher bucket settings). An explicit `executor` (a
        # `core.executor` spec — "local" or an instance) overrides the
        # task's; the micro-batcher sizes its flushes to its
        # granularity (DESIGN.md §7).
        self.task = coerce_task(task, bucket_step=batcher_cfg.bucket_step,
                                min_bucket=batcher_cfg.min_bucket)
        if executor is not None:
            self.task.executor = resolve_executor(executor)
        self.executor = resolve_executor(
            getattr(self.task, "executor", None))
        task_space = getattr(self.task, "action_space", None)
        if task_space is None:
            self.task.action_space = snapshot.action_space
        elif not np.array_equal(task_space.actions,
                                snapshot.action_space.actions):
            # The batcher executes snapshot-space actions; rewarding them
            # through a different task space would silently score actions
            # that were never run.
            raise ValueError(
                "task.action_space does not match the policy snapshot's "
                "action space; build the task with the snapshot's space "
                "(or leave it None to inherit it)")
        self.action_space = snapshot.action_space
        self.discretizer = snapshot.discretizer
        self.live = PrecisionPolicy(
            snapshot.action_space, snapshot.discretizer,
            _live_qtable(snapshot.qtable, online_cfg.alpha, seed))
        # Observability is on by default (fail-open, DESIGN.md §8):
        # None/True joins the port's process-default metrics registry;
        # an explicit `Observability` isolates/extends (trajectory log,
        # private registry); False disables the whole layer.
        if obs is False:
            self.obs: Optional[Observability] = None
        elif obs is None or obs is True:
            self.obs = Observability()
        else:
            self.obs = obs
        self.engine = AutotuneEngine(self.task, reward_cfg,
                                     policy=self.live, seed=seed)
        self.learner = OnlineLearner(self.engine, online_cfg,
                                     obs=self.obs)
        self.reward_cfg = reward_cfg
        # Clock-skew fault site: with a `clock:clock_skew` spec active
        # the wrapped clock accumulates injected offsets (deadline and
        # drain logic must survive time jumping forward).
        self.clock = faults.wrap_clock(clock)
        self.batcher = MicroBatcher(self.task, batcher_cfg, self.clock)
        self.telemetry = Telemetry()
        # Graceful degradation (DESIGN.md §11.2): per-bucket circuit
        # breakers pin selection to the safe all-fp64 arm and quarantine
        # Q-updates when a bucket's failure/divergence rate trips.
        self.breakers = CircuitBreakers(
            breaker_cfg, on_transition=self._on_breaker_transition)
        self.safe_action = self.live.safe_action
        # Write-ahead sequencing for crash recovery (service.recovery):
        # every completed request gets the next seq, stamped into its
        # trajectory-log record; snapshot() embeds the seq it covers.
        self.update_seq = 0
        self.quarantined_updates = 0
        self.expired_requests = 0
        self.last_recovery: Optional[dict] = None   # set by recover_server
        self._instr = (ServiceInstruments(
            self.obs, getattr(self.task, "name", "unknown"),
            self.executor.name) if self.obs is not None else None)
        self._inflight: Dict[int, _InFlight] = {}
        # Bounded LRU retention for poll(): poll() evicts on retrieval,
        # and the oldest *unclaimed* responses are evicted past the cap
        # (counted in repro_server_responses_evicted_total), so consumers
        # that never poll don't leak memory over a long-running server's
        # lifetime.
        self._responses: "OrderedDict[int, SolveResponse]" = OrderedDict()
        self._max_retained = max_retained_responses
        self.responses_evicted = 0
        # When False, submit() only enqueues — an external pump (the HTTP
        # front door's background flush loop) drives step() instead of
        # every caller.
        self.auto_step = auto_step
        # Optional subscriber, called with each SolveResponse in completion
        # order (the order Q-updates were applied) — push-style consumers.
        self.on_response: Optional[Callable[[SolveResponse], None]] = None
        # Cold-start controls (DESIGN.md §12): the persistent build
        # directory (no-op when neither the kwarg nor
        # REPRO_COMPILE_CACHE_DIR is set) + optional AOT warmup of the
        # bucket grid. `warm_buckets` feeds the readiness gate: a bucket
        # is warm once it has flushed a live batch or been warmed; with a
        # grid configured, /readyz holds at 503 until all of it is warm.
        aot.enable_persistent_cache(compile_cache_dir)
        self.warm_buckets: set = set()
        self.warm_order: List[int] = []
        self.warmup = None
        self._warmup_mode = warmup
        self._warmup_expected: frozenset = frozenset()
        if warmup is not None:
            if warmup not in ("sync", "background"):
                raise ValueError("warmup must be None, 'sync' or "
                                 f"'background', got {warmup!r}")
            trajlog = getattr(self.obs, "trajlog", None)
            entries = aot.plan(
                [self.task], self._warmup_bucket_list(warmup_buckets),
                batcher_cfg.max_batch,
                trajectory_path=getattr(trajlog, "path", None))
            self._warmup_expected = frozenset(e.bucket for e in entries)
            if warmup == "sync":
                self.warmup = aot.precompile(entries,
                                             on_entry=self._on_warm)
            else:
                self.warmup = aot.BackgroundWarmup(
                    entries, on_entry=self._on_warm,
                    pace=warmup_pace).start()

    # -- request path ------------------------------------------------------
    def select_action(self, features) -> Tuple[int, int, float, bool]:
        """(state, action, eps, explore): epsilon-greedy, live policy."""
        eps = self.learner.epsilon.value
        state, action, explore = self.engine.select_for_features(features,
                                                                 eps)
        return state, action, eps, explore

    def submit(self, instance, req_id: Optional[int] = None) -> int:
        t_accept = self.clock()
        feats = self.task.feature_of(instance)
        state, action, eps, explore = self.select_action(feats)
        # Breaker routing (DESIGN.md §11.2): while a bucket's breaker is
        # not closed, non-probe selections are pinned to the safe
        # all-fp64 arm; probes keep the learned choice so recovery has
        # evidence to close on. The epsilon-greedy draw above always
        # happens, so the selection RNG stream is identical whether or
        # not the breaker interferes.
        route = self.breakers.on_select(self.task.bucket_key(instance))
        if route == "pinned":
            action, explore = self.safe_action, False
        req_id, bucket = self.batcher.submit(
            instance, self.action_space.actions[action], req_id=req_id)
        now = self.clock()
        self._inflight[req_id] = _InFlight(instance, state, action, eps,
                                           explore, now, bucket,
                                           features=feats,
                                           t_accept=t_accept,
                                           pinned=(route == "pinned"),
                                           probe=(route == "probe"))
        self.telemetry.on_submit(bucket, now)
        if self._instr is not None:
            self._instr.on_submit(bucket, action, explore, self.pending)
        if self.auto_step:
            self.step()      # flush any bucket this submit filled
        return req_id

    def step(self, force: bool = False) -> List[SolveResponse]:
        """Pump due micro-batches through solve -> reward -> Q-update."""
        done: List[SolveResponse] = []
        for entry in self.batcher.expire_overdue():
            done.append(self._complete_expired(entry))
        for flush in self.batcher.pump(force=force):
            self.telemetry.on_batch(flush.bucket, len(flush.req_ids),
                                    flush.n_rows)
            if self._instr is not None:
                self._instr.on_flush(flush, self.pending)
            for req_id, rec in zip(flush.req_ids, flush.records):
                done.append(self._complete(req_id, rec, flush))
        return done

    def drain(self) -> List[SolveResponse]:
        """Force-flush everything still queued."""
        return self.step(force=True)

    def poll(self, req_id: int) -> Optional[SolveResponse]:
        """Response for `req_id` if finished (removes it), else None."""
        return self._responses.pop(req_id, None)

    @property
    def pending(self) -> int:
        return self.batcher.pending

    # -- learn path --------------------------------------------------------
    @staticmethod
    def _healthy(rec: Outcome, r: float) -> bool:
        """Breaker-window health of one solve: FAILED status or any
        non-finite reward/cost/metric counts as a failure."""
        if int(rec.status) == FAILED or not math.isfinite(r):
            return False
        try:
            vals = [float(rec.cost)] + [float(v)
                                        for v in rec.metrics.values()]
        except (TypeError, ValueError):
            return False
        return all(math.isfinite(v) for v in vals)

    def _on_breaker_transition(self, bucket: int, old: str,
                               new: str) -> None:
        if self._instr is not None:
            self._instr.on_breaker_transition(bucket, old, new)

    def _complete(self, req_id: int, rec: Outcome,
                  flush=None) -> SolveResponse:
        info = self._inflight.pop(req_id)
        r = self.engine.reward_for(rec, info.action, info.instance)
        t_reward = self.clock()
        healthy = self._healthy(rec, r)
        # Quarantine is decided against the breaker state *before* this
        # outcome is recorded (DESIGN.md §11.2): the probe that closes
        # the breaker is itself still quarantined, and only traffic
        # selected after recovery trains the table. Pinned outcomes ran
        # the safe arm — no evidence about the learned policy — so they
        # never feed the breaker window.
        state_before = self.breakers.state(info.bucket)
        if not info.pinned:
            self.breakers.on_outcome(info.bucket, healthy,
                                     probe=info.probe)
        quarantined = (state_before != CLOSED or info.pinned
                       or not math.isfinite(r))
        if quarantined:
            self.quarantined_updates += 1
            rpe, drift = 0.0, False
            if self._instr is not None:
                self._instr.on_quarantine(info.bucket)
        else:
            upd = self.learner.update(info.state, info.action, r,
                                      explore=info.explore)
            rpe, drift = upd.rpe, upd.drift
            self.telemetry.on_update(abs(rpe), drift)
        self.update_seq += 1
        now = self.clock()
        resp = SolveResponse(
            request_id=req_id, action=info.action,
            action_names=self.action_space.names(info.action),
            record=rec, reward=r, state=info.state, eps=info.eps,
            policy_version=self.policy_version, bucket=info.bucket,
            latency_s=now - info.submitted_at, drift=drift,
            seq=self.update_seq, quarantined=quarantined,
            pinned=info.pinned, probe=info.probe)
        self.telemetry.on_response(resp.latency_s, resp.action_names,
                                   resp.action, r, now,
                                   bucket=info.bucket,
                                   status=int(rec.status))
        if self._instr is not None:
            self._instr.on_complete(resp, info, flush, self.telemetry,
                                    t_reward, now)
        return self._deliver(resp)

    def _complete_expired(self, entry) -> SolveResponse:
        """Terminal FAILED response for a request whose batcher deadline
        expired before it was solved. No Q-update (quarantined), no
        breaker evidence — the solve never ran."""
        info = self._inflight.pop(entry.req_id)
        self.expired_requests += 1
        self.update_seq += 1
        rec = Outcome(status=FAILED, cost=0.0, metrics={"expired": 1.0})
        r = float(getattr(self.reward_cfg, "fail_reward", -30.0))
        now = self.clock()
        resp = SolveResponse(
            request_id=entry.req_id, action=info.action,
            action_names=self.action_space.names(info.action),
            record=rec, reward=r, state=info.state, eps=info.eps,
            policy_version=self.policy_version, bucket=info.bucket,
            latency_s=now - info.submitted_at, drift=False,
            seq=self.update_seq, quarantined=True,
            pinned=info.pinned, probe=info.probe, expired=True)
        self.telemetry.on_response(resp.latency_s, resp.action_names,
                                   resp.action, r, now,
                                   bucket=info.bucket,
                                   status=int(rec.status))
        if self._instr is not None:
            self._instr.on_expired(info.bucket)
            self._instr.on_complete(resp, info, None, self.telemetry,
                                    now, now)
        return self._deliver(resp)

    def _deliver(self, resp: SolveResponse) -> SolveResponse:
        self._responses[resp.request_id] = resp
        while len(self._responses) > self._max_retained:
            self._responses.popitem(last=False)
            self.responses_evicted += 1
            if self._instr is not None:
                self._instr.on_evict()
        if self.on_response is not None:
            self.on_response(resp)
        return resp

    # -- AOT warmup (DESIGN.md §12) ----------------------------------------
    def _warmup_bucket_list(self, warmup_buckets) -> List[int]:
        """Bucket keys the warmup grid covers: explicit expected request
        sizes (through the task's bucketing, so callers may pass raw n's
        or bucket keys), else the buckets of the task's own instances,
        else the minimum bucket."""
        from repro_torch.core.task import bucket_of
        step = getattr(self.task, "bucket_step",
                       self.batcher.cfg.bucket_step)
        lo = getattr(self.task, "min_bucket", self.batcher.cfg.min_bucket)
        if warmup_buckets:
            return sorted({bucket_of(int(n), step, lo)
                           for n in warmup_buckets})
        instances = getattr(self.task, "instances", ())
        if instances:
            return sorted({self.task.bucket_key(s) for s in instances})
        return [int(lo)]

    def _on_warm(self, entry, warmed: bool) -> None:
        # warmed=False still flips the gate: the task has no dispatchable
        # form for the cell, or its warm batches raised (the error is in
        # the report); holding /readyz on it would never resolve, and a
        # live request on it launches its kernels, or raises.
        self.warm_buckets.add(int(entry.bucket))
        self.warm_order.append(int(entry.bucket))

    def warmup_state(self) -> Optional[dict]:
        """Per-bucket AOT warmup progress, surfaced through `/readyz` and
        `/healthz` (None when no warmup was configured)."""
        if self._warmup_mode is None:
            return None
        rep = getattr(self.warmup, "report", self.warmup)
        return {"mode": self._warmup_mode,
                "expected_buckets": sorted(self._warmup_expected),
                "warmed_buckets": sorted(self.warm_buckets),
                "pending_buckets": sorted(self._warmup_expected
                                          - self.warm_buckets),
                "done": bool(rep.done),
                "elapsed_s": round(float(rep.seconds), 3),
                "errors": list(rep.errors),
                "compile_cache": aot.cache_stats()}

    # -- observability front door ------------------------------------------
    @property
    def ready(self) -> bool:
        """Readiness (the `/readyz` gate): a policy snapshot is loaded and
        the bucket grid is warm. A bucket is warm once it has flushed at
        least one live micro-batch or been AOT-warmed (DESIGN.md §12).
        With a warmup grid configured the whole expected grid must be
        warm (the background sweep flips it per bucket); without one, at
        least one batch has run and no traffic-seen bucket is cold."""
        if self.live is None:
            return False
        warmed = set(self.telemetry.batches_per_bucket) | self.warm_buckets
        seen = set(self.telemetry.requests_per_bucket)
        if self._warmup_expected:
            return self._warmup_expected <= warmed and seen <= warmed
        return bool(warmed) and seen <= warmed

    def degradation_state(self) -> dict:
        """Fault-tolerance surface for `/healthz` + `/readyz`
        (DESIGN.md §11): open breakers per bucket, the quarantine/expiry
        counters, and what the last crash recovery replayed."""
        open_buckets = self.breakers.open_buckets()
        out = {
            "degraded": bool(open_buckets),
            "breakers": self.breakers.describe(),
            "open_buckets": open_buckets,
            "quarantined_updates": self.quarantined_updates,
            "expired_requests": self.expired_requests,
            "update_seq": self.update_seq,
        }
        if self.last_recovery is not None:
            out["last_recovery"] = dict(self.last_recovery)
        warmup = self.warmup_state()
        if warmup is not None:
            out["warmup"] = warmup
        return out

    def serve_obs(self, host: str = "127.0.0.1", port: int = 0):
        """Open the HTTP observability surface (`/metrics`, `/healthz`,
        `/readyz`, `/telemetry`, `/trace`); returns the `ObsHTTPServer`
        (read `.url`). The first externally visible face of the server."""
        if self.obs is None:
            raise RuntimeError("server was built with obs=False")
        return self.obs.serve(host=host, port=port,
                              ready_fn=lambda: self.ready,
                              telemetry_fn=self.telemetry.snapshot,
                              health_fn=self.degradation_state)

    # -- snapshotting ------------------------------------------------------
    def snapshot(self, note: str = "online snapshot") -> str:
        """Publish + promote the live policy as a new registry version.

        The version's meta embeds the current telemetry evidence
        (reward/|RPE| EWMAs, per-bucket p99, drift count) so every
        promoted policy carries the numbers it was promoted on — the
        gating inputs of the canary-promotion workstream."""
        if self.registry is None:
            raise RuntimeError("server was built without a registry")
        tel = self.telemetry
        version = self.registry.publish(
            self.live, note=note,
            extra_meta={"task": getattr(self.task, "name", "unknown"),
                        "online_updates": tel.updates,
                        "drift_events": tel.drift_events,
                        # Crash-recovery watermark (service.recovery):
                        # this snapshot covers every trajectory-log
                        # record with seq <= wal.seq; replay resumes
                        # after it, with epsilon restored.
                        "wal": {
                            "seq": self.update_seq,
                            "eps_level": self.learner.epsilon._level,
                            "eps_t": self.learner.epsilon._t,
                        },
                        "telemetry": {
                            "responses": tel.responses,
                            "reward_ewma": tel.reward_ewma.value,
                            "abs_rpe_ewma": tel.abs_rpe_ewma.value,
                            "converged_frac": tel.converged_frac,
                            "status_counts": {
                                str(k): v for k, v
                                in sorted(tel.status_counts.items())},
                            "drift_events": tel.drift_events,
                            "throughput_rps": tel.throughput_rps,
                            "latency_s": tel.latency_percentiles(),
                            "latency_s_per_bucket":
                                tel.latency_percentiles_per_bucket(),
                        }})
        self.registry.promote(version)
        self.policy_version = version
        if self._instr is not None:
            self._instr.on_snapshot(version)
        return version
