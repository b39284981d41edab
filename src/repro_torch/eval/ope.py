"""Off-policy evaluation of candidate policies from logged trajectories
(a copy of `repro.eval.ope`, which is numpy only: the torch port imports
nothing of the JAX package).

Scores a candidate precision policy on the service's logged decision
stream *without* serving it: the JSONL trajectory log (`obs.trajlog`)
records, per decision, everything an importance-weighted estimator
needs — features, discretized state, the action taken, the epsilon in
force, whether the epsilon coin fired, and the observed reward.

Propensity contract (DESIGN.md §10.1). The behavior policy is the
server's ε-greedy: with probability ``eps`` the action is uniform over
the ``K`` arms, otherwise it is the live greedy arm. The logged
``explore`` flag is the realized coin, so the behavior propensity of
the logged action is reconstructed exactly from logged fields:

  * ``explore=False`` — the action *is* the greedy arm, which the
    uniform branch could also have drawn:  p = (1 - eps) + eps / K;
  * ``explore=True``  — the action came from the uniform draw:
    p = eps / K.  (A uniform draw that happens to coincide with the
    greedy arm — probability eps/K per decision — is still assigned
    the exploration branch's propensity; the resulting conservative
    over-weighting is bounded by ``weight_clip`` and surfaced in
    ``clipped_frac``.)

Estimators: inverse propensity scoring (IPS, self-normalized per
bucket stratum), the direct method (DM) over an empirical per-(state,
action) reward model with a *pessimistic* fallback for logged-support
holes, and doubly robust (DR) combining both. Confidence intervals are
stratified bootstrap percentiles. The reward-model fallback is the
worst observed reward by design: an action the log never tried must
not be scored optimistically by extrapolation — that is exactly the
candidate the canary slice (not OPE) exists to vet.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np


# ---------------------------------------------------------------------------
# Logged steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LoggedStep:
    """One behavior-policy decision, normalized from a trajectory
    record (`TrajectoryLog.FIELDS`)."""
    features: np.ndarray
    state: int
    action: int
    eps: float
    explore: bool
    reward: float
    bucket: int

    @classmethod
    def from_record(cls, rec: dict) -> "LoggedStep":
        return cls(features=np.asarray(rec["features"], dtype=np.float64),
                   state=int(rec["state"]),
                   action=int(rec["action"]),
                   eps=float(rec["eps"]),
                   explore=bool(rec["explore"]),
                   reward=float(rec["reward"]),
                   bucket=int(rec.get("bucket", 0)))


def steps_from_records(records: Iterable[dict],
                       n_actions: int) -> List[LoggedStep]:
    """Coerce raw trajectory records, dropping rows OPE cannot use:
    missing required fields, out-of-range actions, epsilon outside
    (0, 1], or a non-finite reward. Forgiving by design — the log is
    shared with decision-trail events and tolerates torn writes."""
    steps: List[LoggedStep] = []
    for rec in records:
        try:
            st = LoggedStep.from_record(rec)
        except (KeyError, TypeError, ValueError):
            continue
        if not (0 <= st.action < n_actions):
            continue
        if not (0.0 < st.eps <= 1.0) and not (st.eps == 0.0
                                              and not st.explore):
            continue
        if not np.isfinite(st.reward):
            continue
        steps.append(st)
    return steps


def behavior_propensity(eps: float, explore: bool, n_actions: int) -> float:
    """Exact behavior propensity of the logged action (module
    docstring contract)."""
    eps = float(eps)
    if explore:
        return eps / n_actions
    return (1.0 - eps) + eps / n_actions


# ---------------------------------------------------------------------------
# Candidate policies
# ---------------------------------------------------------------------------

@runtime_checkable
class PolicyCandidate(Protocol):
    """A scoreable policy: deterministic state→action map over logged
    contexts. Both registry Q-table snapshots (`SnapshotCandidate`)
    and arbitrary callables (`CallableCandidate`) satisfy it.

    Implementations may additionally expose
    ``prob_of(features, state, action) -> float`` for stochastic
    policies; absent that, the candidate is treated as deterministic
    (probability is the indicator of ``action_of``).
    """

    name: str

    def action_of(self, features: np.ndarray, state: int) -> int:
        """Action index the candidate would take in this context."""
        ...


class SnapshotCandidate:
    """A registry Q-table snapshot as a candidate: greedy actions via
    `PrecisionPolicy.predict` (nearest-visited-bin fallback included,
    so the scored policy is exactly the one the server would serve)."""

    def __init__(self, policy, name: str = "snapshot"):
        self.policy = policy
        self.name = str(name)

    @classmethod
    def from_registry(cls, registry, version: str) -> "SnapshotCandidate":
        return cls(registry.load(version), name=str(version))

    @property
    def n_actions(self) -> int:
        return int(self.policy.qtable.n_actions)

    def action_of(self, features: np.ndarray, state: int) -> int:
        a, _ = self.policy.predict(np.asarray(features))
        return int(a)


class CallableCandidate:
    """Any ``fn(features, state) -> action index`` as a candidate."""

    def __init__(self, fn: Callable[[np.ndarray, int], int],
                 name: str = "callable"):
        self._fn = fn
        self.name = str(name)

    def action_of(self, features: np.ndarray, state: int) -> int:
        return int(self._fn(features, state))


def as_candidate(obj, name: Optional[str] = None):
    """Coerce a `PolicyCandidate`, a `PrecisionPolicy`, or a bare
    callable into a candidate."""
    if isinstance(obj, (SnapshotCandidate, CallableCandidate)):
        return obj
    if callable(getattr(obj, "action_of", None)):
        return obj
    if hasattr(obj, "predict") and hasattr(obj, "qtable"):
        return SnapshotCandidate(obj, name=name or "policy")
    if callable(obj):
        return CallableCandidate(obj, name=name or "callable")
    raise TypeError(f"cannot interpret {type(obj).__name__} as a "
                    "PolicyCandidate")


def _prob_of(candidate, step: LoggedStep) -> float:
    """P(candidate takes the logged action); indicator for
    deterministic candidates."""
    prob = getattr(candidate, "prob_of", None)
    if prob is not None:
        return float(prob(step.features, step.state, step.action))
    return 1.0 if int(candidate.action_of(step.features,
                                          step.state)) == step.action \
        else 0.0


# ---------------------------------------------------------------------------
# Reward model (direct method)
# ---------------------------------------------------------------------------

class EmpiricalRewardModel:
    """Q̂(s, a): empirical mean logged reward per (state, action).

    Pairs the log never observed fall back to the *worst observed
    reward* — a deliberately pessimistic prior. DR's correction term
    only de-biases the model where the log has support; everywhere
    else the model's word is final, and scoring unexplored actions at
    the observed floor is what makes the OPE gate conservative instead
    of credulous (DESIGN.md §10.2)."""

    def __init__(self):
        self._mean: Dict[Tuple[int, int], float] = {}
        self.floor = 0.0

    def fit(self, steps: Sequence[LoggedStep]) -> "EmpiricalRewardModel":
        tot: Dict[Tuple[int, int], float] = {}
        cnt: Dict[Tuple[int, int], int] = {}
        for st in steps:
            key = (st.state, st.action)
            tot[key] = tot.get(key, 0.0) + st.reward
            cnt[key] = cnt.get(key, 0) + 1
        self._mean = {k: tot[k] / cnt[k] for k in tot}
        self.floor = min((st.reward for st in steps), default=0.0)
        return self

    def supported(self, state: int, action: int) -> bool:
        return (int(state), int(action)) in self._mean

    def predict(self, state: int, action: int) -> float:
        return self._mean.get((int(state), int(action)), self.floor)


# ---------------------------------------------------------------------------
# Estimation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OPEConfig:
    n_bootstrap: int = 200       # bootstrap resamples for the CI
    ci: float = 0.90             # two-sided CI coverage
    seed: int = 0                # bootstrap rng
    weight_clip: Optional[float] = 100.0   # IPS/DR weight cap
    self_normalized: bool = True  # Hájek IPS (per stratum)


@dataclasses.dataclass
class OPEEstimate:
    estimator: str               # "ips" | "dm" | "dr"
    value: float                 # point estimate (bucket-stratified)
    ci_lo: float                 # bootstrap percentile interval
    ci_hi: float
    n: int                       # logged decisions scored
    ess: float                   # effective sample size of the weights
    clipped_frac: float          # nonzero weights that hit weight_clip
    support: float               # frac of candidate actions with logged
    #                              support at their state (DM coverage)
    per_bucket: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"estimator": self.estimator, "value": self.value,
                "ci": [self.ci_lo, self.ci_hi], "n": self.n,
                "ess": self.ess, "clipped_frac": self.clipped_frac,
                "support": self.support, "per_bucket": self.per_bucket}


class _Scored:
    """Per-step arrays for one candidate, reused across bootstrap
    resamples (the candidate's actions and weights don't change —
    only the resampled index set does)."""

    def __init__(self, steps: Sequence[LoggedStep], candidate,
                 model: EmpiricalRewardModel, cfg: OPEConfig):
        n = len(steps)
        self.rewards = np.array([s.reward for s in steps])
        self.buckets = np.array([s.bucket for s in steps])
        self.weights = np.zeros(n)
        self.q_logged = np.zeros(n)    # Q̂(s_i, a_i)  (logged action)
        self.q_target = np.zeros(n)    # Q̂(s_i, π(s_i)) (candidate action)
        self.supported = np.zeros(n, dtype=bool)
        clipped = 0
        k = candidate_n_actions(candidate)
        for i, st in enumerate(steps):
            p = behavior_propensity(st.eps, st.explore, k)
            w = _prob_of(candidate, st) / p
            if cfg.weight_clip is not None and w > cfg.weight_clip:
                w = cfg.weight_clip
                clipped += 1
            self.weights[i] = w
            a_c = int(candidate.action_of(st.features, st.state))
            self.q_logged[i] = model.predict(st.state, st.action)
            self.q_target[i] = model.predict(st.state, a_c)
            self.supported[i] = model.supported(st.state, a_c)
        nz = int(np.count_nonzero(self.weights))
        self.clipped_frac = clipped / max(nz, 1)
        sw, sw2 = self.weights.sum(), (self.weights ** 2).sum()
        self.ess = float(sw * sw / sw2) if sw2 > 0 else 0.0
        self.support = float(self.supported.mean()) if n else 0.0


def candidate_n_actions(candidate) -> int:
    """Action-space size K for the propensity denominator. Snapshot
    candidates know it; otherwise it must be attached by the caller
    (``evaluate_policy(..., n_actions=...)`` does this)."""
    k = getattr(candidate, "n_actions", None)
    if k is None:
        raise ValueError("candidate carries no n_actions; pass "
                         "n_actions= to evaluate_policy/ope_gate")
    return int(k)


def _estimate_on(idx: np.ndarray, sc: _Scored, estimator: str,
                 cfg: OPEConfig) -> float:
    """One estimator over the (resampled) index set, stratified by
    bucket: V̂ = Σ_b (n_b / n) V̂_b. For mean-style estimators (DM,
    DR) this equals the plain mean; for self-normalized IPS the
    stratification is real — each bucket's weights renormalize among
    themselves, so a heavy bucket cannot starve a light one."""
    total, n = 0.0, len(idx)
    for b in np.unique(sc.buckets[idx]):
        sub = idx[sc.buckets[idx] == b]
        w, r = sc.weights[sub], sc.rewards[sub]
        if estimator == "ips":
            sw = w.sum()
            if cfg.self_normalized and sw > 0:
                v = float((w * r).sum() / sw)
            else:
                v = float((w * r).mean())
        elif estimator == "dm":
            v = float(sc.q_target[sub].mean())
        else:   # dr
            v = float((sc.q_target[sub]
                       + w * (r - sc.q_logged[sub])).mean())
        total += (len(sub) / n) * v
    return total


def _bootstrap_ci(sc: _Scored, estimator: str,
                  cfg: OPEConfig) -> Tuple[float, float]:
    """Stratified bootstrap percentile interval: resample within each
    bucket (counts preserved) so the strata the point estimate uses
    survive the resampling."""
    n = len(sc.rewards)
    if n == 0 or cfg.n_bootstrap <= 0:
        return float("nan"), float("nan")
    rng = np.random.default_rng(cfg.seed)
    by_bucket = [np.flatnonzero(sc.buckets == b)
                 for b in np.unique(sc.buckets)]
    vals = np.empty(cfg.n_bootstrap)
    for t in range(cfg.n_bootstrap):
        idx = np.concatenate([sub[rng.integers(0, len(sub), len(sub))]
                              for sub in by_bucket])
        vals[t] = _estimate_on(idx, sc, estimator, cfg)
    alpha = (1.0 - cfg.ci) / 2.0
    return (float(np.quantile(vals, alpha)),
            float(np.quantile(vals, 1.0 - alpha)))


def evaluate_policy(records: Iterable[dict], candidate,
                    n_actions: Optional[int] = None,
                    cfg: OPEConfig = OPEConfig(),
                    model: Optional[EmpiricalRewardModel] = None
                    ) -> Dict[str, OPEEstimate]:
    """Score `candidate` on logged records: {"ips", "dm", "dr"} →
    `OPEEstimate`. `records` may be raw trajectory dicts or
    `LoggedStep`s; `n_actions` is required unless the candidate
    carries it (snapshot candidates do)."""
    candidate = as_candidate(candidate)
    if n_actions is not None:
        k = int(n_actions)
        have = getattr(candidate, "n_actions", None)
        if have is None:
            candidate.n_actions = k
        elif int(have) != k:
            raise ValueError(f"candidate n_actions={have} != logged "
                             f"action-space size {k}")
    records = list(records)
    if records and isinstance(records[0], LoggedStep):
        steps = records
    else:
        steps = steps_from_records(records,
                                   candidate_n_actions(candidate))
    model = (model if model is not None
             else EmpiricalRewardModel().fit(steps))
    sc = _Scored(steps, candidate, model, cfg)
    out: Dict[str, OPEEstimate] = {}
    idx = np.arange(len(steps))
    for est in ("ips", "dm", "dr"):
        value = (_estimate_on(idx, sc, est, cfg)
                 if len(steps) else float("nan"))
        lo, hi = _bootstrap_ci(sc, est, cfg)
        per_bucket = {}
        for b in np.unique(sc.buckets) if len(steps) else []:
            sub = idx[sc.buckets == b]
            per_bucket[str(int(b))] = _estimate_on(sub, sc, est, cfg)
        out[est] = OPEEstimate(
            estimator=est, value=value, ci_lo=lo, ci_hi=hi,
            n=len(steps), ess=sc.ess, clipped_frac=sc.clipped_frac,
            support=sc.support, per_bucket=per_bucket)
    return out


# ---------------------------------------------------------------------------
# The rollout gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OPEGateReport:
    """Verdict + evidence of one OPE gate run (appended to the
    decision-trail JSONL and into the candidate version's meta)."""
    accept: bool
    reason: str                  # "cleared" | "lcb_below_floor" |
    #                              "insufficient_records" | "no_incumbent"
    n_records: int
    floor: Optional[float]       # incumbent DR value - margin
    margin: float
    candidate: Optional[Dict[str, OPEEstimate]]
    incumbent: Optional[Dict[str, OPEEstimate]]

    def to_event(self) -> dict:
        ev = {"accept": bool(self.accept), "reason": self.reason,
              "n_records": int(self.n_records), "floor": self.floor,
              "margin": self.margin}
        for side in ("candidate", "incumbent"):
            ests = getattr(self, side)
            if ests is not None:
                ev[side] = {k: v.to_dict() for k, v in ests.items()}
        return ev


def ope_gate(records: Sequence[dict], incumbent, candidate,
             n_actions: Optional[int] = None, *,
             margin: float = 0.5, min_records: int = 64,
             cfg: OPEConfig = OPEConfig()) -> OPEGateReport:
    """Gate a candidate on logged evidence before it takes a canary.

    Accepts iff the candidate's doubly-robust *lower confidence bound*
    clears the incumbent's DR point estimate minus `margin`. Degenerate
    inputs fail open with an explicit reason: too few logged records
    (the canary's telemetry gates are then the only rail — exactly the
    pre-OPE status quo) or no incumbent to compare against.
    """
    candidate = as_candidate(candidate, name="candidate")
    records = list(records)
    if n_actions is None:
        n_actions = candidate_n_actions(candidate)
    steps = steps_from_records(records, int(n_actions))
    if len(steps) < int(min_records):
        return OPEGateReport(True, "insufficient_records", len(steps),
                             None, margin, None, None)
    if incumbent is None:
        return OPEGateReport(True, "no_incumbent", len(steps), None,
                             margin, None, None)
    incumbent = as_candidate(incumbent, name="incumbent")
    model = EmpiricalRewardModel().fit(steps)
    cand = evaluate_policy(steps, candidate, n_actions, cfg, model=model)
    inc = evaluate_policy(steps, incumbent, n_actions, cfg, model=model)
    floor = inc["dr"].value - float(margin)
    accept = bool(cand["dr"].ci_lo >= floor)
    return OPEGateReport(accept,
                         "cleared" if accept else "lcb_below_floor",
                         len(steps), floor, float(margin), cand, inc)
