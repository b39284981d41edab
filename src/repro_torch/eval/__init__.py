"""Off-policy evaluation + deterministic trajectory replay (DESIGN.md §10;
port of `repro.eval`).

The service tier logs one JSONL record per served decision
(`obs.trajlog`): context features, discretized state, the action taken,
the epsilon in force and whether the epsilon coin fired, the observed
reward, and the policy version. This package turns that log into the
safety rail the ROADMAP's "Beyond ε-greedy" workstream calls for:

  * `eval.ope`    — inverse-propensity-scoring and doubly-robust
    estimators that score a *candidate* policy on the logged stream
    before it ever takes a canary slice, with propensities
    reconstructed exactly from the logged (eps, explore, action)
    fields of the ε-greedy behavior policy, per-bucket stratification,
    and bootstrap confidence intervals;
  * `eval.replay` — a deterministic replay engine that re-feeds logged
    (instance, action) pairs through `AutotuneEngine` and asserts
    bit-identical outcomes against the logged rewards/statuses, so any
    production trajectory segment doubles as a regression fixture.

`service.rollout.ShadowServer` wires `ope.ope_gate` in front of
`start_rollout`: a candidate must clear a reward
lower-confidence-bound floor vs the incumbent or it is refused the
canary slice outright (counted as ``outcome="ope_reject"``).
"""
from repro_torch.eval.ope import (CallableCandidate, EmpiricalRewardModel,
                            LoggedStep, OPEConfig, OPEEstimate,
                            OPEGateReport, PolicyCandidate,
                            SnapshotCandidate, as_candidate,
                            behavior_propensity, evaluate_policy,
                            ope_gate, steps_from_records)
from repro_torch.eval.replay import (ReplayMismatch, ReplayReport,
                               assert_replay_ok, replay_records)

__all__ = [
    "CallableCandidate", "EmpiricalRewardModel", "LoggedStep",
    "OPEConfig", "OPEEstimate", "OPEGateReport", "PolicyCandidate",
    "ReplayMismatch", "ReplayReport", "SnapshotCandidate",
    "as_candidate", "assert_replay_ok", "behavior_propensity",
    "evaluate_policy", "ope_gate", "replay_records",
    "steps_from_records",
]
