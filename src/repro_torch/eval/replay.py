"""Deterministic trajectory replay: logged service decisions become
regression fixtures (port of `repro.eval.replay`).

Every record in the JSONL trajectory log names an action and the
outcome/reward it produced. Because the whole serving stack is
deterministic — bit-exact kernels and plain versions (DESIGN.md §6),
each row of a flush solved on its own — re-applying the logged action
to the same instance on the same device and carrier must reproduce the
logged outcome *bit-identically*, regardless of how requests were
micro-batched the first time. `replay_records` asserts exactly that: it
re-feeds logged (instance, action) pairs through `AutotuneEngine`'s
ad-hoc solve cache (`solve_adhoc`, batched per bucket), recomputes the
reward through the task's reward hook, and diffs every compared field
against the log.

What replay needs that the log does not carry is the instance itself
(the trajectory log records features, not matrices); callers supply an
``instance_of`` mapping from ``request_id`` to instance — trivially
available wherever the request stream is reproducible (a seeded test
stream, a saved request corpus, a capture buffer).

A clean `ReplayReport` is the determinism proof the OPE layer leans
on: if replay reproduces logged rewards bit-for-bit, the logged stream
is a faithful sample of the live reward function, not an artifact of
batching.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Mapping

import numpy as np

from repro_torch.core.engine import AutotuneEngine


@dataclasses.dataclass
class ReplayMismatch:
    request_id: int
    field: str
    logged: object
    replayed: object

    def __str__(self) -> str:
        return (f"request {self.request_id}: {self.field} logged="
                f"{self.logged!r} replayed={self.replayed!r}")


@dataclasses.dataclass
class ReplayReport:
    n_records: int               # records offered
    n_replayed: int              # records with an instance, re-solved
    n_skipped: int               # no instance mapping / malformed
    mismatches: List[ReplayMismatch]

    @property
    def ok(self) -> bool:
        return self.n_replayed > 0 and not self.mismatches

    def summary(self) -> str:
        head = (f"replayed {self.n_replayed}/{self.n_records} records "
                f"({self.n_skipped} skipped): ")
        if not self.mismatches:
            return head + "bit-identical"
        lines = [str(m) for m in self.mismatches[:10]]
        if len(self.mismatches) > 10:
            lines.append(f"... and {len(self.mismatches) - 10} more")
        return head + f"{len(self.mismatches)} mismatches\n  " \
            + "\n  ".join(lines)


def _bit_equal(a, b) -> bool:
    """Float equality with non-finite values compared by class (the
    JSON round-trip preserves finite floats exactly; NaN == NaN here)."""
    fa, fb = float(a), float(b)
    if math.isnan(fa) or math.isnan(fb):
        return math.isnan(fa) and math.isnan(fb)
    return fa == fb


def replay_records(engine: AutotuneEngine,
                   records: Iterable[dict],
                   instance_of,
                   reward_cfg=None,
                   check_metrics: bool = True) -> ReplayReport:
    """Re-solve every logged record and diff against the log.

    Parameters
    ----------
    engine : AutotuneEngine
        Hosts the task to replay through. Its action space must be the
        one the log was produced under (action indices are compared by
        position).
    records : iterable of trajectory-log dicts
        E.g. ``TrajectoryLog.read(path, task=...)``.
    instance_of : mapping or callable
        ``request_id -> instance``; records without an instance are
        skipped (counted in ``n_skipped``).
    reward_cfg : optional
        Reward config override; defaults to the engine's.
    check_metrics : bool
        Also compare every scalar in the logged ``outcome`` dict
        (ferr, nbe, iteration counts, ...) bit-identically.
    """
    if isinstance(instance_of, Mapping):
        lookup: Callable[[int], object] = instance_of.get
    else:
        lookup = instance_of
    todo: List[tuple] = []        # (record, instance)
    n_records = n_skipped = 0
    for rec in records:
        n_records += 1
        try:
            rid = int(rec["request_id"])
            inst = lookup(rid)
        except (KeyError, TypeError, ValueError):
            inst = None
        if inst is None:
            n_skipped += 1
            continue
        todo.append((rec, inst))
    # One pass per bucket through the ad-hoc solve cache, in the
    # engine's chunks, as serving solves them.
    outs = engine.solve_adhoc([(inst, int(rec["action"]))
                               for rec, inst in todo])
    mismatches: List[ReplayMismatch] = []

    def diff(rid: int, field: str, logged, replayed) -> None:
        if not _bit_equal(logged, replayed):
            mismatches.append(ReplayMismatch(rid, field, logged, replayed))

    for (rec, inst), out in zip(todo, outs):
        rid = int(rec["request_id"])
        feats = np.asarray(engine.task.feature_of(inst), dtype=np.float64)
        logged_feats = np.asarray(rec.get("features", ()),
                                  dtype=np.float64)
        if logged_feats.shape != feats.shape or not all(
                _bit_equal(x, y) for x, y in zip(logged_feats, feats)):
            mismatches.append(ReplayMismatch(
                rid, "features", rec.get("features"), feats.tolist()))
        logged_out = rec.get("outcome", {})
        diff(rid, "status", logged_out.get("status"), int(out.status))
        r = engine.reward_for(out, int(rec["action"]), inst,
                              cfg=reward_cfg)
        diff(rid, "reward", rec.get("reward"), float(r))
        if check_metrics:
            for key, logged_v in logged_out.items():
                if key == "status":
                    continue
                # `cost` is an Outcome field, everything else a metrics
                # entry; attribute access covers both.
                have = getattr(out, key, None)
                if have is None:
                    mismatches.append(ReplayMismatch(
                        rid, f"outcome.{key}", logged_v, None))
                else:
                    diff(rid, f"outcome.{key}", logged_v, have)
    return ReplayReport(n_records=n_records, n_replayed=len(todo),
                        n_skipped=n_skipped, mismatches=mismatches)


def assert_replay_ok(report: ReplayReport,
                     min_replayed: int = 1) -> ReplayReport:
    """Raise with the full diff when replay is not bit-identical —
    the one-liner that turns a trajectory segment into a regression
    fixture: ``assert_replay_ok(replay_records(engine, recs, insts))``."""
    if report.n_replayed < min_replayed:
        raise AssertionError(
            f"replay covered {report.n_replayed} records "
            f"(< {min_replayed}); nothing was verified")
    if report.mismatches:
        raise AssertionError(report.summary())
    return report
