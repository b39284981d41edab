"""Per-bucket circuit breaker: graceful degradation to the safe arm (a
copy of `repro.service.breaker`; DESIGN.md §11.2).

The learned policy can misbehave — a drifted Q-table, a poisoned solve
stream (NaN/divergence), a numerically hostile request mix. The paper's
safety story is that the *all-fp64 arm always exists*: it is the arm a
zeroed Q-row tie-breaks to (`QTable.greedy` breaks ties toward the
highest action index, pinned by tests), the arm offline training
baselines against, and the arm whose outcome a client would have gotten
from a non-autotuning solver. The breaker makes falling back to it
automatic, per size bucket:

  closed     normal serving; solve outcomes feed a sliding window.
             When ≥ `min_samples` of the last `window` outcomes are
             failures (status FAILED, or a non-finite reward/metric)
             and the failure fraction ≥ `failure_threshold`: → open.
  open       selection is pinned to the safe arm (explore coin
             suppressed); Q-updates are quarantined — no reward
             observed while not closed touches the table. Every
             `probe_interval`-th selection in the bucket is a *probe*:
             it uses the learned greedy policy; the first probe moves
             the breaker to half_open.
  half_open  probes continue at the same cadence (non-probe traffic
             stays pinned + quarantined). `probe_successes` consecutive
             healthy probe outcomes close the breaker (window cleared,
             learning resumes); one failed probe falls back to open.

The breaker is deliberately selection-side only: it never cancels an
in-flight solve, and quarantine decisions are made at completion time
against the state the breaker was in *before* that outcome is recorded,
so the probe that closes the breaker is itself still quarantined — only
post-recovery traffic trains the table.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: Gauge encoding for repro_breaker_state{bucket}.
STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    enabled: bool = True
    window: int = 16              # sliding outcome window per bucket
    min_samples: int = 8          # no trip below this many in the window
    failure_threshold: float = 0.5
    probe_interval: int = 4       # while not closed: every Nth request
                                  # probes the learned policy
    probe_successes: int = 3      # consecutive healthy probes to close


@dataclasses.dataclass
class _Bucket:
    state: str = CLOSED
    outcomes: deque = dataclasses.field(default_factory=deque)
    selections_while_open: int = 0
    probe_streak: int = 0
    opened_count: int = 0


class CircuitBreakers:
    """All per-bucket breakers of one server.

    ``on_transition(bucket, old, new)`` (optional) fires on every state
    change — the server wires it to metrics/trace.
    """

    def __init__(self, cfg: BreakerConfig = BreakerConfig(),
                 on_transition: Optional[Callable[[int, str, str],
                                                  None]] = None):
        self.cfg = cfg
        self.on_transition = on_transition
        self._buckets: Dict[int, _Bucket] = {}

    def _get(self, bucket: int) -> _Bucket:
        return self._buckets.setdefault(int(bucket), _Bucket())

    def _set_state(self, bucket: int, b: _Bucket, new: str) -> None:
        old, b.state = b.state, new
        if old != new and self.on_transition is not None:
            self.on_transition(bucket, old, new)

    # -- selection side ----------------------------------------------------
    def on_select(self, bucket: int) -> str:
        """Route for the next selection in `bucket`: ``"normal"`` |
        ``"pinned"`` (forced safe arm) | ``"probe"`` (learned policy,
        outcome judged as a probe)."""
        if not self.cfg.enabled:
            return "normal"
        b = self._get(bucket)
        if b.state == CLOSED:
            return "normal"
        b.selections_while_open += 1
        if b.selections_while_open % max(self.cfg.probe_interval, 1) == 0:
            if b.state == OPEN:
                self._set_state(bucket, b, HALF_OPEN)
            return "probe"
        return "pinned"

    # -- completion side ---------------------------------------------------
    def state(self, bucket: int) -> str:
        if not self.cfg.enabled:
            return CLOSED
        b = self._buckets.get(int(bucket))
        return b.state if b is not None else CLOSED

    def on_outcome(self, bucket: int, healthy: bool,
                   probe: bool = False) -> str:
        """Record one completed solve; returns the (possibly new)
        state. Pinned-traffic outcomes while not closed are ignored —
        they ran the safe arm, so they carry no evidence about the
        learned policy's health."""
        if not self.cfg.enabled:
            return CLOSED
        b = self._get(bucket)
        if b.state == CLOSED:
            b.outcomes.append(bool(healthy))
            while len(b.outcomes) > self.cfg.window:
                b.outcomes.popleft()
            n = len(b.outcomes)
            fails = n - sum(b.outcomes)
            if (n >= self.cfg.min_samples
                    and fails / n >= self.cfg.failure_threshold):
                b.outcomes.clear()
                b.selections_while_open = 0
                b.probe_streak = 0
                b.opened_count += 1
                self._set_state(bucket, b, OPEN)
        elif probe:
            if healthy:
                b.probe_streak += 1
                if b.probe_streak >= self.cfg.probe_successes:
                    b.outcomes.clear()
                    b.selections_while_open = 0
                    b.probe_streak = 0
                    self._set_state(bucket, b, CLOSED)
            else:
                b.probe_streak = 0
                self._set_state(bucket, b, OPEN)
        return b.state

    # -- reporting ---------------------------------------------------------
    def open_buckets(self) -> List[int]:
        return sorted(k for k, b in self._buckets.items()
                      if b.state != CLOSED)

    def describe(self) -> Dict[str, dict]:
        """Per-bucket state for /healthz: only buckets that have ever
        tracked an outcome appear."""
        out = {}
        for k in sorted(self._buckets):
            b = self._buckets[k]
            n = len(b.outcomes)
            out[str(k)] = {
                "state": b.state,
                "window": n,
                "failure_frac": ((n - sum(b.outcomes)) / n) if n else 0.0,
                "probe_streak": b.probe_streak,
                "times_opened": b.opened_count,
            }
        return out
