"""Service telemetry: throughput / latency / precision-usage / reward
(a copy of `repro.service.telemetry`).

Plain in-process counters — cheap enough to update on every request —
with a `snapshot()` that renders the whole state as one JSON-ready
dict. Latency percentiles are computed over a bounded reservoir of the
most recent samples so a long-running server never grows without
bound.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

import numpy as np


class Ewma:
    """Exponentially-weighted moving average with bias-corrected warmup."""

    def __init__(self, coeff: float):
        self.coeff = float(coeff)
        self._acc = 0.0
        self._norm = 0.0

    def update(self, x: float) -> float:
        self._acc = (1.0 - self.coeff) * self._acc + self.coeff * float(x)
        self._norm = (1.0 - self.coeff) * self._norm + self.coeff
        return self.value

    @property
    def value(self) -> float:
        return self._acc / self._norm if self._norm > 0 else 0.0


class Telemetry:
    def __init__(self, max_latency_samples: int = 4096,
                 reward_coeff: float = 0.02,
                 max_bucket_latency_samples: int = 1024):
        self.requests = 0
        self.responses = 0
        self.solver_batches = 0
        self.solver_rows = 0          # rows actually solved (incl. padding)
        self.padded_rows = 0          # wasted rows from fixed-shape padding
        self.drift_events = 0
        self.updates = 0
        self.batches_per_bucket: Dict[int, int] = {}
        self.requests_per_bucket: Dict[int, int] = {}
        self.usage: Dict[str, int] = {}           # per-step format counts
        self.action_counts: Dict[int, int] = {}
        # Outcome-status histogram (core.task codes: 0=CONVERGED,
        # 1=STAGNATED, 2=MAXITER, 3=FAILED). `converged_frac` is the
        # ferr/nbe pass-rate gate of the canary rollout controller —
        # CONVERGED means the solver met its ferr/nbe tolerance.
        self.status_counts: Dict[int, int] = {}
        self.reward_ewma = Ewma(reward_coeff)
        self.reward_sum = 0.0
        self.abs_rpe_ewma = Ewma(reward_coeff)
        self._latencies = deque(maxlen=max_latency_samples)
        # Per-bucket reservoirs: per-bucket p99 is the promotion gate the
        # canary workstream needs, and one global reservoir cannot
        # recover it (small buckets drown in big-bucket samples).
        self._bucket_latency_cap = max_bucket_latency_samples
        self._latencies_per_bucket: Dict[int, deque] = {}
        # (first_submit_t, last_response_t): the wall-clock window is
        # anchored at the FIRST SUBMIT, not the first response —
        # anchoring at the first response made single-response and
        # warmup-heavy runs report 0 or inflated rates.
        self._wall: Optional[tuple] = None

    # -- recording ---------------------------------------------------------
    def on_submit(self, bucket: int, now: Optional[float] = None) -> None:
        self.requests += 1
        self.requests_per_bucket[bucket] = \
            self.requests_per_bucket.get(bucket, 0) + 1
        if now is not None and self._wall is None:
            self._wall = (now, now)

    def on_batch(self, bucket: int, n_live: int, n_rows: int) -> None:
        self.solver_batches += 1
        self.solver_rows += n_rows
        self.padded_rows += n_rows - n_live
        self.batches_per_bucket[bucket] = \
            self.batches_per_bucket.get(bucket, 0) + 1

    def on_response(self, latency_s: float, action_names, action: int,
                    reward: float, now: float,
                    bucket: Optional[int] = None,
                    status: Optional[int] = None) -> None:
        self.responses += 1
        if status is not None:
            self.status_counts[int(status)] = \
                self.status_counts.get(int(status), 0) + 1
        self._latencies.append(float(latency_s))
        if bucket is not None:
            res = self._latencies_per_bucket.get(bucket)
            if res is None:
                res = self._latencies_per_bucket[bucket] = deque(
                    maxlen=self._bucket_latency_cap)
            res.append(float(latency_s))
        for name in action_names:
            self.usage[name] = self.usage.get(name, 0) + 1
        self.action_counts[int(action)] = \
            self.action_counts.get(int(action), 0) + 1
        # A NaN reward would poison both aggregates permanently (NaN is
        # absorbing under += and EWMA); injected-NaN outcomes still count
        # as responses above, they just don't move the reward telemetry.
        if math.isfinite(float(reward)):
            self.reward_ewma.update(reward)
            self.reward_sum += float(reward)
        if self._wall is None:
            self._wall = (now, now)
        else:
            self._wall = (self._wall[0], now)

    def on_update(self, abs_rpe: float, drift: bool) -> None:
        self.updates += 1
        self.abs_rpe_ewma.update(abs_rpe)
        if drift:
            self.drift_events += 1

    # -- reporting ---------------------------------------------------------
    def latency_percentiles(self, qs=(50, 90, 99)) -> Dict[str, float]:
        if not self._latencies:
            return {f"p{q}": 0.0 for q in qs}
        arr = np.asarray(self._latencies)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def latency_percentiles_per_bucket(self, qs=(50, 99)
                                       ) -> Dict[int, Dict[str, float]]:
        """Per-bucket percentiles over the bounded per-bucket reservoirs
        (the canary promotion gate reads p99 from here)."""
        out: Dict[int, Dict[str, float]] = {}
        for bucket, res in sorted(self._latencies_per_bucket.items()):
            arr = np.asarray(res)
            out[bucket] = {f"p{q}": float(np.percentile(arr, q))
                           for q in qs}
        return out

    @property
    def converged_frac(self) -> float:
        """Fraction of responses whose solve met its ferr/nbe tolerance
        (status CONVERGED) — the rollout controller's pass-rate gate."""
        if not self.responses:
            return 0.0
        return self.status_counts.get(0, 0) / self.responses

    @property
    def throughput_rps(self) -> float:
        """Responses per second over [first submit, last response].

        The window opens at the first *submit* (when `on_submit` is
        given a timestamp): a run that submits, waits, and receives one
        response reports 1/window — the first-response anchor used to
        make that 0, and made warmup-heavy runs look inflated because
        all queue time before the first response was dropped."""
        if self._wall is None or self._wall[1] <= self._wall[0]:
            return 0.0
        return self.responses / (self._wall[1] - self._wall[0])

    def snapshot(self) -> dict:
        total = max(self.responses, 1)
        return {
            "requests": self.requests,
            "responses": self.responses,
            "updates": self.updates,
            "drift_events": self.drift_events,
            "solver_batches": self.solver_batches,
            "solver_rows": self.solver_rows,
            "padded_rows": self.padded_rows,
            # Real work vs fixed-shape padding waste, split out explicitly
            # (mirrors AutotuneEngine.n_solves / n_pad_solves offline).
            "n_solves": self.solver_rows - self.padded_rows,
            "n_pad_solves": self.padded_rows,
            "pad_waste_frac": self.padded_rows / max(self.solver_rows, 1),
            "status_counts": {str(k): v
                              for k, v in sorted(self.status_counts
                                                 .items())},
            "converged_frac": self.converged_frac,
            "batches_per_bucket": dict(self.batches_per_bucket),
            "requests_per_bucket": dict(self.requests_per_bucket),
            "usage_per_solve": {k: v / total
                                for k, v in sorted(self.usage.items())},
            "reward_ewma": self.reward_ewma.value,
            "reward_mean": self.reward_sum / total,
            "abs_rpe_ewma": self.abs_rpe_ewma.value,
            "latency_s": self.latency_percentiles(),
            "latency_s_per_bucket": self.latency_percentiles_per_bucket(),
            "throughput_rps": self.throughput_rps,
        }
