"""Evaluation metrics: Eq. 17 errors and the Eq. 28-30 success rate (a copy
of `repro.solvers.metrics`)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

# Condition ranges used throughout the paper's Section 5.
CONDITION_RANGES = {
    "low": (1e0, 1e3),
    "medium": (1e3, 1e6),
    "high": (1e6, 1e9),
}


def eps_max(ferr: np.ndarray, nbe: np.ndarray) -> np.ndarray:
    """eps_max(P, a) = max(ferr, nbe)."""
    return np.maximum(ferr, nbe)


def success_rate(ferr: np.ndarray, nbe: np.ndarray, kappa: np.ndarray,
                 tau_base: float) -> float:
    """Eq. 28-30: threshold tau_j = tau_base * median(kappa in range);
    success iff eps_max < tau_j. Computed over the provided (range-filtered)
    sample set."""
    if len(ferr) == 0:
        return float("nan")
    tau_j = tau_base * float(np.median(kappa))
    return float(np.mean(eps_max(ferr, nbe) < tau_j))


def bucket_by_condition(kappa: np.ndarray,
                        ranges=CONDITION_RANGES) -> dict:
    """Index sets per condition range."""
    out = {}
    for name, (lo, hi) in ranges.items():
        out[name] = np.where((kappa >= lo) & (kappa < hi))[0]
    return out


def summarize(ferr, nbe, n_outer, n_gmres, kappa, tau_base,
              ranges=CONDITION_RANGES) -> dict:
    """Per-condition-range summary matching the paper's table columns."""
    rows = {}
    for name, idx in bucket_by_condition(np.asarray(kappa), ranges).items():
        if len(idx) == 0:
            continue
        rows[name] = {
            "n": int(len(idx)),
            "xi": success_rate(np.asarray(ferr)[idx], np.asarray(nbe)[idx],
                               np.asarray(kappa)[idx], tau_base),
            "avg_ferr": float(np.mean(np.asarray(ferr)[idx])),
            "avg_nbe": float(np.mean(np.asarray(nbe)[idx])),
            "avg_iter": float(np.mean(np.asarray(n_outer)[idx])),
            "avg_gmres_iter": float(np.mean(np.asarray(n_gmres)[idx])),
        }
    return rows
