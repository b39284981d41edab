"""Multi-objective reward (paper Eq. 21-25).

  R(s, a) = w2 * f_precision + w1 * f_accuracy - w3 * f_penalty

f_precision (Eq. 22): rewards fewer significand bits, damped by log10(kappa)
— at high condition numbers the incentive to go low-precision shrinks.
f_accuracy (Eq. 24): -C1 (min(log10 max(ferr, eps), theta)
                          + min(log10 max(nbe, eps), theta)).
f_penalty (Eq. 25): log2(max(T_iter, 1)) with T_iter = total inner GMRES
iterations; `use_penalty=False` reproduces the Table 6 ablation.

Failure (LU overflow / non-finite solve) maps to a flat `fail_reward` — the
paper folds failures into the penalty; a flat floor keeps the Q-update
bounded. A copy of `repro.core.rewards`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.task import FAILED
from repro_torch.precision.formats import FORMAT_LIST, FORMATS

_T_BITS = np.array([f.t for f in FORMAT_LIST], dtype=np.float64)
_T_FP64 = float(FORMATS["fp64"].t)


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    w1: float = 1.0           # accuracy weight
    w2: float = 0.1           # precision weight
    w3: float = 1.0           # iteration-penalty weight
    C1: float = 1.0
    theta: float = 2.5
    eps: float = 1e-10
    use_penalty: bool = True
    fail_reward: float = -30.0


# The paper's two weight settings (§5.1).
W1 = RewardConfig(w1=1.0, w2=0.1)
W2 = RewardConfig(w1=1.0, w2=1.0)


def precision_term(action_fmt_ids: np.ndarray, kappa: float) -> float:
    """Eq. 22: sum over steps of t_FP64 / (t_p (1 + log10 max(kappa, 1)))."""
    t_p = _T_BITS[np.asarray(action_fmt_ids)]
    damp = 1.0 + np.log10(max(float(kappa), 1.0))
    return float(np.sum(_T_FP64 / (t_p * damp)))


def accuracy_term(ferr: float, nbe: float, cfg: RewardConfig) -> float:
    """Eq. 24 (inf-safe: log10(inf) caps at theta)."""
    def capped_log(v):
        v = max(float(v), cfg.eps)
        lg = np.log10(v) if np.isfinite(v) else np.inf
        return min(lg, cfg.theta)
    return -cfg.C1 * (capped_log(ferr) + capped_log(nbe))


def penalty_term(n_gmres_total: int) -> float:
    """Eq. 25 on total inner GMRES iterations."""
    return float(np.log2(max(int(n_gmres_total), 1)))


def reward(ferr: float, nbe: float, n_gmres: int, status: int,
           action_fmt_ids: np.ndarray, kappa: float,
           cfg: RewardConfig) -> float:
    """Eq. 21 for one (system, action) outcome.

    NaN measurements (a poisoned solve: fault injection, accelerator
    NaN-propagation) yield a NaN reward rather than raising — the
    serving path quarantines non-finite rewards away from the Q-table
    (DESIGN.md §11.2), and `int(nan)` in the penalty would otherwise
    crash the completion loop. Infs stay on the existing inf-safe path
    (capped logs). FAILED outcomes keep the flat floor.
    """
    if int(status) == FAILED:
        return cfg.fail_reward
    if any(math.isnan(float(v)) for v in (ferr, nbe, n_gmres)):
        return float("nan")
    r = (cfg.w2 * precision_term(action_fmt_ids, kappa)
         + cfg.w1 * accuracy_term(ferr, nbe, cfg))
    if cfg.use_penalty:
        r -= cfg.w3 * penalty_term(n_gmres)
    return float(r)


def reward_batch(ferr, nbe, n_gmres, status, actions_fmt_ids, kappas,
                 cfg: RewardConfig) -> np.ndarray:
    return np.array([
        reward(f, b, g, s, a, k, cfg)
        for f, b, g, s, a, k in zip(np.asarray(ferr), np.asarray(nbe),
                                    np.asarray(n_gmres), np.asarray(status),
                                    np.asarray(actions_fmt_ids),
                                    np.asarray(kappas))
    ])
