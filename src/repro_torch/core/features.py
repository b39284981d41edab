"""Context features for problem instances (paper §4.2 / Eq. 18).

The paper's state is s = [log10(max(kappa(A), d_c)), log10(max(||A||_inf,
d_n))], with kappa obtained "via an efficient algorithm (e.g. Hager-Higham)".
We implement the Hager–Higham 1-norm condition estimator honestly: a few
LU-backed solves with A and A^T, never an SVD. Extra features (sparsity,
diagonal dominance) are provided for the feature-saliency studies the paper
proposes (§6) and for the LM-integration context.

These run at data-ingest time on the host (numpy/scipy), matching the
paper's "cheap features before solving" deployment model. A copy of
`repro.core.features`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.linalg as sla

DELTA_C = 1.0   # paper's delta_c (floor inside the log for kappa)
DELTA_N = 1e-30  # paper's delta_n (floor inside the log for the norm)


def condest_hager(A: np.ndarray, lu_piv=None, maxiter: int = 5) -> float:
    """Hager–Higham estimate of ||A^{-1}||_1 * ||A||_1 (1-norm condition).

    Uses LU solves only — O(n^2) per iteration after one O(n^3)
    factorization, the classical condest cost model.
    """
    n = A.shape[0]
    if lu_piv is None:
        lu_piv = sla.lu_factor(A)
    solve = lambda v: sla.lu_solve(lu_piv, v, trans=0)
    solve_t = lambda v: sla.lu_solve(lu_piv, v, trans=1)

    x = np.full(n, 1.0 / n)
    est = 0.0
    for _ in range(maxiter):
        y = solve(x)
        est_new = np.sum(np.abs(y))
        xi = np.sign(y)
        xi[xi == 0] = 1.0
        z = solve_t(xi)
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= z @ x and est_new >= est:
            est = max(est, est_new)
            break
        est = max(est, est_new)
        x = np.zeros(n)
        x[j] = 1.0
    norm1 = np.max(np.sum(np.abs(A), axis=0))
    return float(est * norm1)


def inf_norm(A: np.ndarray) -> float:
    return float(np.max(np.sum(np.abs(A), axis=1)))


def sparsity(A: np.ndarray, tol: float = 0.0) -> float:
    """Fraction of (near-)zero entries."""
    return float(np.mean(np.abs(A) <= tol))


def diag_dominance(A: np.ndarray) -> float:
    """min_i |a_ii| / sum_{j != i} |a_ij| (clipped to [0, 10])."""
    d = np.abs(np.diag(A))
    off = np.sum(np.abs(A), axis=1) - d
    ratio = d / np.where(off == 0, 1.0, off)
    return float(np.clip(np.min(ratio), 0.0, 10.0))


def system_features(A: np.ndarray, lu_piv=None) -> Dict[str, float]:
    """All features for one system. The two paper features come first."""
    kappa = condest_hager(A, lu_piv)
    return {
        "log_kappa": float(np.log10(max(kappa, DELTA_C))),
        "log_norm": float(np.log10(max(inf_norm(A), DELTA_N))),
        "kappa_est": kappa,
        "norm_inf": inf_norm(A),
        "sparsity": sparsity(A),
        "diag_dominance": diag_dominance(A),
    }


PAPER_FEATURES = ("log_kappa", "log_norm")


def feature_vector(feats: Dict[str, float],
                   names=PAPER_FEATURES) -> np.ndarray:
    return np.array([feats[n] for n in names], dtype=np.float64)
