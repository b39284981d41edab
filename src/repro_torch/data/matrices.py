"""Problem-instance generation (paper §5.1-5.3).

Dense: MATLAB gallery('randsvd', ..., mode=2) — A = U diag(sigma) V^T with
sigma_1..n-1 = sigma_max, sigma_n = sigma_max/kappa (Eq. 31), U/V from QR of
standard-normal matrices.

Sparse: A0 with nnz = floor(lambda_s n^2) standard-normal entries at random
positions, symmetrized to SPD via A = A0 A0^T + beta I (following [17] as
cited by the paper). beta is calibrated from the spectrum so the measured
condition number lands in the paper's 1e8-1e10 band.

Systems are padded to a fixed bucket size with an identity block
(block-diag(A, I), b/x zero-extended) — exactly solution-preserving
(DESIGN.md §3.5). A copy of `repro.data.matrices`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.linalg as sla

from repro_torch.core.features import system_features


@dataclasses.dataclass
class LinearSystem:
    A: np.ndarray            # (n, n) float64, unpadded
    b: np.ndarray
    x_true: np.ndarray
    kappa: float             # generator-target (dense) / measured (sparse)
    features: dict           # from core.features.system_features
    kind: str                # "dense" | "sparse"

    @property
    def n(self) -> int:
        return self.A.shape[0]


def randsvd_dense(n: int, kappa: float, rng: np.random.Generator,
                  sigma_max: float = 1.0) -> LinearSystem:
    """gallery('randsvd') mode=2: one small singular value (Eq. 31)."""
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.full(n, sigma_max)
    s[-1] = sigma_max / kappa
    A = (u * s) @ v.T
    x = rng.standard_normal(n)
    b = A @ x
    return LinearSystem(A, b, x, float(kappa), system_features(A), "dense")


def sparse_spd(n: int, lambda_s: float, rng: np.random.Generator,
               kappa_target: float) -> LinearSystem:
    """A = A0 A0^T + beta I with nnz(A0) = floor(lambda_s n^2)."""
    nnz = max(int(lambda_s * n * n), n)
    A0 = np.zeros((n, n))
    idx = rng.choice(n * n, size=nnz, replace=False)
    A0.flat[idx] = rng.standard_normal(nnz)
    # Non-zero diagonal (paper: a_ii != 0, non-singular).
    diag_fill = rng.standard_normal(n) * 0.1
    G = A0 @ A0.T
    lam_max = float(sla.eigh(G, eigvals_only=True,
                             subset_by_index=(n - 1, n - 1))[0])
    lam_max = max(lam_max, 1e-12)
    beta = lam_max / kappa_target
    A = G + beta * np.eye(n) + np.diag(np.abs(diag_fill)) * beta
    x = rng.standard_normal(n)
    b = A @ x
    feats = system_features(A)
    return LinearSystem(A, b, x, feats["kappa_est"], feats, "sparse")


def generate_dense_set(n_systems: int, rng: np.random.Generator,
                       n_range=(100, 500),
                       log10_kappa_range=(1.0, 9.0)) -> List[LinearSystem]:
    out = []
    for _ in range(n_systems):
        n = int(rng.integers(n_range[0], n_range[1] + 1))
        kappa = 10.0 ** rng.uniform(*log10_kappa_range)
        out.append(randsvd_dense(n, kappa, rng))
    return out


def generate_sparse_set(n_systems: int, rng: np.random.Generator,
                        n_range=(100, 500), lambda_s: float = 0.01,
                        log10_kappa_range=(8.0, 10.0)) -> List[LinearSystem]:
    out = []
    for _ in range(n_systems):
        n = int(rng.integers(n_range[0], n_range[1] + 1))
        kt = 10.0 ** rng.uniform(*log10_kappa_range)
        out.append(sparse_spd(n, lambda_s, rng, kt))
    return out


def pad_system(sys: LinearSystem, n_pad: int):
    """Identity-extend to n_pad (solution-preserving)."""
    n = sys.n
    assert n <= n_pad
    A = np.eye(n_pad)
    A[:n, :n] = sys.A
    b = np.zeros(n_pad)
    b[:n] = sys.b
    x = np.zeros(n_pad)
    x[:n] = sys.x_true
    return A, b, x


def pad_batch(systems: List[LinearSystem], n_pad: Optional[int] = None):
    """Stack systems into padded (B, n_pad, n_pad) / (B, n_pad) arrays."""
    if n_pad is None:
        n_pad = max(s.n for s in systems)
    A = np.zeros((len(systems), n_pad, n_pad))
    b = np.zeros((len(systems), n_pad))
    x = np.zeros((len(systems), n_pad))
    for i, s in enumerate(systems):
        A[i], b[i], x[i] = pad_system(s, n_pad)
    return A, b, x
