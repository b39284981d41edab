"""Context-space discretization (Eq. 3-4, 19-20).

Features arrive already in log10 space (log kappa, log norm), so linear bins
here realize the paper's "logarithmic bins". Bin ranges are fit on the
training set; out-of-range test features clip to the boundary bins (Eq. 19).
A copy of `repro.core.discretize`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Discretizer:
    mins: np.ndarray     # (d,)
    maxs: np.ndarray     # (d,)
    n_bins: Tuple[int, ...]

    @classmethod
    def fit(cls, features: np.ndarray,
            n_bins: Sequence[int]) -> "Discretizer":
        """features: (N, d) training feature matrix."""
        features = np.asarray(features, dtype=np.float64)
        assert features.ndim == 2 and features.shape[1] == len(n_bins)
        return cls(features.min(axis=0), features.max(axis=0),
                   tuple(int(b) for b in n_bins))

    @property
    def d(self) -> int:
        return len(self.n_bins)

    @property
    def n_states(self) -> int:
        return int(np.prod(self.n_bins))

    def bin_indices(self, s: np.ndarray) -> np.ndarray:
        """Per-feature bin index, clipped to [0, n_j - 1].

        Degenerate features (mins == maxs: a single training instance, or
        a constant feature column) get a well-defined single-bin mapping —
        every query value lands in bin 0, rather than the arbitrary bin
        that floor((v - min) / 1.0 * n) would pick for off-point queries.
        """
        s = np.atleast_2d(np.asarray(s, dtype=np.float64))
        degenerate = self.maxs <= self.mins
        width = np.where(degenerate, 1.0, self.maxs - self.mins)
        frac = (s - self.mins) / width
        nb = np.asarray(self.n_bins)
        idx = np.floor(frac * nb).astype(np.int64)
        idx = np.where(degenerate[None, :], 0, idx)
        return np.clip(idx, 0, nb - 1)

    def __call__(self, s: np.ndarray) -> np.ndarray:
        """Flat state index (Eq. 20: row-major over features)."""
        idx = self.bin_indices(s)
        flat = np.zeros(idx.shape[0], dtype=np.int64)
        for j in range(self.d):
            flat = flat * self.n_bins[j] + idx[:, j]
        return flat if np.asarray(s).ndim > 1 else flat[0]

    def bin_diameter(self) -> float:
        """Euclidean diameter of one cell (the Delta of Prop. 1)."""
        widths = (self.maxs - self.mins) / np.asarray(self.n_bins)
        return float(np.linalg.norm(widths))

    def to_dict(self) -> dict:
        return {"mins": self.mins.tolist(), "maxs": self.maxs.tolist(),
                "n_bins": list(self.n_bins)}

    @classmethod
    def from_dict(cls, d: dict) -> "Discretizer":
        return cls(np.asarray(d["mins"]), np.asarray(d["maxs"]),
                   tuple(d["n_bins"]))
