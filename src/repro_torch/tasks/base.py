"""Shared `TunableTask` implementation for linear-system solvers (port of
`repro.tasks.base`).

Everything but the batched solver lives here: paper features (Eq. 18),
size bucketing with identity padding (solution preserving) and the
Eq. 21 reward mapped from an `Outcome`'s metrics. Subclasses provide
`name`, `inner_iter_metric` and `solve_rows`.

The task owns its device: CUDA unless the caller passes `device="cpu"`.
It is resolved once, at construction, and raises when CUDA is asked for
and absent.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.features import PAPER_FEATURES, feature_vector
from repro_torch.core.rewards import reward as reward_fn
from repro_torch.core.task import Outcome, bucket_of
from repro_torch.data.matrices import LinearSystem, pad_system
from repro_torch.precision import resolve_device


class LinearSystemTask:
    """Base task over a (possibly empty) set of `LinearSystem`s.

    `device` selects where the solves run ("cuda" by default, or "cpu");
    the device picks the precision backend, and `carrier_dtype` the
    carrier: on the GPU float32 by default or "float64" (the kernels'
    float64 instantiations, the paper's x64 setting); on the CPU the
    systems' float64 by default, or the `carrier_dtype` given ("float32"
    runs the card's default carrier with the plain versions).

    `tune_blocking=True` runs a one-off startup sweep per (bucket,
    device) over blocked-LU panel widths and pins the winner into that
    bucket's solver config (`solvers.block_autotune`): the bandit's
    measure-then-commit move applied to the kernel-blocking knob. Off by
    default: panel-restricted pivoting differs by width, so the tuned
    policy is a config change a task opts into.
    """

    name = "linear-system"
    inner_iter_metric = "n_inner"

    def __init__(self, systems: Sequence[LinearSystem] = (),
                 action_space: Optional[ActionSpace] = None,
                 bucket_step: int = 128, min_bucket: int = 128,
                 device=None, tune_blocking: bool = False,
                 carrier_dtype=None):
        self.instances: List[LinearSystem] = list(systems)
        self.action_space = action_space
        self.bucket_step = bucket_step
        self.min_bucket = min_bucket
        self.device = resolve_device(device)
        self.carrier_dtype = carrier_dtype
        self.tune_blocking = tune_blocking
        self._features: Optional[np.ndarray] = None
        self._kappas: Optional[np.ndarray] = None
        self._tuned_cfgs: dict = {}

    # -- context features --------------------------------------------------
    @property
    def features(self) -> np.ndarray:
        if self._features is None:
            if not self.instances:
                return np.zeros((0, len(PAPER_FEATURES)))
            self._features = np.stack([self.feature_of(s)
                                       for s in self.instances])
        return self._features

    @property
    def kappas(self) -> np.ndarray:
        if self._kappas is None:
            self._kappas = np.array([s.features["kappa_est"]
                                     for s in self.instances])
        return self._kappas

    def feature_of(self, system: LinearSystem) -> np.ndarray:
        return feature_vector(system.features)

    # -- shape bucketing ---------------------------------------------------
    def bucket_key(self, system: LinearSystem) -> int:
        return bucket_of(system.n, self.bucket_step, self.min_bucket)

    def prepare(self, system: LinearSystem):
        """(A, b, x) identity-padded to the system's size bucket."""
        return pad_system(system, self.bucket_key(system))

    # -- solving / reward --------------------------------------------------
    def solver_cfg_for(self, cfg, n_pad: int):
        """Per-bucket solver config: `cfg`, with the blocked-LU panel
        width swapped for the startup sweep's winner when `tune_blocking`
        is on. Cached per (config type, bucket)."""
        if not self.tune_blocking:
            return cfg
        key = (type(cfg).__name__, int(n_pad))
        if key not in self._tuned_cfgs:
            from repro_torch.solvers.block_autotune import tuned_blocking
            pol = tuned_blocking(n_pad, device=self.device,
                                 base=cfg.blocking,
                                 carrier_dtype=self.carrier_dtype)
            self._tuned_cfgs[key] = (
                cfg if pol == cfg.blocking
                else dataclasses.replace(cfg, blocking=pol))
        return self._tuned_cfgs[key]

    def solve_rows(self, rows, action_rows, chunk: int) -> List[Outcome]:
        raise NotImplementedError

    def reward(self, outcome: Outcome, action_idx: int,
               instance: LinearSystem, cfg) -> float:
        """Eq. 21 on the outcome's metrics; the inner-iteration count
        named by `inner_iter_metric` feeds the Eq. 25 work penalty."""
        m = outcome.metrics
        return reward_fn(m["ferr"], m["nbe"], m[self.inner_iter_metric],
                         outcome.status,
                         self.action_space.actions[int(action_idx)],
                         instance.features["kappa_est"], cfg)
