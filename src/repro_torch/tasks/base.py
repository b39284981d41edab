"""Shared `TunableTask` implementation for linear-system solvers (port of
`repro.tasks.base`).

Everything but the batched solver lives here: paper features (Eq. 18),
size bucketing with identity padding (solution preserving), batch
stacking, the Eq. 21 reward mapped from an `Outcome`'s metrics and the
AOT warm batches of a bucket (`precompile_bucket`). Subclasses provide
`name`, `inner_iter_metric`, `solve_rows` and `lowerable_for`.

The task owns its device: CUDA unless the caller passes `device="cpu"`.
It is resolved once, at construction, and raises when CUDA is asked for
and absent.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.action_space import ActionSpace
from repro_torch.core.executor import resolve_executor
from repro_torch.core.features import PAPER_FEATURES, feature_vector
from repro_torch.core.rewards import reward as reward_fn
from repro_torch.core.task import Outcome, bucket_of
from repro_torch.data.matrices import LinearSystem, pad_system
from repro_torch.precision import backend_for, resolve_device


def stack_fixed(rows: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                action_rows: Sequence[np.ndarray], chunk: int):
    """Stack padded (A, b, x) rows + action rows into arrays of `chunk`
    rows, repeating row 0 past the `k` real ones (the JAX package's
    fixed-shape batch, bit for bit). The port's live solves stack their
    rows with `chunk = k`: nothing compiles per batch shape, and a
    padding row would add work to every launch."""
    k = len(rows)
    assert 0 < k <= chunk, (k, chunk)
    idx = list(range(k)) + [0] * (chunk - k)
    A = np.stack([rows[i][0] for i in idx])
    b = np.stack([rows[i][1] for i in idx])
    x = np.stack([rows[i][2] for i in idx])
    acts = np.stack([np.asarray(action_rows[i], np.int32) for i in idx])
    return A, b, x, acts, k


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

    `executor` selects the solve executor (`core.executor`: an instance,
    ``"local"`` or None for the default); the engine and micro-batcher
    read its chunk granularity, and `solve_rows` dispatches through it.
    """

    name = "linear-system"
    inner_iter_metric = "n_inner"

    def __init__(self, systems: Sequence[LinearSystem] = (),
                 action_space: Optional[ActionSpace] = None,
                 bucket_step: int = 128, min_bucket: int = 128,
                 device=None, tune_blocking: bool = False,
                 carrier_dtype=None, executor=None):
        self.instances: List[LinearSystem] = list(systems)
        self.action_space = action_space
        self.bucket_step = bucket_step
        self.min_bucket = min_bucket
        self.device = resolve_device(device)
        self.carrier_dtype = carrier_dtype
        self.executor = resolve_executor(executor)
        self.tune_blocking = tune_blocking
        self._features: Optional[np.ndarray] = None
        self._kappas: Optional[np.ndarray] = None
        self._tuned_cfgs: dict = {}

    @property
    def backend(self):
        """The precision backend the task's solves run on (chosen by its
        device and carrier, `precision.backend_for`)."""
        return backend_for(self.device, self.carrier_dtype)

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

    # -- AOT warmup (DESIGN.md §12) ----------------------------------------
    def lowerable_for(self, n_pad: int):
        """The batched solver as a `core.executor.LowerableCall` for one
        padded size, the one `solve_rows` dispatches, or None when the
        task has none (its buckets are then warmed by live traffic)."""
        return None

    def warm_rows(self, bucket: int):
        """One prepared row for `bucket`: the identity system of the
        bucket's shapes and dtype, as the JAX package's, but with a
        right-hand side (and solution x = b) that the low formats cannot
        hold. With b = ones (the JAX package's row) every format holds b
        and the answer, so GMRES's Arnoldi process breaks down at its
        first step and CG stops after one: the kernel instances of the
        later steps would stay cold. Here the rounding errors keep the
        inner solvers going for several steps under the low formats."""
        n = int(bucket)
        b = 1.0 + np.arange(1, n + 1) / (3.0 * n)
        return (np.eye(n), b, b.copy())

    def warm_actions(self, bucket: int, chunk: int, blocked: bool
                     ) -> List[List[int]]:
        """The warm batches' action rows (indices into the action space),
        one list a batch, chosen so that together they launch every
        kernel instance that a live flush of 1 to `chunk` rows can launch
        in this bucket (`kernels.library.COLD_LAUNCHES` tells instances
        apart):

          * one row under each extreme (the first and the last action)
            and, in a blocked bucket, under one action of each route the
            GEMM takes for the factor format (`ROUTES` / `ROUTES_F64`):
            the one-format launch path of a one-row flush;
          * `chunk` rows mixing those actions (then the rest of the
            space in order), in batches of at most `chunk`: per-row ids
            in every role and one GEMM launch per route;
          * two rows under the extremes, which differ in every role: the
            per-row path at the smallest batch (chop's route follows the
            element count);
          * `chunk` rows under the first action: the one-format path of
            a flush whose rows share an action, at the largest batch.

        On an H100 each of these kinds launched instances that the
        others did not (bucket 128), and live flushes of 1-4 rows after
        them launched none cold (`chip_smoke.py` phase 13 checks it).
        """
        acts = self.action_space.actions
        last = len(acts) - 1
        reps = [0, last] if last else [0]
        if blocked:
            from repro_torch.kernels.qmatmul.ops import ROUTES, ROUTES_F64
            dt = backend_for(self.device, self.carrier_dtype).carrier_dtype
            table = ROUTES if dt == torch.float32 else ROUTES_F64
            seen = {table[int(acts[a][0])] for a in reps}
            for a in range(len(acts)):
                if table[int(acts[a][0])] not in seen:
                    seen.add(table[int(acts[a][0])])
                    reps.append(a)
        batches = [[a] for a in reps]
        c = int(self.executor.preferred_chunk(int(chunk), int(bucket)))
        if c < 2:
            return batches
        for i in range(0, len(reps), c):
            part = reps[i:i + c]
            if len(part) < 2:
                part.append(last if part[0] != last else 0)
            part += [a for a in range(len(acts)) if a not in part]
            batches.append(part[:c])
        if c > 2 and last:
            batches.append([0, last])
        batches.append([0] * c)
        return batches

    def precompile_bucket(self, bucket: int, chunk: int) -> bool:
        """Prepare this task's solves of `bucket` ahead of traffic
        (DESIGN.md §12): run the warm batches (`warm_rows` under
        `warm_actions`, stacked as a live flush is) through the
        executor's `precompile`, into the dispatcher a live flush finds,
        so that the first live request launches no cold kernel instance.
        Changes no state a caller sees: no Q-update, no telemetry, no
        trajectory row, no random draw. Returns False when the task has
        no dispatchable form or no action space."""
        low = self.lowerable_for(int(bucket))
        if low is None or self.action_space is None:
            return False
        cfg = dict(low.statics).get("cfg")
        blocked = cfg is not None and cfg.blocking.use_blocked(int(bucket))
        row = self.warm_rows(int(bucket))
        acts = self.action_space.actions
        batches = [stack_fixed([row] * len(idx), [acts[a] for a in idx],
                               len(idx))[:4]
                   for idx in self.warm_actions(bucket, chunk, blocked)]
        return bool(self.executor.precompile(low, batches, int(bucket)))

    def reward(self, outcome: Outcome, action_idx: int,
               instance: LinearSystem, cfg) -> float:
        """Eq. 21 on the outcome's metrics; the inner-iteration count
        named by `inner_iter_metric` feeds the Eq. 25 work penalty."""
        m = outcome.metrics
        return reward_fn(m["ferr"], m["nbe"], m[self.inner_iter_metric],
                         outcome.status,
                         self.action_space.actions[int(action_idx)],
                         instance.features["kappa_est"], cfg)
