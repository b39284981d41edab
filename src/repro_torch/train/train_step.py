"""Train step (port of `repro.train.train_step`): loss -> gradient ->
AdamW update.

`make_train_step` returns `train_step(state, batch) -> (state, metrics)`
with metrics `loss`, `lr` and `grad_norm` (0-dim tensors on the
parameters' device). The gradient is `torch.autograd.grad` of
`models.loss_fn` with respect to the float32 master parameters, which
require grad only for the duration of the step. A parameter the loss
does not reach by a differentiable path gets the gradient None, which
the update reads as zero, as the reference's `jax.value_and_grad` gives
it: under an emulated `LMPrecisionPolicy` every matmul operand goes
through `chop`, whose derivative is zero in the reference (its bitcast
chain) and absent here, so those weights move by AdamW's decay alone.
A loss that reaches no parameter at all is not differentiated. The
update writes the parameters and moments in place (`train.optimizer`),
so the returned state shares the tensors of the one passed in.

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import init_params, loss_fn, params_from_reference
from repro_torch.models.transformer import tree_leaves
from repro_torch.precision.backend import resolve_device

from .optimizer import (AdamWConfig, AdamWState, _map, adamw_init,
                        adamw_update)
from .quantize import QTensor
from .schedule import cosine_with_warmup


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    opt: AdamWConfig = AdamWConfig()
    compute_dtype: Any = torch.bfloat16
    # Cast the float32 master params to compute_dtype before use (in the
    # reference, so FSDP all-gathers move bf16). Router weights stay
    # float32.
    cast_params_for_compute: bool = False


def cast_params(params, dtype):
    """Every float32 leaf in `dtype` but the MoE routers' (a
    differentiable cast)."""
    def walk(tree, router):
        if isinstance(tree, dict):
            return {k: walk(v, router or k == "router")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, router) for v in tree]
        if router or tree.dtype != torch.float32:
            return tree
        return tree.to(dtype)
    return walk(params, False)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor      # 0-dim int32


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     tcfg: TrainStepConfig, device=None,
                     param_dtype=torch.float32) -> TrainState:
    """Parameters drawn from `generator` (on the target device) in
    `param_dtype` (float32 masters), zero moments, step 0."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, param_dtype, dev)
    return TrainState(params, adamw_init(params, tcfg.opt),
                      torch.zeros((), dtype=torch.int32, device=dev))


def make_train_step(cfg: ArchConfig, tcfg: TrainStepConfig, policy=None,
                    residual_sharding=None):
    """Returns train_step(state, batch) -> (state, metrics). `batch` holds
    "tokens" (and optionally "loss_mask", "prefix_embeds") as tensors or
    numpy arrays; they go to the parameters' device."""

    def train_step(state: TrainState, batch: Dict[str, Any]):
        leaves = tree_leaves(state.params)
        dev = leaves[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for p in leaves:
            p.requires_grad_(True)
        try:
            p = state.params
            if tcfg.cast_params_for_compute:
                p = cast_params(p, tcfg.compute_dtype)
            loss, _ = loss_fn(p, batch, cfg, tcfg.compute_dtype, policy,
                              residual_sharding, device=dev)
            if loss.requires_grad:
                flat = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                flat = [None] * len(leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _unflatten(state.params, iter(flat))
        lr = cosine_with_warmup(state.step, peak_lr=tcfg.peak_lr,
                                warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt, stats = adamw_update(state.params, grads, state.opt,
                                          lr, tcfg.opt)
        metrics = {"loss": loss.detach(), "lr": lr, **stats}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def _unflatten(template, flat):
    """The tree of `template`'s structure over the iterator `flat`, in
    `tree_leaves`' order."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], flat) for k in sorted(template)}
    if isinstance(template, list):
        return [_unflatten(t, flat) for t in template]
    return next(flat)


def train_state_from_reference(state, cfg: ArchConfig, device=None
                               ) -> TrainState:
    """This package's `TrainState` from the JAX package's (its leaves as
    numpy arrays, or anything `np.asarray` takes; int8 moments as the
    reference's `QTensor`s of codes and scales): parameters through
    `models.params_from_reference`, moments leaf for leaf onto the same
    device."""
    dev = resolve_device(device)
    params = params_from_reference(state.params, cfg, dev)

    def tensor(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.tensor(x, device=dev)

    def moment(p, x):
        if hasattr(x, "codes") and hasattr(x, "scales"):
            q = QTensor(tensor(x.codes), tensor(x.scales))
            if tuple(q.codes.shape) != tuple(p.shape):
                raise ValueError(f"{cfg.name}: moment codes of shape "
                                 f"{tuple(q.codes.shape)}, expected "
                                 f"{tuple(p.shape)}")
            return q
        t = tensor(x)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{cfg.name}: moment of shape "
                             f"{tuple(t.shape)}, expected {tuple(p.shape)}")
        return t

    opt = state.opt
    return TrainState(
        params,
        AdamWState(tensor(opt.step).to(torch.int32),
                   _map(moment, params, opt.m), _map(moment, params, opt.v)),
        tensor(state.step).to(torch.int32))
