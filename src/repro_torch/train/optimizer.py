"""AdamW with float32 master parameters and optionally int8-quantized
moments (port of `repro.train.optimizer`).

    state = adamw_init(params, cfg)
    params, state, stats = adamw_update(params, grads, state, lr, cfg)

The parameter tree is the port's (`models.init_params`: nested dicts and
lists of tensors). The update keeps the reference's operation order:
the global norm over every gradient leaf, clipping by
min(1, clip / (norm + 1e-9)), the moments, the bias corrections from the
float32 step count, and decoupled weight decay on the float32 master
weight. It runs under `torch.no_grad()` and, unlike the JAX package's
functional update, writes the parameters and the float32 moments in
place (the returned trees share their tensors): at a full-width model
that saves a second copy of parameters and moments. A gradient leaf that
is None (a parameter the loss does not reach by a differentiable path)
counts as a zero gradient, which is what the reference's
`jax.value_and_grad` returns for it.

With `quantize_moments=True` both moments live as blockwise-int8
`QTensor`s: 2 bytes a parameter of optimizer state instead of 8."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import tree_leaves

from .quantize import QTensor, dequantize_int8, quantize_int8


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False
    quant_block: int = 256


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    m: Any               # tree of float32 tensors or QTensors
    v: Any


def _map(fn, *trees):
    """`fn` over the leaves of the parameter tree's structure (dicts and
    lists; a QTensor is a leaf), the first tree giving the structure; a
    None in a later tree stands for a whole None subtree."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(None if x is None else x[k] for x in trees))
                for k in t}
    if isinstance(t, list):
        return [_map(fn, *(None if x is None else x[i] for x in trees))
                for i in range(len(t))]
    return fn(*trees)


def _maybe_q(x, cfg: AdamWConfig):
    return quantize_int8(x, cfg.quant_block) if cfg.quantize_moments else x


def _maybe_dq(x, cfg: AdamWConfig):
    return dequantize_int8(x, cfg.quant_block) if isinstance(x, QTensor) \
        else x


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    def zeros(p):
        return _maybe_q(torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device), cfg)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      _map(zeros, params), _map(zeros, params))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (None leaves skipped: a
    zero gradient adds nothing), summed leaf by leaf in the reference's
    order, in float32."""
    leaves = [x for x in tree_leaves(tree) if x is not None]
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else None)
    return torch.sqrt(sum((torch.sum(torch.square(x.float()))
                           for x in leaves), total))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """params: float32 master weights, updated in place (module
    docstring). `lr` a number or a 0-dim tensor. Returns (params,
    new_state, {"grad_norm": norm})."""
    step = state.step + 1
    gnorm = global_norm(grads).to(step.device)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    stepf = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=step.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=step.device)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        pf = p.float()
        g = torch.zeros_like(pf) if g is None else g.float() * clip
        # b1 m + (1 - b1) g and b2 v + (1 - b2) g g with each product
        # rounded as the reference rounds it; float32 moments in place.
        m = _maybe_dq(m, cfg).mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v = _maybe_dq(v, cfg).mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = m / bc1
        u.div_((v / bc2).sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * pf)
        torch.sub(pf, u.mul_(lr), out=u)
        p.copy_(u)
        return _maybe_q(m, cfg), _maybe_q(v, cfg)

    pairs = _map(upd, params, grads, state.m, state.v)
    new_m = _map(lambda mv: mv[0], pairs)
    new_v = _map(lambda mv: mv[1], pairs)
    return params, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
