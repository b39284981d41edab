"""Mixture-of-Experts with sort-based capacity dispatch (port of
`repro.models.moe`).

Tokens are routed with a top-k float32 router (`router_dtype`); dispatch
sorts each batch row's slots by expert id (a stable sort, as
`jnp.argsort` is, so the same tokens drop over capacity as in the
reference) and scatters them into per-expert capacity buffers (B, E, C,
d). Over-capacity slots drop; the residual stream carries dropped tokens
unchanged. The expert FFNs and the gathers are plain torch, as the
reference's are plain jnp.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig

from .layers import activate, ffn, init_dense, init_ffn, normal


def init_moe(gen, cfg: ArchConfig, dtype, device, lead=()):
    d = cfg.d_model
    dff = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": init_dense(gen, d, e, torch.float32, device, lead,
                             scale=0.02),
        "wi_gate": normal(gen, (*lead, e, d, dff), 1 / math.sqrt(d), dtype,
                          device),
        "wi_up": normal(gen, (*lead, e, d, dff), 1 / math.sqrt(d), dtype,
                        device),
        "wo": normal(gen, (*lead, e, dff, d), 1 / math.sqrt(dff), dtype,
                     device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, d, dff * cfg.n_shared_experts, dtype,
                               device, lead)
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _router_probs(params, x):
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    return torch.softmax(logits, dim=-1)


def moe_ffn(params, x: torch.Tensor, cfg: ArchConfig,
            policy=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Routing per token, group dim = batch."""
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(s, cfg)
    dev = x.device

    probs = _router_probs(params, x)                     # float32, pinned
    gates, experts = torch.topk(probs, K, dim=-1)        # (B, S, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # Slot bookkeeping per batch row: sort slots by expert id.
    t = s * K
    slot_e = experts.reshape(b, t)                       # (B, T)
    order = torch.argsort(slot_e, dim=-1, stable=True)
    sorted_e = torch.gather(slot_e, -1, order)
    # Position within each expert's run = index - first index of expert.
    first = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(b, E).contiguous())
    posn = torch.arange(t, device=dev)[None] - torch.gather(first, -1,
                                                            sorted_e)
    keep = posn < C

    tok_of_slot = order // K                             # (B, T)
    xin = torch.gather(x, 1, tok_of_slot[..., None].expand(b, t, d))
    # Scatter into capacity buffers (B, E, C, d).
    e_idx = torch.where(keep, sorted_e, 0)
    c_idx = torch.where(keep, posn, 0)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, t)
    xin = torch.where(keep[..., None], xin, 0)
    buf = torch.zeros((b, E, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((bidx, e_idx, c_idx), xin, accumulate=True)

    # Expert FFN, batched over E: (B,E,C,d) x (E,d,f), in x's dtype.
    wd = x.dtype
    g = activate(torch.einsum("becd,edf->becf", buf,
                              params["wi_gate"].to(wd)), cfg.act)
    u = torch.einsum("becd,edf->becf", buf, params["wi_up"].to(wd))
    h = torch.einsum("becf,efd->becd", g * u, params["wo"].to(wd))

    # Gather back to slots, weight by gates, combine per token.
    y_slot = torch.where(keep[..., None], h[bidx, e_idx, c_idx], 0)
    slot_gate = torch.gather(gates.reshape(b, t), -1, order)
    y_slot = y_slot * slot_gate[..., None].to(wd)
    y = torch.zeros_like(x).index_put_((bidx, tok_of_slot), y_slot,
                                       accumulate=True)

    if cfg.n_shared_experts:
        y = y + ffn(params["shared"], x, cfg.act, policy)
    return y


def aux_load_balance_loss(params, x: torch.Tensor,
                          cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary (fraction x probability),
    forward only."""
    probs = _router_probs(params, x)
    top1 = torch.argmax(probs, -1)
    frac = torch.nn.functional.one_hot(top1, cfg.n_experts).float().mean(
        dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac * imp)
