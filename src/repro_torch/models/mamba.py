"""Mamba-1 (S6) block (port of `repro.models.mamba`): in-proj, causal
depthwise conv, selective SSM scan.

The scan is chunked as in the reference: a loop over chunks of `CHUNK`
steps carries the (B, d_inner, d_state) boundary state, and inside a
chunk the discretized (B, chunk, d_inner, d_state) tensors are built and
combined by an inclusive associative scan (log2(chunk) doubling steps of
the reference's `combine`). The recurrence is the same; the order of the
float32 products inside a chunk is the doubling tree's, not
`lax.associative_scan`'s, so the two agree to float32 rounding. Decode
keeps (conv window, ssm state) as the cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig

from .layers import dot, init_dense, normal, zeros

CHUNK = 128


def init_mamba(gen, cfg: ArchConfig, dtype, device, lead=()):
    d, di, ds, dtr = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank)
    # S4D-real initialization for A; dt's bias from log-uniform dt.
    a_init = torch.arange(1, ds + 1, dtype=torch.float32,
                          device=device).expand(*lead, di, ds)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((*lead, di), generator=gen, dtype=torch.float32,
                   device=device) * (hi - lo) + lo
    return {
        "in_proj": init_dense(gen, d, 2 * di, dtype, device, lead),
        "conv_w": normal(gen, (*lead, cfg.ssm_conv, di), 0.1, dtype, device),
        "conv_b": zeros((*lead, di), dtype, device),
        "x_proj": init_dense(gen, di, dtr + 2 * ds, dtype, device, lead),
        "dt_proj": init_dense(gen, dtr, di, dtype, device, lead),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),  # float32 pinned
        "A_log": torch.log(a_init).contiguous(),           # float32 pinned
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": init_dense(gen, di, d, dtype, device, lead),
    }


def _ssm_params(params, xc, cfg):
    """xc: (B, S, di) post-conv activations -> dt, B_t, C_t (float32)."""
    dtr, ds = cfg.dt_rank, cfg.ssm_state
    proj = dot(xc, params["x_proj"]).float()
    dt_in, Bt, Ct = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = torch.einsum("bsr,rd->bsd", dt_in, params["dt_proj"].float())
    dt = F.softplus(dt + params["dt_bias"])
    return dt, Bt, Ct


def _assoc_scan(a, bx):
    """Inclusive scan over dim 1 of the reference's combine, (al, bl) then
    (ar, br) -> (al ar, bl ar + br), by doubling."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :-off], bx[:, :-off]
        a_cur, b_cur = a[:, off:], bx[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        bx = torch.cat([bx[:, :off], b_prev * a_cur + b_cur], dim=1)
        off *= 2
    return a, bx


def _scan_chunked(dt, Bt, Ct, xf, A, h0):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;
    y = C_t . h_t, a chunk at a time. dt, xf: (B, S, di); Bt, Ct:
    (B, S, ds); A: (di, ds); h0: (B, di, ds). Returns (y (B, S, di)
    float32, h_last)."""
    s = dt.shape[1]
    chunk = CHUNK if s % CHUNK == 0 else s
    h = h0
    ys = []
    for c in range(0, s, chunk):
        dt_c, b_c, c_c, x_c = (v[:, c:c + chunk] for v in (dt, Bt, Ct, xf))
        dA = torch.exp(dt_c[..., None] * A[None, None])  # (B,chunk,di,ds)
        dBx = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        a_acc, bx_acc = _assoc_scan(dA, dBx)
        h_all = bx_acc + a_acc * h[:, None]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c_c))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _causal_conv(x, w, b, state=None):
    """x: (B, S, di); w: (K, di) depthwise. state: (B, K-1, di) or None."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype), xp[:, -(k - 1):]


def mamba_forward(params, x: torch.Tensor, cfg: ArchConfig,
                  policy=None) -> torch.Tensor:
    """x: (B, S, d); chunks of `CHUNK` where S is a multiple of it, else
    one chunk."""
    b = x.shape[0]
    di, ds = cfg.d_inner, cfg.ssm_state
    xz = dot(x, params["in_proj"], policy, "ssm")
    xr, z = torch.chunk(xz, 2, dim=-1)
    xc, _ = _causal_conv(xr, params["conv_w"], params["conv_b"])
    xc = F.silu(xc)
    dt, Bt, Ct = _ssm_params(params, xc, cfg)
    A = -torch.exp(params["A_log"])                      # (di, ds) float32
    xf = xc.float()
    h0 = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    y, _ = _scan_chunked(dt, Bt, Ct, xf, A, h0)
    y = y + params["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return dot(y, params["out_proj"], policy, "ssm")


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, K-1, di)
    h: torch.Tensor        # (B, di, ds) float32


def init_mamba_cache(batch: int, cfg: ArchConfig, dtype, device,
                     lead=()) -> MambaCache:
    return MambaCache(
        zeros((*lead, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype, device),
        zeros((*lead, batch, cfg.d_inner, cfg.ssm_state), torch.float32,
              device))


def mamba_decode(params, x: torch.Tensor, cache: MambaCache,
                 cfg: ArchConfig, policy=None):
    """One-token step. x: (B, 1, d). Returns (out, new cache)."""
    xz = dot(x, params["in_proj"], policy, "ssm")
    xr, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                  cache.conv)
    xc = F.silu(xc)
    dt, Bt, Ct = _ssm_params(params, xc, cfg)
    A = -torch.exp(params["A_log"])
    xf = xc.float()
    dA = torch.exp(dt[:, 0, :, None] * A[None])          # (B,di,ds)
    dBx = (dt[:, 0] * xf[:, 0])[..., None] * Bt[:, 0, None, :]
    h = dA * cache.h + dBx
    y = torch.einsum("bdn,bn->bd", h, Ct[:, 0])
    y = y + params["D"] * xf[:, 0]
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = dot(y, params["out_proj"], policy, "ssm")
    return out, MambaCache(conv_state.to(cache.conv.dtype), h)
