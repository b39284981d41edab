"""How flash attention is checked against its plain versions, in one
place for `chip_smoke.py` and the tests: `within_bf16_rows`, the row
tolerance of a bf16 output, and `flash_tiled_ref`, a plain float32 model
of the wgmma route's numerics. Nothing on the main path calls it.
"""
from __future__ import annotations

import math
from collections.abc import Iterable

import torch

from .ref import NEG_INF


def ulp_bf16(y: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |y|, in
    float32; at least that of the smallest normal."""
    e = torch.frexp(y.float().abs().clamp(min=2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def within_bf16_rows(got: torch.Tensor, want: torch.Tensor, ulps: int = 2):
    """A bf16 attention output `got` against `want`, row by row (the last
    axis is the head dim): (ok, max abs error, largest share of the
    tolerance). ok when every element is within `ulps` bf16 ulps of the
    largest |want| of its output row (one query of one head) and every
    element of `got` is finite. Two ulps: both sides round a float32
    result that agrees with the other to ~1e-5 of the row, plus the
    kernel's P rounded to bf16 (~2^-9 sum_k p_k |v_k| / l, far below an
    ulp of the row when the row averages many values), so they differ
    by at most one rounding step at the row's scale."""
    want = want.to(got.device)
    diff = (got.float() - want.float()).abs()
    lim = ulps * ulp_bf16(want.float().abs().amax(-1, keepdim=True))
    share = diff / lim
    ok = bool(torch.isfinite(got).all()) and bool((share <= 1.0).all())
    if not diff.numel():
        return ok, 0.0, 0.0
    return ok, float(diff.max()), float(share.max())


def round_significant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x rounded to `bits` significant bits, to nearest even, in float32
    (8: bf16's rounding of a normal float32 value)."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(torch.ldexp(m, torch.full_like(e, bits))),
                       e - bits)


def flash_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kind: str = "attn", window: int = 0, chunk: int = 0,
                    scale: float | None = None, softcap: float = 0.0,
                    groups: int = 1, bk: int = 64, p_bits: int = 8,
                    tiles: Iterable[int] | None = None) -> torch.Tensor:
    """The wgmma route's numerics in plain float32: q (BH, Sq, D), k/v
    (BHkv, Sk, D) as `ref.flash_ref` takes them, key tiles of `bk` in
    increasing order (`tiles`: the tile indices visited, default all),
    the online softmax with the finite sentinel, P rounded to `p_bits`
    significant bits (8: bf16, as the kernel feeds P to the tensor
    cores) before P V, l summed from the unrounded p, then
    acc / (l == 0 ? 1 : l) in q's dtype. Visiting a fully masked tile
    before the first live one, or after it, changes no row that has a
    live key (the sentinel argument of `csrc/flash_attention.cu`)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=0)
    vf = v.float().repeat_interleave(groups, dim=0)
    qp = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    for t in (range(-(-sk // bk)) if tiles is None else tiles):
        ks = slice(t * bk, min((t + 1) * bk, sk))
        s = torch.einsum("hqd,hkd->hqk", qf, kf[:, ks]) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / max(softcap, 1e-6))
        kp = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
        live = qp >= kp
        if kind == "local":
            live &= (qp - kp) < window
        if kind == "chunked":
            live &= (qp // chunk) == (kp // chunk)
        s = torch.where(live[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "hqk,hkd->hqd", round_significant(p, p_bits), vf[:, ks])
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
