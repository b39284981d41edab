"""Plain torch version of the flash attention kernel (port of
`repro.kernels.flash_attention.ref.flash_ref`): masked softmax attention
over the whole score matrix, in float32, with the finite sentinel."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              kind: str = "attn", window: int = 0, chunk: int = 0,
              scale: float | None = None, softcap: float = 0.0,
              groups: int = 1) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BHkv, Sk, D) with BH = BHkv * groups.
    Causal, with an optional window ("local") or chunk ("chunked");
    returns (BH, Sq, D) in q's dtype."""
    sq, d = q.shape[1], q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = k.repeat_interleave(groups, dim=0)
    v = v.repeat_interleave(groups, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = qp >= kp
    if kind == "local" and window:
        mask &= (qp - kp) < window
    if kind == "chunked" and chunk:
        mask &= (qp // chunk) == (kp // chunk)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p,
                        v.to(torch.float32)).to(q.dtype)
