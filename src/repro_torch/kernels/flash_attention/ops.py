"""Wrapper of the CUDA flash attention forward kernel
(`csrc/flash_attention.cu`), the port of
`repro/kernels/flash_attention/flash.py::flash_attention_pallas` as
`repro/kernels/flash_attention/ops.py::flash_attention_op` calls it, in
the model's (B, S, H, D) layout.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (`ref.flash_ref`). The kernel chooses its own tiles (64 query
rows, 32 keys): tiling changes only the rounding, never which terms are
summed, so `bq` and `bk` are checked as the JAX op checks them and have
no other effect.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import library

from .ref import flash_ref

KINDS = {"attn": 0, "local": 1, "chunked": 2}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       kind: str = "attn", window: int = 0, chunk: int = 0,
                       softcap: float = 0.0, scale: float | None = None,
                       bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype. Causal; kind "local" adds a window, "chunked" a chunk;
    `softcap` > 0 caps the logits.

    Raises ValueError where the JAX op asserts (Sq and Sk must be
    multiples of min(bq, Sq) and min(bk, Sk)), and where the TPU kernel
    and its own oracle disagree: a local window <= 0 (the kernel masks
    every score, the oracle runs plain causal), a chunk <= 0 (the kernel
    divides by zero) and a negative softcap (the kernel ignores it, the
    oracle applies its absolute value)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not group")
    if kind not in KINDS:
        raise ValueError(f"flash_attention: kind {kind!r}, expected one of "
                         f"{tuple(KINDS)}")
    if kind == "local" and window <= 0:
        raise ValueError(f"flash_attention: local attention needs "
                         f"window > 0, got {window}")
    if kind == "chunked" and chunk <= 0:
        raise ValueError(f"flash_attention: chunked attention needs "
                         f"chunk > 0, got {chunk}")
    if softcap < 0:
        raise ValueError(f"flash_attention: softcap {softcap} < 0")
    if sq < 1 or sk < 1 or bq < 1 or bk < 1:
        raise ValueError("flash_attention: empty sequence or block")
    if sq % min(bq, sq) or sk % min(bk, sk):
        raise ValueError(f"flash_attention: Sq={sq} and Sk={sk} must be "
                         f"multiples of min(bq={bq}, Sq) and min(bk={bk}, "
                         "Sk): pad the sequence to a block multiple")
    groups = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    if q.device.type == "cpu":
        o = flash_ref(qf, kf, vf, kind=kind, window=window, chunk=chunk,
                      scale=scale, softcap=softcap, groups=groups)
    else:
        library.check_cuda("flash_attention", qf, kf, vf,
                           dtypes=(torch.float32, torch.bfloat16))
        if d not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {d}, the kernel "
                             f"takes {HEAD_DIMS}")
        o = torch.empty_like(qf)
        rc = library.load().repro_flash_attention(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
            b * hq, sq, sk, d, groups, KINDS[kind], int(window), int(chunk),
            float(scale), float(softcap), int(q.dtype == torch.bfloat16),
            library.stream_of(qf))
        library.check(rc, "flash_attention")
        library.count_launch("flash_attention")
    return o.reshape(b, hq, sq, d).permute(0, 2, 1, 3)
