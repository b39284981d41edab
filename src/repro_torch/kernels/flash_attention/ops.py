"""Wrapper of the CUDA flash attention forward kernels
(`csrc/flash_attention.cu`), the port of
`repro/kernels/flash_attention/flash.py::flash_attention_pallas` as
`repro/kernels/flash_attention/ops.py::flash_attention_op` calls it, in
the model's (B, S, H, D) layout.

A CUDA tensor launches a kernel or raises; a CPU tensor runs the plain
version (`ref.flash_ref`). Two kernels, chosen by `ROUTES` from the I/O
type and the head dim: "wgmma", bf16 on the tensor cores (TMA-fed K/V
ring, 128-row query tiles, key tiles of `WGMMA_BK[d]`), and "simt",
float32 arithmetic on the CUDA cores (64-row query tiles, 32-key tiles).
A failed launch raises on either route: no route gives way to the other
or to the plain version. The kernels choose their own tiles: tiling
changes only the rounding, never which terms are summed, so `bq` and
`bk` are checked as the JAX op checks them and have no other effect.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import library

from .ref import flash_ref

KINDS = {"attn": 0, "local": 1, "chunked": 2}
HEAD_DIMS = (16, 32, 64, 128, 256)
# (I/O dtype, head dim) -> route. bf16 at D >= 64 runs on the bf16 tensor
# cores with P rounded to bf16 before P V (`checks.flash_tiled_ref`
# models it); float32 stays on the SIMT kernel, since on the tensor cores
# it would be TF32 (about 3 decimal digits), and bf16 at D 16 and 32 is
# below the kernel's 64-column TMA box.
ROUTES = {**{(torch.float32, d): "simt" for d in HEAD_DIMS},
          **{(torch.bfloat16, d): "wgmma" if d >= 64 else "simt"
             for d in HEAD_DIMS}}
# Keys per tile of the wgmma kernel (`Wg<D>::BK`): 64 at D = 256, where
# the registers of the 64 x 256 accumulator leave room for no more.
WGMMA_BK = {64: 128, 128: 128, 256: 64}
_ROUTE_CODES = {"simt": 0, "wgmma": 1}   # `enum Route` in the source


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       kind: str = "attn", window: int = 0, chunk: int = 0,
                       softcap: float = 0.0, scale: float | None = None,
                       bq: int = 128, bk: int = 128,
                       route: str | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype. Causal; kind "local" adds a window, "chunked" a chunk;
    `softcap` > 0 caps the logits. `route` None takes `ROUTES`; "simt"
    sends any type and head dim to the SIMT kernel (the card checks hold
    it on bf16 that way); "wgmma" is taken only where `ROUTES` gives it.
    CPU tensors run the plain version whatever the route.

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
    if route not in (None, *_ROUTE_CODES):
        raise ValueError(f"flash_attention: unknown route {route!r}")
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
        taken = ROUTES[(q.dtype, d)]
        if route == "wgmma" and taken != "wgmma":
            raise ValueError(f"flash_attention: no wgmma kernel for "
                             f"{q.dtype} at head dim {d}")
        if (route or taken) == "wgmma":
            # TMA reads from 16-byte aligned addresses; a contiguous view
            # at another offset is copied (the SIMT kernel takes any).
            qf, kf, vf = (x if x.data_ptr() % 16 == 0 else x.clone()
                          for x in (qf, kf, vf))
        o = torch.empty_like(qf)
        dev = library.call(
            "repro_flash_attention", "flash_attention", qf,
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
            b * hq, sq, sk, d, groups, KINDS[kind], int(window), int(chunk),
            float(scale), float(softcap), int(q.dtype == torch.bfloat16),
            _ROUTE_CODES[route or taken])
        library.count_launch("flash_attention", route or taken, dev,
                             variant=(q.dtype, d, kind))
        library.FLASH_KIND_LAUNCHES[kind] += 1
    return o.reshape(b, hq, sq, d).permute(0, 2, 1, 3)
