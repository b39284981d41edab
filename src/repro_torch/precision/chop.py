"""Round-to-format emulation on torch tensors: the plain versions.

Port of `repro.precision.chop`. Storage in a reduced floating-point
format is emulated in a wider *carrier* dtype (float32 on the GPU,
float32 or float64 on the CPU), with round-to-nearest-even, subnormals
of both the format and the carrier, underflow to zero, overflow to inf
(or saturation for the fp8 formats), signed zeros, infs and NaNs.

The rounding is integer bit manipulation on the carrier's IEEE pattern,
the same algorithm as `repro.precision.chop._chop_core` and as the
CUDA chop kernel (`csrc/chop_core.cuh`), so the three agree bit for bit.
Two differences from the JAX code come from torch itself:

  * torch has no shift or compare on uint32/uint64, so the pattern is
    read as int32/int64 with the sign bit masked off: every magnitude
    the algorithm compares is then a non-negative signed integer;
  * torch has no count-leading-zeros, so the msb of the significand M
    comes from `torch.frexp` of M cast to float64, which is exact
    because M < 2^53.

The JAX code computes every intermediate on every lane and selects;
`_chop_core` here drops the selects that only guard lanes whose result
is discarded, which halves the operator count (see its docstring).

Every function here is device-agnostic torch code. It is the plain
version the kernel wrappers run for CPU tensors and the version the GPU
kernels are held against on the card.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .formats import (FMT_EMIN, FMT_SATURATE, FMT_T, FORMAT_LIST,
                      FloatFormat, get_format)

# Carrier descriptions: (int dtype, word bits, mantissa bits, exp bias,
# max exponent field).
_CARRIERS = {
    torch.float32: (torch.int32, 32, 23, 127, 255),
    torch.float64: (torch.int64, 64, 52, 1023, 2047),
}

# xmax bit patterns per format, per carrier (positive magnitude patterns).
_F32_MAX = float(np.finfo(np.float32).max)
FMT_XMAX_BITS32 = np.array(
    [np.float32(min(f.xmax, _F32_MAX)).view(np.uint32)
     for f in FORMAT_LIST], dtype=np.uint32)
FMT_XMAX_BITS64 = np.array(
    [np.float64(f.xmax).view(np.uint64) for f in FORMAT_LIST],
    dtype=np.uint64)


def _carrier(dtype):
    if dtype not in _CARRIERS:
        raise TypeError(f"unsupported carrier dtype {dtype}")
    return _CARRIERS[dtype]


def _chop_core(x: torch.Tensor, t: int, emin: int, xmax_bits: int,
               saturate: bool) -> torch.Tensor:
    """Elementwise round-to-format on the carrier's bit patterns.

    t/emin are python ints; xmax_bits is the (non-negative) bit pattern of
    the format's xmax in the carrier's width; saturate is a python bool.
    The format's emax is implied by xmax_bits, the only overflow check
    needed, so it is not an argument here.

    The steps are those of the JAX `_chop_core`, written with fewer torch
    operators (each costs a launch or a dispatch). Lanes that pass through
    unchanged (inf/nan, and values with no bits to drop, zeros among them)
    are selected at the end, so the arithmetic before may run on them
    freely. Where the JAX code guards or clamps for such lanes, the
    valid lanes need no guard:
      * rounding: 1 <= s; for s >= W the clamped shift W-1 already gives
        Mr = 0 (M + 2^(W-2) < 2^(W-1)), the full underflow;
      * reassembly: Mr <= 2^MBITS, so Mr converts to the carrier exactly
        and adding q to its exponent field is the normal result; a result
        whose field would drop below 1 is the subnormal Mr << k_sub.
    """
    IT, W, MBITS, BIAS, EFMAX = _carrier(x.dtype)
    bits = x.contiguous().view(IT)
    mag = bits & torch.iinfo(IT).max
    Eeff = (mag >> MBITS).clamp(min=1)                 # 1 for subnormals
    M = mag - ((Eeff - 1) << MBITS)                    # with implicit bit
    # msb(M) = frexp exponent - 1; exact since M < 2^53.
    e_x = torch.frexp(M.to(torch.float64))[1] + (Eeff - (BIAS + MBITS + 1))
    q = e_x.clamp(min=emin) - (t - 1)                  # target quantum
    s = q - Eeff + (BIAS + MBITS)                      # bits to round off
    sc = s.clamp(1, W - 1)
    Mr = (M + (torch.bitwise_left_shift(1, sc - 1) - 1)
          + ((M >> sc) & 1)) >> sc                     # RNE(M / 2^sc)

    bits_n = Mr.to(x.dtype).view(IT) + (q << MBITS)    # Mr * 2^q, normal
    bits_s = Mr << (q + (BIAS - 1 + MBITS))            # exponent field 0
    out_mag = torch.where(bits_n < (1 << MBITS), bits_s, bits_n)
    out_mag = torch.where(out_mag > xmax_bits,
                          xmax_bits if saturate else EFMAX << MBITS,
                          out_mag)
    keep = (mag >= EFMAX << MBITS) | (s <= 0)          # inf/nan, exact
    out = torch.where(keep, bits, (bits & torch.iinfo(IT).min) | out_mag)
    return out.view(x.dtype)


def fmt_params(fmt_id: int, dtype=torch.float32):
    """(t, emin, xmax_bits, saturate) of a format id, as python values,
    with xmax_bits in the carrier's width."""
    fid = int(fmt_id)
    xmax_bits = (FMT_XMAX_BITS64 if dtype == torch.float64
                 else FMT_XMAX_BITS32)[fid]
    return (int(FMT_T[fid]), int(FMT_EMIN[fid]), int(xmax_bits),
            bool(FMT_SATURATE[fid]))


def _is_identity(f: FloatFormat, dtype) -> bool:
    """True when rounding to `f` is the identity on every carrier value:
    the format has at least the carrier's significand bits and reaches
    at least as low. Then every value rounds to itself, with no bits to
    drop (s <= 0 in `_chop_core` for every input)."""
    _, _, MBITS, BIAS, _ = _carrier(dtype)
    return f.t >= MBITS + 1 and f.emin <= 1 - BIAS


def fma_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity on values (port of `repro.precision.fma_barrier`).

    The JAX version rounds to the carrier's own format so that XLA cannot
    fuse a multiply into a following add or reduction as an FMA. Eager
    torch runs every operator as its own kernel, so a product is always
    stored, rounded, before any sum reads it, and there is nothing to
    block: the barrier is the identity here. The CUDA kernels keep the
    same order by writing every multiply and add as `__fmul_rn` and
    `__fadd_rn`, which the compiler never contracts.
    """
    _carrier(x.dtype)
    return x


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along `dim` with the FIXED pairwise reduction tree of
    `repro.precision.tree_sum`: fold the upper half onto the lower half,
    log2(n) times; odd widths park their last element in a running tail
    accumulator added once at the end. The qmv and trisolve kernels run
    the same tree, so all three agree bit for bit."""
    x = torch.movedim(x, dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    tail = None
    while x.shape[-1] > 1:
        n = x.shape[-1]
        m = n // 2
        if n % 2:
            last = x[..., n - 1]
            tail = last if tail is None else tail + last
        x = x[..., :m] + x[..., m:2 * m]
    out = x[..., 0]
    return out if tail is None else out + tail


def chop_static(x: torch.Tensor, fmt: Union[str, FloatFormat]
                ) -> torch.Tensor:
    """Round `x` (carrier float tensor) to the format `fmt`."""
    f = get_format(fmt)
    if not torch.is_floating_point(x):
        raise TypeError(f"chop expects float carrier, got {x.dtype}")
    if _is_identity(f, x.dtype):
        return x
    xmax = np.float64(f.xmax) if x.dtype == torch.float64 else \
        np.float32(min(f.xmax, _F32_MAX))
    xmax_bits = int(xmax.view(np.uint64 if x.dtype == torch.float64
                              else np.uint32))
    return _chop_core(x, f.t, f.emin, xmax_bits, f.saturate)


def chop(x: torch.Tensor, fmt_id) -> torch.Tensor:
    """Round `x` to the format selected by the integer id.

    Formats whose rounding is the identity on this carrier (fp32 and fp64
    on float32, fp64 on float64) return `x` itself: `_chop_core` would
    hand back every bit pattern unchanged.
    """
    if not torch.is_floating_point(x):
        raise TypeError(f"chop expects float carrier, got {x.dtype}")
    fid = int(fmt_id)
    if _is_identity(FORMAT_LIST[fid], x.dtype):
        return x
    return _chop_core(x, *fmt_params(fid, x.dtype))


def rounding_unit(fmt_id, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit roundoff 2^-t of a format id, as a 0-d tensor (exact: t is in
    [3, 53], and every 2^-t there is a normal float32)."""
    t = int(FMT_T[int(fmt_id)])
    return torch.tensor(2.0 ** -t, dtype=dtype, device=device)
