"""Round-to-format emulation on torch tensors: the plain versions.

Port of `repro.precision.chop`. Storage in a reduced floating-point
format is emulated in a wider *carrier* dtype (float32 or float64, on the
GPU and on the CPU), with round-to-nearest-even, subnormals
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
from .rows import as_rows, check_rows

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
    Or all four are integer/bool tensors that broadcast against x, one
    format an element (per-row formats, `_row_params`). The format's emax
    is implied by xmax_bits, the only overflow check needed, so it is not
    an argument here.

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
    if torch.is_tensor(saturate):
        over = torch.where(saturate, xmax_bits, EFMAX << MBITS)
    else:
        over = xmax_bits if saturate else EFMAX << MBITS
    out_mag = torch.where(out_mag > xmax_bits, over, out_mag)
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
    """Round `x` to the format selected by the integer id, or, given
    per-row ids (`rows.RowFormats` or a (B,) integer tensor), each row
    x[k] to the format of id k (the rows grouped by format).

    Formats whose rounding is the identity on this carrier (fp32 and fp64
    on float32, fp64 on float64) return `x` itself: `_chop_core` would
    hand back every bit pattern unchanged.
    """
    if not torch.is_floating_point(x):
        raise TypeError(f"chop expects float carrier, got {x.dtype}")
    rows = as_rows(fmt_id)
    if rows is not None:
        check_rows(rows, x.shape, "chop")
        if rows.uniform is None:
            shape = (-1,) + (1,) * (x.dim() - 1)
            return _chop_core(x, *(p.view(shape) for p in
                                   _row_params(rows, x.dtype, x.device)))
        fmt_id = rows.uniform
    fid = int(fmt_id)
    if _is_identity(FORMAT_LIST[fid], x.dtype):
        return x
    return _chop_core(x, *fmt_params(fid, x.dtype))


def _row_params(rows, dtype, device):
    """(t, emin, xmax_bits, saturate) of each row of per-row formats, as
    (B,) tensors on `device` for `_chop_core` (xmax_bits in the carrier's
    integer type), made once per (carrier, device)."""
    key = ("chop", dtype, device)
    if key not in rows.cache:
        rows.cache[key] = _make_row_params(rows, dtype, device)
    return rows.cache[key]


def _make_row_params(rows, dtype, device):
    IT = _carrier(dtype)[0]
    ids = rows.host
    xmax = (FMT_XMAX_BITS64 if dtype == torch.float64
            else FMT_XMAX_BITS32)[ids].astype(np.int64)
    return (torch.as_tensor(FMT_T[ids], device=device).to(IT),
            torch.as_tensor(FMT_EMIN[ids], device=device).to(IT),
            torch.as_tensor(xmax, device=device).to(IT),
            torch.as_tensor(FMT_SATURATE[ids], device=device))


def rounding_unit(fmt_id, dtype=torch.float32, device=None) -> torch.Tensor:
    """Unit roundoff 2^-t of a format id, as a 0-d tensor (exact: t is in
    [3, 53], and every 2^-t there is a normal float32); of per-row ids, a
    (B,) tensor of each row's."""
    rows = as_rows(fmt_id)
    if rows is not None:
        return torch.tensor(np.ldexp(1.0, -FMT_T[rows.host]), dtype=dtype,
                            device=device)
    t = int(FMT_T[int(fmt_id)])
    return torch.tensor(2.0 ** -t, dtype=dtype, device=device)


def stochastic_bits(x: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
    """Uniform random 32-bit words for `chop_stochastic`, one per element
    of `x`, drawn from `generator` (which must live on x's device) as
    int32 patterns."""
    words = torch.randint(0, 1 << 32, x.shape, dtype=torch.int64,
                          device=x.device, generator=generator)
    return words.to(torch.int32)


def chop_stochastic(x: torch.Tensor, fmt_id, bits: torch.Tensor
                    ) -> torch.Tensor:
    """Stochastic rounding to the format (port of
    `repro.precision.chop_stochastic`; unbiased, E[chop_sr(x)] == x).

    With s bits to drop, add u = bits & (2^s - 1) to the significand
    before truncating. `bits` are uniform 32-bit words of x's shape
    (int32 or uint32 patterns, `stochastic_bits`): the draw the JAX
    function makes with `jax.random.bits(key, x.shape, uint32)`, so fed
    the same words the two agree bit for bit. A CUDA tensor launches the
    `chop_sr` kernel, a CPU tensor runs its plain version. The carrier
    must be float32 (TypeError otherwise, as in the reference)."""
    from repro_torch.kernels.chop.ops import chop_sr_op
    return chop_sr_op(x, fmt_id, bits)


def _chop_leaf(x: torch.Tensor, fmt_id) -> torch.Tensor:
    """chop of one tensor of any shape through the chop kernel's wrapper
    (its plain version for a CPU tensor)."""
    from repro_torch.kernels.chop.ops import chop_op
    if not x.is_cpu and x.ndim > 2:
        x = x.contiguous()
    return chop_op(x, fmt_id)


def chop_tree(tree, fmt_id):
    """Apply `chop` to every float leaf of nested dicts, lists and tuples
    of tensors (port of `repro.precision.chop_tree`). CUDA leaves launch
    the chop kernel; other leaves come back unchanged."""
    if isinstance(tree, dict):
        return type(tree)((k, chop_tree(v, fmt_id)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [chop_tree(v, fmt_id) for v in tree]
        if hasattr(tree, "_fields"):                 # a namedtuple
            return type(tree)(*out)
        return type(tree)(out)
    if isinstance(tree, torch.Tensor) and torch.is_floating_point(tree):
        return _chop_leaf(tree, fmt_id)
    return tree


def chop_matmul(a: torch.Tensor, b: torch.Tensor, fmt_id,
                chop_inputs: bool = True,
                chop_output: bool = True) -> torch.Tensor:
    """Matmul with operands (and result) stored in the emulated format,
    accumulated in the carrier (port of `repro.precision.chop_matmul`):
    chop the inputs, `a @ b`, chop the output. The roundings launch the
    chop kernel for CUDA tensors; the product is torch's, in the
    carrier, so its summation order is the library's (held to the GEMM
    order tolerance of DESIGN.md §6.2). The K-blocked chopped GEMM
    kernel is `kernels.qmatmul.qmatmul_op`."""
    if chop_inputs:
        a = _chop_leaf(a, fmt_id)
        b = _chop_leaf(b, fmt_id)
    out = a @ b
    if chop_output:
        out = _chop_leaf(out, fmt_id)
    return out


def simulate_dtype(x: torch.Tensor, fmt: Union[str, FloatFormat]
                   ) -> torch.Tensor:
    """A native cast where the format has a torch dtype no wider than the
    carrier (bf16, fp16, fp32, fp64), else the chop (port of
    `repro.precision.simulate_dtype`). A registered format's chop runs
    through the chop kernel's wrapper; any other `FloatFormat` through
    `chop_static`."""
    f = get_format(fmt)
    if f.native_dtype is not None:
        native = getattr(torch, f.native_dtype)
        if torch.finfo(native).bits <= torch.finfo(x.dtype).bits:
            return x.to(native).to(x.dtype)
    if f in FORMAT_LIST:
        return _chop_leaf(x, FORMAT_LIST.index(f))
    return chop_static(x, f)
