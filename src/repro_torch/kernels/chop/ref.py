"""Plain torch versions of the chop kernels: `repro_torch.precision.chop`
(itself held bit for bit against `repro.precision.chop`), alone and in
the fused forms of `csrc/chop.cu`, on any carrier and device; and the
stochastic rounding of `csrc/chop_sr.cu` (`chop_sr_ref`)."""
from __future__ import annotations

import operator

import torch

from repro_torch.precision.chop import chop, fmt_params
from repro_torch.precision.rows import as_rows, check_rows

# The kernel's forms, in the order of its form codes, and how many
# operands each takes.
FORMS = ("x", "add", "sub", "mul", "div", "sub_mul", "sub_div", "add_mul")
ARITY = {"x": 1, "add": 2, "sub": 2, "mul": 2, "div": 2, "sub_mul": 3,
         "sub_div": 3, "add_mul": 3}
_BINARY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv}


def chop_ref(x: torch.Tensor, fmt_id) -> torch.Tensor:
    return chop(x, fmt_id)


def check_operands(form, a, b, c):
    """Raise unless `form` is one of FORMS and exactly its operands are
    given, `a` first."""
    n = ARITY.get(form)
    if n is None:
        raise ValueError(f"chop: unknown form {form!r}; one of {FORMS}")
    if a is None or (b is None) != (n < 2) or (c is None) != (n < 3):
        raise ValueError(f"chop: form {form!r} takes {n} operand(s)")


def chop_expr_ref(form: str, a: torch.Tensor, b=None, c=None, *, fmt_id,
                  out=None, live=None) -> torch.Tensor:
    """The form's value, torch's operations and the plain rounding in
    the kernel's order:

      x        chop(a)
      add..div chop(a op b)
      sub_mul  chop(a - chop(b * c))
      sub_div  chop(chop(a - b) / c)
      add_mul  chop(a + chop(b * c))

    with torch's broadcasting. `live = (lo, hi)` (a 1-D result or one
    row, (1, N)) stores +0 outside positions [lo, hi). `out`, a tensor of the result's
    shape (it may be `a` itself), receives the result and is returned.

    With per-row ids (`precision.rows`), dim 0 of the result is the
    batch, each row rounded to its own format (the operands are
    broadcast to the result's shape first, so that every intermediate
    rounding sees the batch as its dim 0), and `live` applies to the
    last dimension of a (B, N) result."""
    check_operands(form, a, b, c)
    rows = as_rows(fmt_id)
    if rows is not None and rows.uniform is not None:
        fmt_id = rows.uniform       # one format: no row sees another's
    elif rows is not None:
        ops = [t for t in (a, b, c) if t is not None]
        if len(ops) > 1:
            ops = torch.broadcast_tensors(*ops)
        check_rows(rows, ops[0].shape, "chop")
        a, b, c = (list(ops) + [None, None])[:3]
        fmt_id = rows
    if form == "x":
        r = chop(a, fmt_id)
    elif form == "sub_mul":
        r = chop(a - chop(b * c, fmt_id), fmt_id)
    elif form == "sub_div":
        r = chop(chop(a - b, fmt_id) / c, fmt_id)
    elif form == "add_mul":
        r = chop(a + chop(b * c, fmt_id), fmt_id)
    else:
        r = chop(_BINARY[form](a, b), fmt_id)
    if rows is not None:
        check_rows(rows, r.shape, "chop")
    if live is not None:
        if not (r.ndim == 1 or (r.ndim == 2 and (rows is not None
                                                 or r.shape[0] == 1))):
            raise ValueError("chop: a live range takes a 1-D result or one "
                             "row (with per-row formats a (B, N) one), not "
                             f"a {r.ndim}-D one of shape {tuple(r.shape)}")
        lo, hi = live
        if lo < 0:
            raise ValueError(f"chop: live range {live} starts below 0")
        kept = torch.zeros_like(r)
        kept[..., lo:hi] = r[..., lo:hi]
        r = kept
    if out is None:
        return r
    if out.shape != r.shape:
        raise ValueError(f"chop: out has shape {tuple(out.shape)}, the "
                         f"result {tuple(r.shape)}")
    return out.copy_(r)


def _msb(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each positive int64 below 2^53
    (frexp of the exact float64 value)."""
    return torch.frexp(v.to(torch.float64))[1].to(torch.int64) - 1


def sr_words(bits: torch.Tensor) -> torch.Tensor:
    """Random words as the kernel reads them: int32 or uint32 tensors of
    32-bit patterns, read as int32."""
    if bits.dtype == torch.uint32:
        return bits.view(torch.int32)
    if bits.dtype != torch.int32:
        raise TypeError("chop_stochastic: the random words are int32 or "
                        f"uint32 patterns, not {bits.dtype}")
    return bits


def chop_sr_ref(x: torch.Tensor, fmt_id, bits: torch.Tensor
                ) -> torch.Tensor:
    """Stochastic rounding of float32 `x` to the format `fmt_id` with the
    random words `bits` (int32 or uint32 patterns of x's shape): the
    JAX package's `chop_stochastic` (`repro/precision/chop.py:237`) fed
    `bits` as its `jax.random.bits` draw, and the plain version of the
    `chop_sr` kernel (`csrc/chop_core.cuh` `chop_sr_f32`).

    The uint32 arithmetic of the reference runs in int64, where no step
    overflows: M < 2^24 and u < 2^31, and every shifted value fits in 32
    bits on the lanes whose result is kept."""
    if x.dtype != torch.float32:
        raise TypeError("chop_stochastic targets the f32 carrier")
    words = sr_words(bits)
    if words.shape != x.shape:
        raise ValueError(f"chop_stochastic: random words of shape "
                         f"{tuple(words.shape)} for x of {tuple(x.shape)}")
    t, emin, xmax_bits, saturate = fmt_params(fmt_id, torch.float32)
    pat = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = words.contiguous().to(torch.int64) & 0xFFFFFFFF
    sign = pat & 0x80000000
    mag = pat & 0x7FFFFFFF
    E = mag >> 23
    frac = mag & 0x7FFFFF
    M = torch.where(E == 0, frac, frac | 0x800000)
    base = E.clamp(min=1) - 150                        # |x| = M 2^base
    q = (_msb(M.clamp(min=1)) + base).clamp(min=emin) - (t - 1)
    s = q - base                                       # bits to round off
    sc = s.clamp(0, 31)
    Mr = (M + (r & (torch.bitwise_left_shift(1, sc) - 1))) >> sc
    Mr = torch.where(s > 31, 0, Mr)                    # deep underflow
    Mr_g = Mr.clamp(min=1)
    msb_r = _msb(Mr_g)
    new_e = msb_r + q
    shift_n = 23 - msb_r
    bits_n = ((new_e + 127) << 23) | (
        ((Mr_g << shift_n.clamp(0, 31)) >> (-shift_n).clamp(0, 31))
        & 0x7FFFFF)
    bits_s = Mr_g << (q + 149).clamp(0, 31)            # exponent field 0
    out = torch.where(new_e < -126, bits_s, bits_n)
    out = torch.where(Mr == 0, 0, out)
    out = torch.where(out > xmax_bits,
                      xmax_bits if saturate else 0x7F800000, out)
    keep = (mag >= 0x7F800000) | (mag == 0) | (s <= 0)
    res = torch.where(keep, pat, sign | out)
    return res.to(torch.int32).view(torch.float32).reshape(x.shape)
