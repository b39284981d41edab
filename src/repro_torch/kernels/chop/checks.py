"""Operands for holding the chop kernel's forms (`ref.FORMS`) against
their plain version, shared by the CPU tests (against the JAX package),
the card tests and chip_smoke.

`expr_cases` gives the broadcast shapes of the solver's call sites, each
at sizes that take each route of the kernel (`ops.chop_route`), as
operand triples (a, b, c) of which a form uses its first `ARITY[form]`:
0-dim operands (the strict substitutions' slot updates, the Givens
scalars, `cg.py`'s `rho / pq`), a 0-dim operand with vectors
(`gmres.py`'s `w - chop(h v)`, `v / beta`; `cg.py`'s `z + chop(alpha
p)`, `r - chop(alpha q)`, `y + chop(beta p)`), vectors (`ir.py`, the
dots' products), a matrix with a column and a row (the
LU's `A - chop(col row)`, `gmres.py`'s `V * y[:, None]`), an outer
product, matrices, a strided view (the LU's panel and trailing block),
a broadcast row, and views off 16-byte alignment. Every operand mixes
values spread over the carrier's exponents with the special ones: signed
zeros, infinities, NaN, the format's largest value and its rounding
neighbours, carrier subnormals, and zeros in the divisor.

`out_views` gives the output views a call may store into: a fresh
tensor, `a` itself, and strided views of a wider buffer; `live_ranges`
the live ranges of a 1-D result at both ends.

`sr_patterns` gives the inputs the stochastic rounding (`chop_sr`) is
held on: every float32 exponent field, each format's edges and deep
underflow.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.precision.formats import FORMAT_LIST


def special_values(fid: int, dtype=torch.float32) -> torch.Tensor:
    """The special operands of format `fid` in the carrier `dtype`."""
    f = FORMAT_LIST[fid]
    fi = torch.finfo(dtype)
    xmax = min(f.xmax, float(fi.max))
    x = torch.tensor(xmax, dtype=dtype)
    ulp = 2.0 ** (math.floor(math.log2(xmax)) - (f.t - 1))
    vals = [0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0,
            -1.0, 2.0, 0.5, 3.0, float(fi.tiny), float(fi.tiny) * 0.75,
            float(fi.tiny) / 2 ** 10, 2.0 ** f.emin,
            2.0 ** (f.emin - f.t + 1), xmax,
            float(torch.nextafter(x, torch.tensor(0.0, dtype=dtype))),
            float(torch.nextafter(x, torch.tensor(float("inf"),
                                                  dtype=dtype))),
            min(xmax + ulp / 2, float(fi.max)), float(fi.max)]
    v = torch.tensor(vals, dtype=dtype)
    return torch.cat([v, -v[5:]])


def operands(fid: int, n: int, seed: int, dtype=torch.float32):
    """Three vectors of n values each: every pair of special values in
    the first two, the specials in turn in the third, then values spread
    over the carrier's exponents (signs and fractions at random, a tenth
    of them zero), all in one random order."""
    s = special_values(fid, dtype)
    k = s.numel()
    pa, pb, pc = s.repeat_interleave(k), s.repeat(k), s.roll(1).repeat(k)
    rng = np.random.default_rng(seed)
    lim = 120 if dtype == torch.float32 else 1000
    m = max(n - pa.numel(), 0)
    rand = (torch.from_numpy(
        rng.standard_normal(m) * 2.0 ** rng.integers(-lim, lim, m)
        * (rng.random(m) > 0.1)).to(dtype) for _ in range(3))
    perm = torch.from_numpy(rng.permutation(n))
    return tuple(torch.cat([p, r])[:n][perm]
                 for p, r in zip((pa, pb, pc), rand))


def expr_cases(fid: int, seed: int, dtype=torch.float32,
               sizes=(40, 128, 4099)):
    """[(name, a, b, c)]: the call sites' broadcast shapes, each at every
    size in `sizes` (a matrix side is the square root of a size, rounded
    up), with the special values of `operands`."""
    f = FORMAT_LIST[fid]
    xmax = min(f.xmax, float(torch.finfo(dtype).max))
    # The 0-dim operands, one triple per size: the format's largest
    # value, signed zeros (a division by zero), an infinity, plain values.
    scalars = [(xmax, 0.0, -0.0), (-0.0, -float("inf"), 3.0),
               (3.0, 0.5, 0.0)]
    cases = []
    for k, n in enumerate(sizes):
        sa, sb, sc = (torch.tensor(v, dtype=dtype)
                      for v in scalars[k % len(scalars)])
        side = int(np.ceil(np.sqrt(n)))
        a, b, c = operands(fid, 2 * n + 4 * side * side, seed + n, dtype)
        va, vb, vc = a[:n], b[:n], c[:n]
        ma, mb, mc = (t[n:n + side * side].reshape(side, side).clone()
                      for t in (a, b, c))
        wide = a[-2 * side * side:].reshape(side, 2 * side)
        cases += [
            ("0-dim", sa, sb, sc),
            (f"0-dim with vectors {n}", sa, vb, vc),
            (f"vector with 0-dim {n}", va, sb, vc),
            (f"vectors {n}", va, vb, vc),
            (f"vectors off 16-byte alignment {n}", a[1:n], b[3:n + 2],
             c[2:n + 1]),
            (f"matrix, column and row {side}x{side}", ma, vb[:side, None],
             vc[-side:]),
            (f"outer product {side}x{side}", va[:side, None],
             vb[None, -side:], mc),
            (f"matrices {side}x{side}", ma, mb, mc),
            (f"strided view with matrices {side}x{side}",
             wide[:, side // 2:side // 2 + side], mb, mc),
            (f"row with matrix {side}x{side}", va[None, :side], mb,
             vc[:side]),
        ]
    return cases


def out_views(shape, like: torch.Tensor):
    """[(name, view)]: output views of `shape` on `like`'s device and
    dtype: a contiguous tensor and strided views of a wider buffer (every
    other element of a vector or of a matrix's rows, a transposed
    matrix), each filled with NaN so that an element left unwritten
    shows."""
    def nan(*s):
        return torch.full(s, float("nan"), dtype=like.dtype,
                          device=like.device)
    views = [("contiguous", nan(*shape))]
    if len(shape) == 1:
        views.append(("every other element", nan(2 * shape[0] + 1)[1::2]))
    elif len(shape) == 2:
        M, N = shape
        views += [("every other column", nan(M, 2 * N + 1)[:, 1::2]),
                  ("transposed", nan(N, M).t())]
    return views


def live_ranges(n: int):
    """Live ranges of a 1-D result of n elements: empty at both ends, one
    element at both ends, a prefix (the lower substitution's products),
    a suffix (the upper one's), everything, and past the end."""
    return [(0, 0), (n, n), (0, 1), (n - 1, n), (0, n // 2),
            (n // 2 + 1, n), (0, n), (3, n + 5), (5, 2)]


def to_keeping_layout(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device` with its strides and storage offset (`Tensor.to`
    makes a strided view contiguous and moves a view off 16-byte
    alignment onto a fresh, aligned allocation)."""
    if t.dim() == 0:
        return t.to(device)
    storage = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return storage.to(device).as_strided(t.shape, t.stride(),
                                         t.storage_offset())


def same_bits_any_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit patterns, every NaN read as one NaN."""
    itype = torch.int32 if got.dtype == torch.float32 else torch.int64
    g = got.contiguous().view(itype)
    w = want.contiguous().view(itype)
    both_nan = torch.isnan(got) & torch.isnan(want)
    return bool(((g == w) | both_nan).all())


def sr_patterns(seed: int = 3) -> torch.Tensor:
    """float32 inputs for `chop_sr`: every exponent field (32 random
    fractions and signs each), each format's largest value, smallest
    normal and subnormal and a value 40 binades below that (deep
    underflow), with their neighbours, halves and one-and-a-halves,
    float32 subnormals, zeros, infinities and NaN, both signs."""
    rng = np.random.default_rng(seed)
    exps = np.repeat(np.arange(256, dtype=np.uint32), 32)
    pats = ((rng.integers(0, 2, exps.size, dtype=np.uint32) << 31)
            | (exps << 23)
            | rng.integers(0, 1 << 23, exps.size, dtype=np.uint32))
    edges = [0.0, np.inf, np.nan, 1.0, 1e-45, 1e-40, 1.1754942e-38,
             2.0 ** -140, 2.0 ** -149]
    with np.errstate(over="ignore"):
        for f in FORMAT_LIST:
            for v in (min(f.xmax, 3.4e38), 2.0 ** max(f.emin, -149),
                      2.0 ** max(f.emin - f.t + 1, -149),
                      2.0 ** max(f.emin - f.t - 40, -149)):
                x = np.float32(v)
                edges += [x, np.nextafter(x, np.float32(0)),
                          np.nextafter(x, np.float32(np.inf)), x * 1.5,
                          x * 0.75]
    edges = np.asarray(edges, np.float32)
    return torch.from_numpy(np.concatenate([pats.view(np.float32), edges,
                                            -edges]))
