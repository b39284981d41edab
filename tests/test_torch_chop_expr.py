"""The chop kernel's fused forms (`kernels.chop.FORMS`) of the torch
port, on the CPU.

  * `chop_expr_ref` (the plain version the wrapper runs for CPU tensors,
    and `TorchBackend.chop_expr`) against the JAX package's
    `repro.precision.chop` applied to the same expression, for every
    form, all seven format ids, the float32 and float64 carriers, and
    the broadcast shapes of the solver's call sites
    (`kernels.chop.checks.expr_cases`), with signed zeros, infinities,
    NaN, each format's largest value and its neighbours, and division by
    zero. Bit for bit, every NaN read as one NaN; the JAX side is left
    out where an operand, an intermediate or the result is a carrier
    subnormal, which XLA on the CPU flushes to zero (in float32 and
    float64 alike).
  * The live ranges and output views (an aliased `a`, strided views) on
    the same operands, against the chain of torch operations and plain
    roundings each replaces.
  * The route table `chop_route` and the layout `expr_layout` the kernel
    reads the operands by: on the CPU, a strided read of each operand's
    storage with those strides equals the operand broadcast to the
    result, and `vector_ready` holds exactly for dense (or scalar),
    16-byte aligned operands.
  * The solver's call sites: a recording `TorchBackend` on one strict
    and one blocked `gmres_ir` solve, and on one of each of `cg_ir`,
    shows each listed site calling
    `chop_expr` (by module, form, output view and live range), the same
    number of roundings as the same solve through plain `chop`, and the
    six fields of the solve bit for bit those of that solve.

The kernel itself is held against `chop_expr_ref` on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""
import collections
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.precision import FORMAT_LIST
from repro.precision import chop as jchop
from repro_torch.data.matrices import randsvd_dense, sparse_spd
from repro_torch.kernels.chop import (ARITY, BLOCK_MAX, FORMS, chop_expr_op,
                                      chop_expr_ref, chop_route)
from repro_torch.kernels.chop.checks import (expr_cases, live_ranges,
                                             out_views, same_bits_any_nan)
from repro_torch.kernels.chop.ops import expr_layout, vector_ready
from repro_torch.precision import TorchBackend, chop
from repro_torch.solvers import BlockingPolicy, CGConfig, IRConfig
from repro_torch.solvers.cg import _cg_ir_impl
from repro_torch.solvers.ir import _gmres_ir_impl

FMT_IDS = list(range(len(FORMAT_LIST)))
CARRIERS = {"float32": torch.float32, "float64": torch.float64}
SIZES = (40, 300)       # 300: every pair of special values in a and b


def _jax_form(form, a, b, c, fid):
    r = lambda x: jchop(x, fid)     # noqa: E731
    return {"x": lambda: r(a), "add": lambda: r(a + b),
            "sub": lambda: r(a - b), "mul": lambda: r(a * b),
            "div": lambda: r(a / b), "sub_mul": lambda: r(a - r(b * c)),
            "sub_div": lambda: r(r(a - b) / c),
            "add_mul": lambda: r(a + r(b * c))}[form]()


@functools.lru_cache(maxsize=None)
def _jax_expr(form):
    return jax.jit(lambda a, b, c, fid: _jax_form(form, a, b, c, fid))


def _chain(form, a, b, c, fid):
    """The torch operations and plain roundings a form replaces, and the
    intermediates the reference may flush (all of the carrier)."""
    if form == "x":
        return chop(a, fid), []
    if form == "sub_mul":
        p = b * c
        q = a - chop(p, fid)
        return chop(q, fid), [p, chop(p, fid), q]
    if form == "sub_div":
        d = a - b
        q = chop(d, fid) / c
        return chop(q, fid), [d, chop(d, fid), q]
    if form == "add_mul":
        p = b * c
        q = a + chop(p, fid)
        return chop(q, fid), [p, chop(p, fid), q]
    v = {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b}[form]
    return chop(v, fid), [v]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32 if x.dtype == torch.float32
                               else torch.int64)


def _subnormal(x: torch.Tensor) -> torch.Tensor:
    return (x != 0) & (x.abs() < torch.finfo(x.dtype).tiny)


def _operands(form, a, b, c):
    return (a, b, c)[:ARITY[form]] + (None,) * (3 - ARITY[form])


@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("fid", FMT_IDS)
@pytest.mark.parametrize("form", FORMS)
def test_chop_expr_ref_matches_reference(form, fid, carrier):
    dtype = CARRIERS[carrier]
    bk = TorchBackend()
    got, flat, keep = [], [], []
    for name, *ops in expr_cases(fid, seed=fid, dtype=dtype, sizes=SIZES):
        a, b, c = _operands(form, *ops)
        out = chop_expr_ref(form, a, b, c, fmt_id=fid)
        used = ops[:ARITY[form]]
        shape = torch.broadcast_shapes(*(t.shape for t in used))
        assert out.shape == shape and out.dtype == dtype, name
        assert torch.equal(_bits(chop_expr_op(form, a, b, c, fmt_id=fid)),
                           _bits(out)), name
        assert same_bits_any_nan(bk.chop_expr(form, a, b, c, fmt_id=fid),
                                 out), name
        full = [t.expand(shape).reshape(-1) for t in used]
        full += [torch.zeros_like(full[0])] * (3 - len(full))
        chain, mids = _chain(form, *full, fid)
        assert same_bits_any_nan(chain, out.reshape(-1)), name
        bad = _subnormal(chain)
        for t in full[:len(used)] + mids:
            bad |= _subnormal(t)
        got.append(out.reshape(-1))
        flat.append(full)
        keep.append(~bad)
    got, keep = torch.cat(got), torch.cat(keep)
    a, b, c = (jnp.asarray(torch.cat(ts).numpy()) for ts in zip(*flat))
    want = torch.from_numpy(np.array(_jax_expr(form)(a, b, c, fid)))
    assert int(keep.sum()) > 0.6 * keep.numel()
    assert same_bits_any_nan(got[keep], want[keep])


@pytest.mark.parametrize("form", FORMS)
def test_live_ranges_and_output_views(form):
    """A live range stores +0 outside [lo, hi) and the form's value inside
    (`torch.where(live, value, 0)`, the substitutions' masked products);
    an output view (a itself, every other element of a wider buffer, a
    transposed matrix) receives exactly the fresh result. The wrapper's
    CPU path is the plain version."""
    fid = 2
    for name, *ops in expr_cases(fid, seed=3, sizes=(40,)):
        a, b, c = _operands(form, *ops)
        want = chop_expr_ref(form, a, b, c, fmt_id=fid)
        if want.ndim == 1:
            n = want.shape[0]
            idx = torch.arange(n)
            for lo, hi in live_ranges(n):
                got = chop_expr_op(form, a, b, c, fmt_id=fid, live=(lo, hi))
                masked = torch.where((idx >= lo) & (idx < hi), want,
                                     torch.zeros(()))
                assert torch.equal(_bits(got), _bits(masked)), (name, lo, hi)
        for view, out in out_views(tuple(want.shape), want):
            got = chop_expr_op(form, a, b, c, fmt_id=fid, out=out)
            assert got is out and torch.equal(_bits(out), _bits(want)), \
                (name, view)
        if a.shape == want.shape:
            mine = a.clone()
            ops_ = [mine] + [t for t in (b, c) if t is not None]
            got = chop_expr_op(form, *ops_, fmt_id=fid, out=mine)
            assert got is mine and torch.equal(_bits(mine), _bits(want)), \
                (name, "aliased")


@pytest.mark.parametrize("numel,aligned,form,route", [
    (1, True, "x", "block"), (1, False, "sub_mul", "block"),
    (BLOCK_MAX, True, "mul", "block"),
    (BLOCK_MAX, False, "sub_div", "block"),
    (BLOCK_MAX + 1, True, "x", "vector"),
    (BLOCK_MAX + 1, True, "sub_mul", "vector"),
    (BLOCK_MAX + 1, False, "add", "strided"),
    (BLOCK_MAX + 1, False, "sub_mul", "strided"),
    (512, True, "div", "vector"),
    (512 * 512, True, "x", "vector"),
    (448 * 448, False, "sub_mul", "strided"),
])
def test_chop_route_table(numel, aligned, form, route):
    assert chop_route(numel, aligned, form) == route


def test_chop_route_refuses_an_unknown_form():
    with pytest.raises(ValueError, match="form"):
        chop_route(10, True, "pow")


def test_expr_layout_reads_the_broadcast_operands():
    """The strides `expr_layout` gives each operand, read from the
    operand's own storage over the (M, N) result, are the operand
    broadcast to the result; `vector_ready` holds only for operands
    dense in the result's layout (or scalars) at 16-byte aligned
    addresses; the cases take every route."""
    seen = collections.Counter()
    for name, *ops in expr_cases(3, seed=1, sizes=(40, 300, 4099)):
        shape, M, N, strides = expr_layout(ops)
        assert tuple(shape) == tuple(torch.broadcast_shapes(
            *(t.shape for t in ops)))
        for t, (s0, s1) in zip(ops, strides):
            read = t.as_strided((M, N), (s0, s1), t.storage_offset())
            assert torch.equal(_bits(read),
                               _bits(t.expand(shape).reshape(M, N))), name
        dense = all(s == (0, 0) or (s[1] == 1 and (M == 1 or s[0] == N))
                    for s in strides)
        on16 = all(s == (0, 0) or t.data_ptr() % 16 == 0
                   for t, s in zip(ops, strides))
        ptrs = [t.data_ptr() for t in ops]
        assert vector_ready(ptrs, strides, M, N) == (dense and on16), name
        seen[chop_route(M * N, dense and on16, "sub_mul")] += 1
    assert set(seen) == {"block", "vector", "strided"}


def test_chop_expr_rejects_what_the_kernel_cannot_take():
    x = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        chop_expr_op("mul", x, x, fmt_id=2)
    one = torch.ones(4)
    for form, ops in (("pow", (one, one)), ("mul", (one,)),
                      ("x", (one, one)), ("sub_mul", (one, one)),
                      ("add", (None, one))):
        with pytest.raises(ValueError, match="form"):
            chop_expr_op(form, *ops, fmt_id=2)
    with pytest.raises(ValueError, match="live"):
        chop_expr_ref("mul", torch.ones(2, 2), one[:2], fmt_id=2,
                      live=(0, 1))
    with pytest.raises(ValueError, match="live"):
        chop_expr_ref("x", one, fmt_id=2, live=(-1, 2))
    with pytest.raises(ValueError, match="shape"):
        chop_expr_ref("add", one, one, fmt_id=2, out=torch.empty(5))


# --- the solver's call sites --------------------------------------------

# (module, form, into an output view, with a live range) of every site
# that rounds through `chop_expr`.
STRICT_SITES = {
    ("triangular.py", "mul", False, True),      # masked products
    ("triangular.py", "sub", True, False),      # y[i]
    ("triangular.py", "sub_div", True, False),  # x[i]
    ("gmres.py", "div", False, False),          # V[0], V[j + 1]
    ("gmres.py", "mul", False, False),          # w v, Givens, V y
    ("gmres.py", "sub_mul", True, False),       # w in place
    ("gmres.py", "mul", False, True),           # masked products
    ("gmres.py", "sub_div", True, False),       # y[row]
    ("lu.py", "div", True, False),              # the factors, in place
    ("lu.py", "sub_mul", True, False),          # the rank-1 update
    ("ir.py", "sub", False, False),             # the residual
    ("ir.py", "add", False, False),             # x + z
}
# Blocked: the substitutions are one `chop_trisolve` each; the LU adds
# U12's rows and the trailing block, in place.
BLOCKED_SITES = {s for s in STRICT_SITES if s[0] != "triangular.py"} | {
    ("lu.py", "sub", True, False)}
BLOCKING = BlockingPolicy(min_n=16, lu_block=16, trisolve_block=16)


# CG-IR: the refinement loop is ir.py's (`ir._refine`); cg.py rounds the
# dots' products, alpha and beta, r - chop(alpha q) and the two
# chop(a + chop(b c)) updates of z and p.
CG_STRICT_SITES = {s for s in STRICT_SITES if s[0] != "gmres.py"} | {
    ("cg.py", "mul", False, False),             # the dots' products
    ("cg.py", "div", False, False),             # alpha, beta
    ("cg.py", "sub_mul", False, False),         # r - chop(alpha q)
    ("cg.py", "add_mul", False, False),         # z, p
}
CG_BLOCKED_SITES = {s for s in CG_STRICT_SITES
                    if s[0] != "triangular.py"} | {
    ("lu.py", "sub", True, False)}


@dataclasses.dataclass(frozen=True)
class RecordingBackend(TorchBackend):
    """TorchBackend that counts its roundings: `chop_expr` by (module of
    the caller, form, output view, live range), and every rounding. With
    `fused` False its `chop_expr` is the chain it replaces: torch's
    operations and plain `chop`, `torch.where` for the live range, an
    index assignment for the output view."""

    fused: bool = True
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def chop(self, x, fmt_id):
        self.calls["rounding"] += 1
        return super().chop(x, fmt_id)

    def chop_expr(self, form, a, b=None, c=None, *, fmt_id, out=None,
                  live=None):
        caller = os.path.basename(sys._getframe(1).f_code.co_filename)
        self.calls[(caller, form, out is not None, live is not None)] += 1
        if self.fused:
            self.calls["rounding"] += 2 if form in ("sub_mul", "sub_div",
                                                    "add_mul") else 1
            return super().chop_expr(form, a, b, c, fmt_id=fmt_id, out=out,
                                     live=live)
        r = {"x": lambda: self.chop(a, fmt_id),
             "add": lambda: self.chop(a + b, fmt_id),
             "sub": lambda: self.chop(a - b, fmt_id),
             "mul": lambda: self.chop(a * b, fmt_id),
             "div": lambda: self.chop(a / b, fmt_id),
             "sub_mul": lambda: self.chop(a - self.chop(b * c, fmt_id),
                                          fmt_id),
             "sub_div": lambda: self.chop(self.chop(a - b, fmt_id) / c,
                                          fmt_id),
             "add_mul": lambda: self.chop(a + self.chop(b * c, fmt_id),
                                          fmt_id)}[form]()
        if live is not None:
            # The last dimension: the solvers' results carry the batch
            # as dim 0.
            idx = torch.arange(r.shape[-1])
            r = torch.where((idx >= live[0]) & (idx < live[1]), r,
                            torch.zeros((), dtype=r.dtype))
        if out is None:
            return r
        out[...] = r
        return out


def _recorded_solves(impl, cfg, s, action):
    """The solve through the recording backend, fused and as the chains
    the forms replace: {fused: (stats, calls)}."""
    runs = {}
    for fused in (True, False):
        bk = RecordingBackend(carrier_dtype=torch.float32, fused=fused)
        A, b, x = (torch.as_tensor(t, dtype=torch.float32)
                   for t in (s.A, s.b, s.x_true))
        runs[fused] = (impl(A, b, x, action, cfg, bk), bk.calls)
    return runs


def _check_recorded(runs, want_sites):
    (fused_stats, fused_calls), (plain_stats, plain_calls) = \
        runs[True], runs[False]
    sites = {k for k in fused_calls if k != "rounding"}
    assert sites == want_sites
    assert {k for k in plain_calls if k != "rounding"} == sites
    # The same roundings, as many as the chains the forms replace.
    assert fused_calls["rounding"] == plain_calls["rounding"]
    for field, got, want in zip(fused_stats._fields, fused_stats,
                                plain_stats):
        assert torch.equal(got, want), field
    return fused_stats


@pytest.mark.parametrize("path", ["strict", "blocked"])
def test_solver_sites_round_through_chop_expr(path):
    s = randsvd_dense(24, 1e3, np.random.default_rng(5))
    cfg = IRConfig(tau=1e-6, i_max=3, m_max=8,
                   **({"blocking": BLOCKING} if path == "blocked" else {}))
    runs = _recorded_solves(_gmres_ir_impl, cfg, s, [2, 4, 3, 5])
    stats = _check_recorded(runs, STRICT_SITES if path == "strict"
                            else BLOCKED_SITES)
    assert int(stats.n_gmres) > 0


@pytest.mark.parametrize("path", ["strict", "blocked"])
def test_cg_sites_round_through_chop_expr(path):
    s = sparse_spd(24, 0.05, np.random.default_rng(5), 1e3)
    cfg = CGConfig(tau=1e-6, i_max=3, m_max=8,
                   **({"blocking": BLOCKING} if path == "blocked" else {}))
    runs = _recorded_solves(_cg_ir_impl, cfg, s, [2, 4, 3, 5])
    stats = _check_recorded(runs, CG_STRICT_SITES if path == "strict"
                            else CG_BLOCKED_SITES)
    assert int(stats.n_cg) > 0
