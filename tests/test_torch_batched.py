"""The batched, masked solve program of the torch port, on the CPU.

`gmres_ir_batch` and `cg_ir_batch` run the rows of a bucket as one
program, each row under its own action, as the JAX package's vmap runs
them: every rounding takes one format id per row (`precision.rows`).

  * (a) Each plain op of the backend (`chop`, every `chop_expr` form with
    output views and live ranges, `chop_mv`, `chop_matmul`,
    `chop_trisolve`, and `rounding_unit`) with all seven format ids in
    one batch, on both carriers, is bit-equal to a loop of the
    single-format op over the rows.
  * (b) Every row of a batch is bit-equal, in all six fields, to the same
    row solved at B = 1, for GMRES-IR and CG-IR, strict and blocked,
    float32 and float64. The batches mix outcomes: rows converging at
    different outer and inner counts, stagnating rows, a MAXITER row and
    an LU failure (a zero pivot), so all four statuses are present.
  * (c) Each path (strict and blocked) of each solver against the JAX
    package's `gmres_ir_batch` / `cg_ir_batch` on the same rows, held as
    the whole-solve tests hold single solves: status, n_outer and the
    inner count equal, ferr, nbe and res_norm within 4 eps of the carrier,
    on the rows whose bits the reference pins (ROADMAP.md Queue 3).
  * (d) A backend that counts its calls: a batch of 8 makes the calls of
    its longest row, not the sum over its rows.
  * The kernel wrappers' batched launch arguments, read back on the CPU:
    the chop kernel's packed struct with a batch and ids, and the GEMM's
    split of a batch by route (one launch per route present, each with
    the ids of its route in its mask).
"""
import collections
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
import repro.solvers.cg as jcg_mod
from repro.precision import JnpBackend
from repro.solvers import BlockingPolicy as JBlocking
from repro.solvers import IRConfig as JIRConfig
from repro.solvers import gmres_ir_batch as jgmres_ir_batch
from repro.solvers.cg import CGConfig as JCGConfig
from repro_torch.data.matrices import randsvd_dense, sparse_spd
from repro_torch.kernels import library
from repro_torch.kernels.chop import ARITY, FORMS
from repro_torch.kernels.chop import ops as chop_ops
from repro_torch.kernels.qmatmul import ops as qm_ops
from repro_torch.precision import (FORMAT_LIST, RowFormats, chop,
                                   rounding_unit)
from repro_torch.precision.backend import TorchBackend
from repro_torch.solvers import (CONVERGED, FAILED, MAXITER, STAGNATED,
                                 BlockingPolicy, CGConfig, IRConfig, cg_ir,
                                 cg_ir_batch, gmres_ir, gmres_ir_batch)
from repro_torch.solvers.cg import _cg_ir_impl
from repro_torch.solvers.ir import _gmres_ir_impl

FMT_IDS = list(range(len(FORMAT_LIST)))
CARRIERS = {"float32": torch.float32, "float64": torch.float64}
INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}
N = 16
BLK = dict(min_n=16, lu_block=8, trisolve_block=8)
CFG = dict(tau=1e-6, i_max=3, m_max=6)
PATHS = {"strict": {}, "blocked": {"blocking": BLK}}
# One action a row: the seven formats mixed across the roles, and the
# all-fp32 action on the row whose LU meets a zero pivot.
ACTIONS = np.array([[2, 4, 3, 5], [0, 1, 2, 3], [6, 6, 6, 6], [1, 1, 1, 1],
                    [3, 5, 4, 6], [2, 2, 2, 2], [4, 4, 4, 4], [5, 5, 5, 5]],
                   np.int32)
KAPPAS = (1e2, 1e4, 1e6, 1e8, 1e3, 1e5, 1e7, 1e1)
# CG-IR's rows (sparse SPD): narrow formats break CG down, so more rows
# keep fp32 and above.
CG_ACTIONS = np.array([[5, 5, 5, 5], [4, 5, 4, 5], [2, 3, 4, 5],
                       [1, 1, 1, 1], [3, 6, 4, 6], [2, 2, 2, 2],
                       [4, 4, 4, 4], [5, 5, 5, 5]], np.int32)
ZERO_PIVOT_ROW = 7


def _bits(t):
    if not t.is_floating_point():
        return t
    return t.contiguous().view(INT_VIEW[t.dtype])


def _same(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), what


def _ids(B, seed=0):
    """B per-row format ids holding all seven."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.permutation(FMT_IDS),
                          rng.integers(0, len(FMT_IDS), max(B - 7, 0))])
    return ids[:B].astype(np.int32)


def _values(shape, dtype, seed):
    """Values across the formats' ranges: normals of every magnitude,
    subnormals of the carrier, zeros, infinities and a NaN."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    scale = torch.exp2(torch.randint(-40, 40, shape, generator=g)
                       .to(torch.float64))
    x = (x * scale).to(dtype).reshape(-1)
    x[::17] = 0.0
    x[5::23] = float("inf")
    x[7::29] = torch.finfo(dtype).tiny / 8
    x[11::31] = float("nan")
    return x.reshape(shape)


# --- (a) the plain ops with per-row formats --------------------------------

@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_plain_ops_per_row_equal_a_loop_of_single_format_ops(carrier,
                                                             as_tensor):
    dt = CARRIERS[carrier]
    B = 9
    ids = _ids(B)
    fmt = torch.as_tensor(ids) if as_tensor else RowFormats(ids)
    bk = TorchBackend()

    x = _values((B, 5, 6), dt, 1)
    got = bk.chop(x, fmt)
    for k in range(B):
        _same(got[k], bk.chop(x[k], int(ids[k])), f"chop row {k}")

    a, c = (_values((B, 12), dt, s) for s in (2, 4))
    col = _values((B, 1), dt, 5)
    for form in FORMS:
        ops = {1: (a,), 2: (a, col), 3: (a, col, c)}[ARITY[form]]
        got = bk.chop_expr(form, *ops, fmt_id=fmt)
        live = bk.chop_expr(form, *ops, fmt_id=fmt, live=(3, 9))
        out = torch.zeros((B, 24), dtype=dt)[:, ::2]
        into = bk.chop_expr(form, *ops, fmt_id=fmt, out=out)
        assert into is out
        for k in range(B):
            one = bk.chop_expr(form, *(o[k] for o in ops),
                               fmt_id=int(ids[k]))
            _same(got[k], one, f"{form} row {k}")
            _same(out[k], one, f"{form} into a view, row {k}")
            one_live = bk.chop_expr(form, *(o[k] for o in ops),
                                    fmt_id=int(ids[k]), live=(3, 9))
            _same(live[k], one_live, f"{form} live, row {k}")

    A = _values((B, 7, 20), dt, 6)
    v = _values((B, 20), dt, 7)
    got = bk.chop_mv(A, v, fmt)
    for k in range(B):
        _same(got[k], bk.chop_mv(A[k], v[k], int(ids[k])), f"mv row {k}")

    P, Q = _values((B, 6, 10), dt, 8), _values((B, 10, 4), dt, 9)
    got = bk.chop_matmul(P, Q, fmt)
    for k in range(B):
        _same(got[k], bk.chop_matmul(P[k], Q[k], int(ids[k])),
              f"matmul row {k}")

    g = torch.Generator().manual_seed(10)
    Lu = torch.randn((B, 20, 20), generator=g, dtype=dt) + \
        4 * torch.eye(20, dtype=dt)
    rhs = torch.randn((B, 20), generator=g, dtype=dt)
    for lower in (True, False):
        got = bk.chop_trisolve(Lu, rhs, fmt, lower=lower, block=8)
        for k in range(B):
            _same(got[k], bk.chop_trisolve(Lu[k], rhs[k], int(ids[k]),
                                           lower=lower, block=8),
                  f"trisolve lower={lower} row {k}")

    got = rounding_unit(fmt, dt)
    for k in range(B):
        _same(got[k], rounding_unit(int(ids[k]), dt), f"unit row {k}")


def test_per_row_formats_refuse_a_batch_of_another_size():
    x = torch.ones((4, 3))
    with pytest.raises(ValueError, match="batch"):
        chop(x, RowFormats([1, 2, 3]))
    with pytest.raises(ValueError, match="outside"):
        RowFormats([0, 7])
    with pytest.raises(ValueError, match="live"):
        TorchBackend().chop_expr("x", torch.ones((2, 3, 4)),
                                 fmt_id=RowFormats([1, 2]), live=(0, 2))


# --- (b) every row of a batch is its B = 1 solve ---------------------------

def _systems(solver, carrier):
    """Eight rows of size N; row ZERO_PIVOT_ROW has a zero column, so
    that its LU meets a zero pivot and the row FAILS from the start."""
    rng = np.random.default_rng(11)
    if solver == "gmres":
        rows = [randsvd_dense(N, k, rng) for k in KAPPAS]
    else:
        rows = [sparse_spd(N, 0.1, rng, k) for k in KAPPAS]
    A = np.stack([s.A for s in rows])
    b = np.stack([s.b for s in rows])
    x = np.stack([s.x_true for s in rows])
    A[ZERO_PIVOT_ROW][:, 3] = 0.0
    return A, b, x, (ACTIONS if solver == "gmres" else CG_ACTIONS)


def _cfg(solver, path):
    if solver == "gmres":
        kw = dict(CFG, **({"blocking": BlockingPolicy(**BLK)}
                          if path == "blocked" else {}))
        return IRConfig(**kw)
    kw = dict(CFG, **({"blocking": BlockingPolicy(**BLK)}
                      if path == "blocked" else {}))
    return CGConfig(**kw)


SOLVE = {"gmres": (gmres_ir_batch, gmres_ir), "cg": (cg_ir_batch, cg_ir)}


@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("solver", list(SOLVE))
def test_batch_rows_equal_their_single_solves(solver, path, carrier):
    A, b, x, actions = _systems(solver, carrier)
    cfg = _cfg(solver, path)
    batch, single = SOLVE[solver]
    got = batch(A, b, x, actions, cfg, device="cpu", carrier_dtype=carrier)
    for k in range(len(A)):
        one = single(A[k], b[k], x[k], actions[k], cfg, device="cpu",
                     carrier_dtype=carrier)
        for field, g, o in zip(got._fields, got, one):
            assert g.shape == (len(A),), field
            _same(g[k], o, f"row {k} {field}")
    status = got.status.tolist()
    assert status[ZERO_PIVOT_ROW] == FAILED
    assert int(got.n_outer[ZERO_PIVOT_ROW]) == 0
    assert {CONVERGED, STAGNATED, MAXITER, FAILED} <= set(status), status
    # Rows end at different outer and inner counts.
    assert len(set(got.n_outer.tolist())) >= 3
    assert len(set(got[3].tolist())) >= 4


# --- (c) against the JAX package's vmapped batch ---------------------------

def _pinned(path, carrier, action, solver):
    """Rows whose bits the reference pins (ROADMAP.md Queue 3): the
    blocked LU only in a format narrower than the carrier, GMRES on the
    float64 carrier only with u_g below fp64."""
    t_carrier = 24 if carrier == "float32" else 53
    if path == "blocked" and FORMAT_LIST[action[0]].t >= t_carrier:
        return False
    return not (solver == "gmres" and carrier == "float64"
                and action[2] == 6)


REF_CASES = [("gmres", "strict", "float64"), ("gmres", "blocked", "float32"),
             ("cg", "strict", "float32"), ("cg", "blocked", "float64")]


@pytest.mark.parametrize("solver, path, carrier", REF_CASES)
def test_batch_matches_the_reference_batch(solver, path, carrier):
    A, b, x, actions = _systems(solver, carrier)
    bk = JnpBackend(carrier_dtype="float32" if carrier == "float32"
                    else None)
    blocking = JBlocking(**BLK) if path == "blocked" else JBlocking()
    if solver == "gmres":
        want = jgmres_ir_batch(A, b, x, actions,
                               JIRConfig(**CFG, blocking=blocking), bk)
    else:
        want = jcg_mod.cg_ir_batch(A, b, x, actions,
                                   JCGConfig(**CFG, blocking=blocking), bk)
    got = SOLVE[solver][0](A, b, x, actions, _cfg(solver, path),
                           device="cpu", carrier_dtype=carrier)
    rtol = 4 * float(np.finfo(carrier).eps)
    held = 0
    for k in range(len(A)):
        if not _pinned(path, carrier, actions[k], solver):
            continue
        for i in (2, 3, 4):         # n_outer, the inner count, status
            assert int(got[i][k]) == int(np.asarray(want[i])[k]), \
                (k, got._fields[i])
        for i in (0, 1, 5):         # ferr, nbe, res_norm
            np.testing.assert_allclose(
                float(got[i][k]), float(np.asarray(want[i])[k]), rtol=rtol,
                atol=0, err_msg=f"row {k} {got._fields[i]}")
        held += 1
    assert held >= 6


# --- (d) a batch makes its longest row's calls -----------------------------

@dataclasses.dataclass(frozen=True)
class CountingBackend(TorchBackend):
    """TorchBackend that counts its calls, by op."""

    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def chop(self, x, fmt_id):
        self.calls["chop"] += 1
        return super().chop(x, fmt_id)

    def chop_expr(self, form, a, b=None, c=None, *, fmt_id, out=None,
                  live=None):
        self.calls["chop_expr"] += 1
        return super().chop_expr(form, a, b, c, fmt_id=fmt_id, out=out,
                                 live=live)

    def chop_mv(self, A, v, fmt_id, *, chop_output=True):
        self.calls["chop_mv"] += 1
        return super().chop_mv(A, v, fmt_id, chop_output=chop_output)

    def chop_matmul(self, a, b, fmt_id, *, chop_output=True):
        self.calls["chop_matmul"] += 1
        return super().chop_matmul(a, b, fmt_id, chop_output=chop_output)

    def chop_trisolve(self, Lu, b, fmt_id, *, lower, block=128):
        self.calls["chop_trisolve"] += 1
        return super().chop_trisolve(Lu, b, fmt_id, lower=lower,
                                     block=block)


def _counted(impl, A, b, x, actions, cfg):
    bk = CountingBackend(carrier_dtype=torch.float32)
    t = [torch.as_tensor(v, dtype=torch.float32) for v in (A, b, x)]
    stats = impl(*t, actions, cfg, bk)
    return stats, bk.calls


@pytest.mark.parametrize("solver", ["gmres", "cg"])
@pytest.mark.parametrize("path", list(PATHS))
def test_a_batch_makes_the_calls_of_its_longest_row(solver, path):
    """One ill-conditioned row under bf16 and seven well-conditioned rows
    under wider formats, chosen so that one row is the longest in every
    outer iteration (its refinement and each of its inner solves run at
    least as long as any other row's): the batch makes exactly that row's
    calls, op by op, not the sum over the eight."""
    rng = np.random.default_rng(3)
    make = randsvd_dense if solver == "gmres" else \
        (lambda n, k, r: sparse_spd(n, 0.1, r, k))
    rows = [make(N, 1e6, rng)] + [make(N, 10.0, rng) for _ in range(7)]
    A = np.stack([s.A for s in rows])
    b = np.stack([s.b for s in rows])
    x = np.stack([s.x_true for s in rows])
    actions = np.array([[2, 2, 2, 2]] + [[4, 5, 5, 5], [6, 6, 6, 6],
                                         [6, 6, 5, 6], [4, 6, 5, 6],
                                         [5, 6, 6, 6], [6, 5, 5, 5],
                                         [5, 5, 5, 6]], np.int32)
    impl = _gmres_ir_impl if solver == "gmres" else _cg_ir_impl
    cfg = _cfg(solver, path)
    stats, calls = _counted(impl, A, b, x, actions, cfg)
    single = [_counted(impl, A[k], b[k], x[k], actions[k], cfg)
              for k in range(len(A))]
    per_row = [sum(c.values()) for _, c in single]
    longest = int(np.argmax(per_row))
    assert calls == single[longest][1]
    assert sum(calls.values()) == max(per_row) < sum(per_row)
    for k, (one, _) in enumerate(single):
        for field, g, o in zip(stats._fields, stats, one):
            _same(g[k], o, f"row {k} {field}")


# --- the kernel wrappers' batched launch arguments -------------------------

class _Operand(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong)]


class _ExprArgs(ctypes.Structure):
    """csrc/chop.cu `ExprArgs` (its field order; test_torch_f64_carrier.py
    parses the source's own declaration)."""
    _fields_ = ([(n, _Operand) for n in ("a", "b", "c", "out")]
                + [(n, ctypes.c_longlong) for n in
                   ("M", "N", "lo", "hi", "B", "a_b", "b_b", "c_b",
                    "out_b")]
                + [(n, ctypes.c_void_p) for n in ("stream", "ids", "table")]
                + [(n, ctypes.c_int) for n in ("form", "route", "t",
                                               "emin")]
                + [("xmax_bits", ctypes.c_uint64), ("saturate", ctypes.c_int),
                   ("dtype", ctypes.c_int)])


@pytest.mark.parametrize("dtype", list(CARRIERS.values()))
def test_chop_packs_a_batch_with_its_ids(monkeypatch, dtype):
    """The batched launch's struct: B rows of (M, N), each operand's batch
    stride (0 for one the rows share), the ids' pointer and the carrier's
    format table; a live range on the last dimension."""
    assert ctypes.sizeof(_ExprArgs) == chop_ops._ARGS.size
    captured = {}

    def call_packed(name, kernel, dev, addr):
        captured["bytes"] = ctypes.string_at(addr, chop_ops._ARGS.size)
    monkeypatch.setattr(chop_ops, "_check_tensors",
                        lambda ts: (0, ts[0].dtype))
    monkeypatch.setattr(library, "raw_stream", lambda dev: 0x5151)
    monkeypatch.setattr(library, "call_packed", call_packed)
    monkeypatch.setattr(library, "count_launch", lambda *a: None)
    monkeypatch.setattr(library, "row_args", lambda fid, rows, dt, dev: (
        library.fmt_args(int(rows.host[0]), dt), 0xA1D5,
        library.format_table(dt)))
    rows = RowFormats([3, 0, 6, 1, 2])
    a = torch.empty((5, 60), dtype=dtype, device="meta")
    b = torch.zeros((5, 1), dtype=dtype)
    c = torch.zeros((60,), dtype=dtype)
    out = torch.zeros((5, 120), dtype=dtype)[:, ::2]
    chop_ops.chop_expr_op("sub_mul", a, b, c, fmt_id=rows, out=out,
                          live=(2, 30))
    s = _ExprArgs.from_buffer_copy(captured["bytes"])
    assert (s.B, s.M, s.N, s.lo, s.hi) == (5, 1, 60, 2, 30)
    assert (s.a_b, s.a.s0, s.a.s1) == (60, 0, 1)
    assert (s.b_b, s.b.s0, s.b.s1) == (1, 0, 0)
    assert (s.c_b, s.c.s0, s.c.s1) == (0, 0, 1)
    assert (s.out_b, s.out.s0, s.out.s1) == (120, 0, 2)
    assert (s.ids, s.table) == (0xA1D5, library.format_table(dtype))
    assert s.route == chop_ops.ROUTES.index("strided")
    # A batch of matrices (the solver's chop of A) is one launch of B
    # rows of (M, N), dense: the vector route.
    chop_ops.chop_op(torch.empty((5, 6, 64), dtype=dtype, device="meta"),
                     rows)
    s = _ExprArgs.from_buffer_copy(captured["bytes"])
    assert (s.B, s.M, s.N, s.lo, s.hi) == (5, 1, 6 * 64, 0, 5 * 6 * 64)
    assert s.route == chop_ops.ROUTES.index("vector")
    assert (s.a_b, s.a.s1, s.out_b, s.out.s1) == (0, 1, 0, 1)
    # The table: every format id's parameters on this carrier.
    row = library._ROW
    raw = ctypes.string_at(library.format_table(dtype), row.size * 7)
    for fid in FMT_IDS:
        assert row.unpack_from(raw, fid * row.size)[:4] == \
            library.fmt_args(fid, dtype)


def test_gemm_splits_a_batch_by_route(monkeypatch):
    """Per-row formats on the float32 carrier: one launch per route the
    rows take (bf16 tensor cores for e5m2/e4m3/bf16, fp16, tf32, FFMA
    for fp32/fp64), each over the whole batch with its ids in its mask;
    one format for every row: one launch, no ids."""
    launches = []

    def call(name, kernel, t, *args):
        launches.append(args)
    monkeypatch.setattr(library, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(library, "call", call)
    monkeypatch.setattr(library, "count_launch", lambda *a: None)
    monkeypatch.setattr(library, "row_args", lambda fid, rows, dt, dev: (
        library.fmt_args(int(fid), dt), None if rows is None else 0xA1D5,
        None if rows is None else 1))
    a = torch.empty((7, 48, 16), device="meta")
    b = torch.empty((7, 16, 48), device="meta")
    out = qm_ops.qgemm_op(a, b, RowFormats([0, 5, 3, 1, 4, 6, 2]))
    assert out.shape == (7, 48, 48)
    # (B, M, N, K) and the mask and route code of each launch.
    got = sorted((args[5:9], args[17], args[19]) for args in launches)
    assert got == sorted([((7, 48, 48, 16), 0b0000111, 1),
                          ((7, 48, 48, 16), 0b0001000, 2),
                          ((7, 48, 48, 16), 0b0010000, 3),
                          ((7, 48, 48, 16), 0b1100000, 0)])
    launches.clear()
    qm_ops.qgemm_op(a, b, RowFormats([3] * 7))
    assert len(launches) == 1
    assert (launches[0][15], launches[0][19]) == (None, 2)
