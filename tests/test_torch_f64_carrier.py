"""The float64 carrier of the torch port's CUDA path, on the CPU.

No kernel runs here (the card tests in test_torch_cuda.py hold the
float64 kernels against their plain versions); what the CPU can hold:

  * the kernels' format arguments per carrier (`library.fmt_args`)
    against the JAX package's FMT_XMAX_BITS32 / FMT_XMAX_BITS64;
  * the chop kernel's packed launch arguments: what `chop_expr_op` packs
    (`ops._ARGS`, captured at the C call) read back through the layout of
    `ExprArgs` parsed from csrc/chop.cu and laid out by ctypes with C's
    alignment, its size that of the source's static_assert;
  * the GEMM's float64 route table (`ROUTES_F64`: the DFMA kernel for
    every format id), the float32 one unchanged, and the trisolve's
    shared memory on float64 (the "shfl" route takes the solver's block
    128 up to n_pad 4096);
  * `backend_for` and `CudaBackend` on each carrier (the CUDA check
    stubbed: nothing is launched);
  * `chop_f32` and `chop_f64` of csrc/chop_core.cuh compiled for the host
    (scripts/chop_host_check.py), bit for bit against `_chop_core` on
    every exponent field and every format's edges;
  * whole float64 solves at the paper's condition numbers, against the
    JAX package under x64: GMRES-IR on `randsvd_dense` systems at kappa
    1e8, 1e9 and 1e10, CG-IR on `generate_sparse_set`'s defaults (log10
    kappa 8..10), n = 24 (the strict path), under the all-fp64 action
    and the mixed action (fp32, fp32, fp64, fp64). Held bit for bit in
    every field but nbe, and nbe within rtol 4 eps (its denominator
    `normA * ||x|| + ||b||` may be an FMA in XLA, ROADMAP.md Queue 3).
    The one exception is GMRES with u_g = fp64 where its Givens step
    runs unrounded: XLA:CPU contracts the reference's rotation and norm
    into FMAs (traced in test_torch_gmres_ir.py), which changes the
    iterates' last bits and, at these kappas, the refinement's path.
    There the status is held equal, ferr within 4 kappa_est eps (the
    forward error's sensitivity to one rounding of the correction) and
    nbe below 4 eps in both; the iteration counts may differ.

The JAX side compiles one program a solver (the action is a runtime
argument), shared by the cases.
"""
import ctypes
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.data.matrices import generate_sparse_set as jsparse_set
from repro.data.matrices import pad_system
from repro.data.matrices import randsvd_dense as jrandsvd
from repro.precision import JnpBackend
from repro.precision.chop import FMT_XMAX_BITS32, FMT_XMAX_BITS64
from repro.solvers import IRConfig as JIRConfig
from repro.solvers import gmres_ir as jgmres_ir
from repro.solvers.cg import CGConfig as JCGConfig
from repro.solvers.cg import cg_ir as jcg_ir
from repro_torch.kernels import library
from repro_torch.kernels.chop import ops as chop_ops
from repro_torch.kernels.qmatmul import ROUTES, ROUTES_F64
from repro_torch.kernels.trisolve import ops as tri_ops
from repro_torch.precision import FORMAT_LIST, backend_for
from repro_torch.precision.backend import CudaBackend, TorchBackend
from repro_torch.solvers import (CONVERGED, CGConfig, IRConfig, cg_ir,
                                 gmres_ir)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMT_IDS = list(range(len(FORMAT_LIST)))
EPS = float(np.finfo(np.float64).eps)


@pytest.mark.parametrize("fid", FMT_IDS)
def test_format_arguments_per_carrier(fid):
    f = FORMAT_LIST[fid]
    for dtype, xmax in ((torch.float32, FMT_XMAX_BITS32),
                        (torch.float64, FMT_XMAX_BITS64)):
        assert library.fmt_args(fid, dtype) == (
            f.t, f.emin, int(xmax[fid]), int(f.saturate))
    assert library.fmt_args(fid) == library.fmt_args(fid, torch.float32)


_CTYPES = {"long long": ctypes.c_longlong, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "uint64_t": ctypes.c_uint64}


class _Operand(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s0", ctypes.c_longlong),
                ("s1", ctypes.c_longlong)]


def _expr_args_layout():
    """`ExprArgs` of csrc/chop.cu as a ctypes structure (fields in the
    source's order, C's alignment), and the size its static_assert
    states."""
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                            "chop.cu")).read()
    body = re.search(r"struct ExprArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in body.strip().rstrip(";").split(";"):
        decl = " ".join(decl.split())
        typ, names = re.match(r"(Operand<void>|Out<void>|long long|void\*|"
                              r"int|uint64_t) (.*)", decl).groups()
        ct = _Operand if typ.endswith("<void>") else _CTYPES[typ]
        fields += [(name.strip(), ct) for name in names.split(",")]
    size = int(re.search(r"static_assert\(sizeof\(ExprArgs\) == (\d+)",
                         src).group(1))
    return type("ExprArgs", (ctypes.Structure,), {"_fields_": fields}), size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_expr_args_match_the_cuda_struct(monkeypatch, dtype):
    """The bytes `chop_expr_op` hands the C entry, read as the C struct:
    every field where the kernel looks for it, xmax_bits in 64 bits."""
    layout, size = _expr_args_layout()
    assert ctypes.sizeof(layout) == size == chop_ops._ARGS.size
    captured = {}

    def call_packed(name, kernel, dev, addr):
        captured["bytes"] = ctypes.string_at(addr, chop_ops._ARGS.size)
    monkeypatch.setattr(chop_ops, "_check_tensors",
                        lambda ts: (0, ts[0].dtype))
    monkeypatch.setattr(library, "raw_stream", lambda dev: 0x5151)
    monkeypatch.setattr(library, "call_packed", call_packed)
    monkeypatch.setattr(library, "count_launch", lambda *a: None)
    # `a` on the meta device takes the kernel's path; the others are CPU
    # tensors, whose addresses the struct carries.
    a = torch.empty(300, dtype=dtype, device="meta")
    b, c = torch.zeros((), dtype=dtype), torch.zeros(300, dtype=dtype)
    out = torch.zeros(600, dtype=dtype)[::2]
    got = chop_ops.chop_expr_op("sub_mul", a, b, c, fmt_id=1, out=out,
                                live=(3, 290))
    assert got is out
    s = layout.from_buffer_copy(captured["bytes"])
    f = FORMAT_LIST[1]
    xmax = (FMT_XMAX_BITS64 if dtype == torch.float64
            else FMT_XMAX_BITS32)[1]
    assert (s.form, s.route, s.t, s.emin, s.xmax_bits, s.saturate,
            s.dtype) == (chop_ops.FORMS.index("sub_mul"),
                         chop_ops.ROUTES.index("strided"), f.t, f.emin,
                         int(xmax), int(f.saturate),
                         chop_ops.DTYPE_CODES[dtype])
    assert (s.M, s.N, s.lo, s.hi, s.stream) == (1, 300, 3, 290, 0x5151)
    assert (s.a.s0, s.a.s1, s.b.s0, s.b.s1, s.c.s1) == (0, 1, 0, 0, 1)
    assert (s.b.p, s.c.p, s.out.p) == (b.data_ptr(), c.data_ptr(),
                                       out.data_ptr())
    assert (s.out.s0, s.out.s1) == (0, 2)


def test_gemm_and_trisolve_routes_on_float64():
    assert ROUTES_F64 == {fid: (torch.float64, "dfma") for fid in FMT_IDS}
    assert {fid: kind for fid, (_, kind) in ROUTES.items()} == {
        0: "wgmma", 1: "wgmma", 2: "wgmma", 3: "wgmma", 4: "wgmma",
        5: "ffma", 6: "ffma"}
    # float64's "shfl" keeps its diagonal blocks packed: the solver's
    # block of 128 fits at every bucket up to 4096, float32's layout
    # would not.
    for n in (128, 512, 4096):
        assert tri_ops.trisolve_route(n, 128, torch.float64) == "shfl"
        assert tri_ops.smem_bytes(n, 128, "shfl", torch.float64) <= \
            tri_ops.SMEM_LIMIT
    assert 16 * 128 + 8 * (2 * 512 + 128 + 2 * 128 * 128 + 32) > \
        tri_ops.SMEM_LIMIT
    assert tri_ops.smem_bytes(512, 128, "shfl") == \
        4 * (4 * 128 + 2 * 512 + 128 + 2 * 128 * 128 + 32)
    assert library.kernel_name("trisolve", torch.float64) == "trisolve_f64"
    assert {"chop_f64", "qmv_f64", "qgemm_f64", "trisolve_f64"} <= \
        set(library.KERNELS)


def test_backend_for_each_carrier(monkeypatch):
    assert backend_for("cpu") == TorchBackend(None)
    assert backend_for("cpu", "float64").carrier_dtype == torch.float64
    assert CudaBackend().carrier_dtype == torch.float32
    assert CudaBackend(torch.float64).carrier_dtype == torch.float64
    with pytest.raises(ValueError):
        CudaBackend(torch.float16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert backend_for("cuda") == CudaBackend(torch.float32)
    assert backend_for("cuda", "float32") == CudaBackend(torch.float32)
    assert backend_for("cuda", torch.float64) == CudaBackend(torch.float64)
    assert backend_for("cuda", "float64").coerce(
        torch.ones(2, dtype=torch.float32)).dtype == torch.float64
    for bad in ("float16", torch.bfloat16):
        with pytest.raises(ValueError):
            backend_for("cuda", bad)


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs a host C++ compiler")
def test_chop_short_chains_compiled_for_the_host():
    spec = importlib.util.spec_from_file_location(
        "chop_host_check", os.path.join(ROOT, "scripts",
                                        "chop_host_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    assert mod.check(per_field=8, seed=1, out=lines.append) == 0, lines
    assert len(lines) == 2 * len(FORMAT_LIST)


N = 24
TAU = 1e-10
ALL_FP64 = [6, 6, 6, 6]
MIXED = [5, 5, 6, 6]
_SYSTEMS = {}


def _systems(solver):
    if solver not in _SYSTEMS:
        if solver == "gmres":
            _SYSTEMS[solver] = [jrandsvd(N, k, np.random.default_rng(i))
                                for i, k in enumerate((1e8, 1e9, 1e10))]
        else:
            _SYSTEMS[solver] = jsparse_set(3, np.random.default_rng(5),
                                           n_range=(N, N))
    return _SYSTEMS[solver]


def _solve_both(solver, k, action):
    s = _systems(solver)[k]
    act = np.asarray(action, np.int32)
    if solver == "gmres":
        want = jgmres_ir(s.A, s.b, s.x_true, act, JIRConfig(tau=TAU),
                         JnpBackend())
        got = gmres_ir(s.A, s.b, s.x_true, action, IRConfig(tau=TAU),
                       device="cpu", carrier_dtype="float64")
    else:
        want = jcg_ir(s.A, s.b, s.x_true, act, JCGConfig(tau=TAU),
                      JnpBackend())
        got = cg_ir(s.A, s.b, s.x_true, action, CGConfig(tau=TAU),
                    device="cpu", carrier_dtype="float64")
    return s, got, want


@pytest.mark.parametrize("action", [ALL_FP64, MIXED], ids=["fp64", "mixed"])
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("solver", ["gmres", "cg"])
def test_float64_solves_at_the_papers_kappa(solver, k, action):
    s, got, want = _solve_both(solver, k, action)
    assert 1e8 <= s.features["kappa_est"] <= 1e11
    for g in got:
        assert g.dtype in (torch.float64, torch.int32)
    if solver == "gmres" and action == ALL_FP64:
        # The reference's Givens step is XLA's to contract here.
        assert int(got.status) == int(want.status)
        tol = 4 * s.features["kappa_est"] * EPS
        assert abs(float(got.ferr) - float(want.ferr)) <= tol
        assert float(got.nbe) <= 4 * EPS and float(want.nbe) <= 4 * EPS
        return
    for field in got._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if field == "nbe":
            np.testing.assert_allclose(g, w, rtol=4 * EPS, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


def test_the_card_phase_sparse_set_against_the_reference():
    """The systems chip_smoke's phase 10 solves on the card (the paper's
    sparse generator at its defaults, log10 kappa 8..10, n 200..500)
    that fall in bucket 256 (n 201, 203, 238), identity-padded to 256:
    the blocked path, all-fp64 action. The reference converges on each;
    so does the port, with the same outer and CG iterations and ferr
    within 4 kappa_est eps (the blocked LU in fp64 is not pinned by the
    reference, ROADMAP.md Queue 3)."""
    from repro.core.batching import bucket_of
    systems = jsparse_set(8, np.random.default_rng(0), n_range=(200, 500))
    act = np.asarray(ALL_FP64, np.int32)
    picked = [s for s in systems if bucket_of(s.n, 128, 128) == 256]
    assert sorted(s.n for s in picked) == [201, 203, 238]
    for s in picked:
        A, b, x = pad_system(s, 256)
        want = jcg_ir(A, b, x, act, JCGConfig(tau=1e-6), JnpBackend())
        got = cg_ir(A, b, x, ALL_FP64, CGConfig(tau=1e-6), device="cpu",
                    carrier_dtype="float64")
        assert int(want.status) == CONVERGED
        for field in ("status", "n_outer", "n_cg"):
            assert int(getattr(got, field)) == int(getattr(want, field))
        assert abs(float(got.ferr) - float(want.ferr)) <= \
            4 * s.features["kappa_est"] * EPS


def test_the_all_fp64_baseline_resolves_the_sparse_set():
    """What the float32 carrier could not do (ROADMAP.md Queue 1, where
    these systems fail or stagnate at ferr ~0.8): the paper's sparse SPD
    systems at kappa 1e8..1e10 under the all-fp64 action reach the
    reference's status on the float64 carrier, converged or stagnated at
    the attainable accuracy."""
    for k in range(3):
        _, got, want = _solve_both("cg", k, ALL_FP64)
        assert int(got.status) == int(want.status)
        assert int(got.status) in (CONVERGED, 1)
        assert float(got.ferr) < 1e-6

