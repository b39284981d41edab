"""The CUDA kernels of the torch port against their plain versions, on the
card. Every test here needs a CUDA device and nvcc; without them each one
skips (the kernels have no CPU mode). This file imports no JAX, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX.)

Tolerances: chop (every form of `kernels.chop.FORMS`, on every route,
into fresh tensors and output views, with live ranges), qmv and
trisolve are bit-exact against their plain versions; qgemm and qmatmul may differ from theirs (library matmuls, TF32
off) by ulp_fmt(|want|) + Kp 2^-24 sum_k |a_ik||b_kj| per element, the
bound of two summation orders plus one flipped output rounding. Where
the plain version gives an infinity or a NaN, the kernel must give the
same infinity or a NaN. The GEMM is held on both of its routes (the
tensor cores for e5m2, e4m3, bf16, fp16 and tf32; the FFMA kernel, which
the wrapper takes for fp32 and fp64, for all seven ids through the
launcher's route argument), with operands in each format's subnormal
range, near its largest value and with infinities, at ragged M/N/K and
at K blocks that are not a multiple of the kernels' K tiles (the
tolerance and these operands: `kernels.qmatmul.checks`); the tensor-core
route's pack kernel is bit-exact against `pack_ref`; flash
attention is held to 2e-5 (rtol and atol) in float32, the tolerance of
the JAX package's own flash tests, and in bf16 to two bf16 ulps of each
output row's largest |want| on both of its routes, and on the wgmma
route to one ulp of `flash_tiled_ref`, the plain model of that route's
numerics (`kernels.flash_attention.checks`). A strict-path
solve on the card equals the same solve on the CPU bit for bit: every
operation on that path is pinned.

The float64 carrier (the solver kernels' float64 instantiations) is held
the same way: chop (every form, route, output view and live range), qmv
and trisolve bit for bit against their plain versions on float64, every
NaN read as one NaN (the card's float64 arithmetic keeps a NaN operand's
payload, so a NaN's bits follow the operands' order), and
qgemm (its DFMA route, `ROUTES_F64`) within the order tolerance with the
float64 unit roundoff (`checks.held`); strict float64 solves on the card
equal the CPU's bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.matrices import randsvd_dense, sparse_spd
from repro_torch.kernels import library
from repro_torch.kernels.chop import (ARITY, BLOCK_MAX, FORMS, chop_expr_op,
                                      chop_expr_ref, chop_op, chop_ref,
                                      chop_route)
from repro_torch.kernels.chop.checks import (expr_cases, live_ranges,
                                             out_views, same_bits_any_nan,
                                             to_keeping_layout)
from repro_torch.kernels.chop.ops import expr_layout, vector_ready
from repro_torch.kernels.flash_attention import ROUTES as FLASH_ROUTES
from repro_torch.kernels.flash_attention import (HEAD_DIMS, WGMMA_BK,
                                                 flash_attention_op,
                                                 flash_ref)
from repro_torch.kernels.flash_attention.checks import (flash_tiled_ref,
                                                        within_bf16_rows)
from repro_torch.kernels.qmatmul import (qgemm_op, qgemm_ref, qmatmul_op,
                                         qmatmul_ref_blocked, qmv_op, qmv_ref)
from repro_torch.kernels.qmatmul.checks import (SPECIAL_KINDS,
                                                float32_patterns,
                                                float64_patterns, held,
                                                pack_equal, special_operands,
                                                ulp_fmt)
from repro_torch.kernels.qmatmul.ops import ROUTES, ROUTES_F64, _gemm, _pack
from repro_torch.kernels.lanes import SPECIAL_KINDS as SPECIAL_MATVEC
from repro_torch.kernels.lanes import special_matvec
from repro_torch.kernels.trisolve import ROUTES as TRISOLVE_ROUTES
from repro_torch.kernels.trisolve import (trisolve_op, trisolve_ref,
                                          trisolve_route)
from repro_torch.kernels.trisolve.checks import special_system
from repro_torch.precision import FORMAT_LIST, chop
from repro_torch.solvers import CGConfig, IRConfig, cg_ir, gmres_ir

FMT_IDS = list(range(len(FORMAT_LIST)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_chop_kernel_bitexact(cuda_device, fid):
    x = float32_patterns(fid).to(cuda_device)
    for shape in ((x.numel(),), (128, 128), (1,)):
        xs = x[:int(np.prod(shape))].reshape(shape).contiguous()
        got, want = chop_op(xs, fid), chop_ref(xs, fid)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _same_bits(got, want):
    torch.cuda.synchronize()
    if got.dtype != want.dtype:
        return False
    itype = torch.int64 if got.dtype == torch.float64 else torch.int32
    return torch.equal(got.view(itype), want.view(itype))


CHOP_SIZES = (1, 5, BLOCK_MAX, BLOCK_MAX + 3, 4096, 4099, 65536 + 1,
              600_001)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_chop_kernel_routes_bitexact(cuda_device, fid):
    """The plain rounding on every route ("block" up to BLOCK_MAX
    elements, "vector" on 16-byte aligned tensors, "strided" at any
    size), at sizes on both sides of the route bounds, with and without
    a tail of n mod 4, on a view off 16-byte alignment too (the vector
    route refuses it), over every float32 exponent field and the special
    values."""
    pats = float32_patterns(fid)
    reps = -(-(max(CHOP_SIZES) + 1) // pats.numel())
    base = pats.repeat(reps)[torch.randperm(
        pats.numel() * reps, generator=torch.Generator().manual_seed(fid))]
    base = base.to(cuda_device)
    for n in CHOP_SIZES:
        for x in (base[:n], base[1:n + 1]):
            # A single element is a scalar to the vector route, at any
            # address.
            aligned = n == 1 or x.data_ptr() % 16 == 0
            want = chop_ref(x, fid)
            routes = ["strided"] + (["block"] if n <= BLOCK_MAX else []) \
                + (["vector"] if aligned else [])
            for route in [None] + routes:
                got = chop_op(x, fid, route=route)
                assert _same_bits(got, want), (n, aligned, route)
            if not aligned:
                with pytest.raises(ValueError):
                    chop_op(x, fid, route="vector")
    with pytest.raises(ValueError):
        chop_op(base[:BLOCK_MAX + 1], fid, route="block")


def _routes_taking(ops, out, M, N):
    """Every route that takes these operands and output."""
    ptrs = [t.data_ptr() for t in (*ops, out)]
    strides = expr_layout((*ops, out))[3]
    return ["strided"] + (["block"] if M * N <= BLOCK_MAX else []) + (
        ["vector"] if vector_ready(ptrs, strides, M, N) else [])


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
@pytest.mark.parametrize("form", FORMS)
def test_chop_expr_kernel_bitexact(cuda_device, form, fid):
    """Every form against the plain version on the same CUDA tensors
    (torch's operations, then the plain chop), bit for bit: the call
    sites' broadcast shapes (`kernels.chop.checks.expr_cases`: 0-dim
    operands, 0-dim with vectors, vectors, a matrix with a column and a
    row, an outer product, matrices, a strided view, a broadcast row,
    views off 16-byte alignment) with the special operands and division
    by zero, at sizes on both sides of the route bounds; into a fresh
    tensor, into output views (contiguous, every other element of a
    wider buffer, transposed, and `a` itself) and, for a vector result,
    with every live range of `live_ranges`; each on the route
    `chop_route` gives and forced onto every route that takes it."""
    cases = expr_cases(fid, seed=10 + fid,
                       sizes=(40, 128, BLOCK_MAX, 4099, 300_007))
    for name, *ops in cases:
        ops = [to_keeping_layout(t, cuda_device) for t in ops[:ARITY[form]]]
        want = chop_expr_ref(form, *ops, fmt_id=fid)
        shape, M, N, _ = expr_layout(ops)
        for route in [None] + _routes_taking(ops, want, M, N):
            got = chop_expr_op(form, *ops, fmt_id=fid, route=route)
            assert got.is_contiguous() and got.shape == want.shape, name
            assert _same_bits(got, want), (name, route)
        views = out_views(tuple(shape), want)
        if ops[0].shape == shape:
            views.append(("a itself", ops[0].clone()))
        for view, out in views:
            mine = [out] + ops[1:] if view == "a itself" else ops
            for route in _routes_taking(mine, out, M, N):
                if view == "a itself":
                    out.copy_(ops[0])
                got = chop_expr_op(form, *mine, fmt_id=fid, out=out,
                                   route=route)
                assert got is out and _same_bits(out, want), \
                    (name, view, route)
        if len(shape) == 1:
            idx = torch.arange(N, device=cuda_device)
            zero = torch.zeros((), device=cuda_device)
            for lo, hi in live_ranges(N):
                masked = torch.where((idx >= lo) & (idx < hi), want, zero)
                for route in _routes_taking(ops, want, M, N):
                    got = chop_expr_op(form, *ops, fmt_id=fid,
                                       live=(lo, hi), route=route)
                    assert _same_bits(got, masked), (name, lo, hi, route)


QMV_SIZES = (1, 31, 33, 300, 384, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "shfl", "smem"])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmv_kernel_bitexact(cuda_device, fid, route):
    """Every M and K of QMV_SIZES (Kp 128 to 1024: the butterfly and the
    shared-memory tail of the "shfl" route) and the solver's widths, on
    the route `QMV_ROUTES` gives (route None) and forced onto each; with
    lda != K through a row-strided view, and a transposed view the
    wrapper copies."""
    g = torch.Generator().manual_seed(fid)
    shapes = [(n, n) for n in (128, 200, 256, 384, 512)]
    shapes += [(m, k) for m in QMV_SIZES for k in QMV_SIZES]
    for M, K in shapes:
        wide = (torch.randn(M, K + 3, generator=g) * 3).to(cuda_device)
        v = torch.randn(K, generator=g).to(cuda_device)
        for a in (wide[:, :K].contiguous(), wide[:, :K]):
            for chop_out in (True, False):
                got = qmv_op(a, v, fid, chop_out=chop_out, route=route)
                want = qmv_ref(a, v, fid, chop_out=chop_out)
                assert _same_bits(got, want), (M, K, a.stride(), chop_out)
        at = wide[:, :K].t().contiguous().t()       # column-major: copied
        assert _same_bits(qmv_op(at, v, fid, route=route),
                          qmv_ref(at, v, fid))
    if route != "shfl":     # Kp past the "shfl" route, and K = 0
        for M, K in ((5, 2000), (3, 0)):
            a = torch.randn(M, K, generator=g).to(cuda_device)
            v = torch.randn(K, generator=g).to(cuda_device)
            assert _same_bits(qmv_op(a, v, fid, route=route),
                              qmv_ref(a, v, fid))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shfl", "smem"])
@pytest.mark.parametrize("kind", SPECIAL_MATVEC)
def test_qmv_special_operands_bitexact(cuda_device, kind, route):
    """Signed zeros (a row of -0 products sums to -0 when K fills Kp and
    to +0 with the padding's +0), NaN, infinities and subnormal products,
    on both routes, all seven format ids, K with and without padding."""
    for fid in FMT_IDS:
        for M, K in ((33, 128), (33, 100), (31, 384), (17, 300)):
            a, v = special_matvec(kind, fid, M, K, seed=fid + K)
            a, v = a.to(cuda_device), v.to(cuda_device)
            for chop_out in (True, False):
                got = qmv_op(a, v, fid, chop_out=chop_out, route=route)
                want = qmv_ref(a, v, fid, chop_out=chop_out)
                assert _same_bits(got, want), (fid, M, K, chop_out)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qgemm_kernel_within_order_tolerance(cuda_device, fid):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(fid)
    for M, K, N in ((448, 64, 448), (192, 64, 192), (100, 300, 70)):
        a, b = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
        got = qgemm_op(a.to(cuda_device), b.to(cuda_device), fid).cpu()
        want = qgemm_ref(a.to(cuda_device), b.to(cuda_device), fid).cpu()
        Kp = -(-K // 128) * 128
        ac, bc = chop(a, fid).double(), chop(b, fid).double()
        bound = Kp * 2.0 ** -24 * (ac.abs() @ bc.abs()) + ulp_fmt(want, fid)
        diff = (got.double() - want.double()).abs()
        assert bool(((got == want) | (diff <= bound)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 128])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qgemm_kernel_at_the_sweep_panel_widths(cuda_device, fid, K):
    """The blocked LU's trailing update at the panel widths the sweep
    (`solvers.block_autotune`) also tries: (n_pad - k1, K) x (K, n_pad -
    k1), within the order tolerance (K padded to Kp = 128)."""
    g = torch.Generator().manual_seed(fid + K)
    for m in (512 - K, 384 - K, 256 - K):
        a, b = torch.randn(m, K, generator=g), torch.randn(K, m, generator=g)
        a, b = a.to(cuda_device), b.to(cuda_device)
        ok, _, _ = held(qgemm_op(a, b, fid), qgemm_ref(a, b, fid), a, b,
                        fid, 128, True)
        assert ok, (fid, K, m)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmatmul_kernel_within_order_tolerance(cuda_device, fid):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(100 + fid)
    for M, K, N, bk in ((200, 300, 130, None), (64, 512, 96, 128),
                        (33, 1000, 65, 512), (16, 40, 8, None)):
        a, b = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
        bk_ = min(bk or 256, max(128, 1 << (K - 1).bit_length()))
        Kp = -(-K // bk_) * bk_
        ap = torch.nn.functional.pad(a, (0, Kp - K)).to(cuda_device)
        bp = torch.nn.functional.pad(b, (0, 0, 0, Kp - K)).to(cuda_device)
        ac, bc = chop(a, fid).double(), chop(b, fid).double()
        order = Kp * 2.0 ** -24 * (ac.abs() @ bc.abs())
        for chop_out in (True, False):
            got = qmatmul_op(a.to(cuda_device), b.to(cuda_device), fid,
                             chop_out=chop_out, bk=bk).cpu()
            want = qmatmul_ref_blocked(ap, bp, fid, bk_,
                                       chop_out=chop_out).cpu()
            bound = order + (ulp_fmt(want, fid) if chop_out else 0.0)
            diff = (got.double() - want.double()).abs()
            assert bool(((got == want) | (diff <= bound)).all())
    # Any float input is cast to float32 first.
    a, b = torch.randn(64, 300, generator=g), torch.randn(300, 32, generator=g)
    got = qmatmul_op(a.to(cuda_device, torch.bfloat16),
                     b.to(cuda_device, torch.bfloat16), fid)
    want = qmatmul_op(a.bfloat16().float().to(cuda_device),
                      b.bfloat16().float().to(cuda_device), fid)
    assert torch.equal(got, want)


def _check_gemm(dev, a, b, fid, bk, route):
    """qmatmul's launcher on the route (None: the wrapper's) against
    qmatmul_ref_blocked with K zero-padded to a multiple of bk."""
    K = a.shape[1]
    bk_ = min(bk or 256, max(128, 1 << max(K - 1, 0).bit_length()))
    Kp = -(-K // bk_) * bk_
    ap = torch.nn.functional.pad(a, (0, Kp - K)).to(dev)
    bp = torch.nn.functional.pad(b, (0, 0, 0, Kp - K)).to(dev)
    for chop_out in (True, False):
        if route is None:
            got = qmatmul_op(a.to(dev), b.to(dev), fid, chop_out=chop_out,
                             bk=bk)
        else:
            got = _gemm("qmatmul", a.to(dev), b.to(dev), fid, bk_, chop_out,
                        route)
        want = qmatmul_ref_blocked(ap, bp, fid, bk_, chop_out=chop_out)
        assert held(got, want, a, b, fid, Kp, chop_out)[0], \
            (tuple(a.shape), tuple(b.shape), bk, route, chop_out)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "ffma"])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_gemm_special_values_within_order_tolerance(cuda_device, fid, route):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(200 + fid)
    for kind in SPECIAL_KINDS:
        a, b = special_operands(kind, fid, 65, 129, 63, g)
        _check_gemm(cuda_device, a, b, fid, None, route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "ffma"])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_gemm_ragged_shapes_and_any_bk(cuda_device, fid, route):
    """M/N/K off the tiles (1, 63, 65, 129, 300), and K blocks of 96 and
    100: 100 is no multiple of any K tile, 96 is one of tf32's 32 and the
    FFMA kernel's 16 but not of bf16's 64. Off a route's K tile, each K
    block is a launch of its own and the partials are added in order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(300 + fid)
    for M, K, N, bk in ((1, 1, 1, None), (63, 65, 129, None),
                        (129, 300, 1, None), (300, 63, 65, None),
                        (65, 129, 300, 100), (63, 300, 129, 96)):
        a, b = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
        _check_gemm(cuda_device, a * 10.0 ** torch.randint(
            -2, 3, (M, K), generator=g), b, fid, bk, route)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", [f for f in FMT_IDS if ROUTES[f][1] == "wgmma"])
def test_pack_kernel_equals_pack_ref(cuda_device, fid):
    """The tensor-core route's chop-and-pack kernel against its plain
    version, on every float32 exponent field and the formats' specials
    at ragged M/N/K, and at the trailing update's shape."""
    x = float32_patterns(fid)
    a = x.repeat(2)[:129 * 130].reshape(129, 130)
    b = x.flip(0).repeat(2)[:130 * 127].reshape(130, 127)
    g = torch.Generator().manual_seed(400 + fid)
    for a, b in ((a, b), (torch.randn(448, 64, generator=g),
                          torch.randn(64, 448, generator=g))):
        pa, pb = _pack(a.to(cuda_device), b.to(cuda_device), fid)
        assert pack_equal(pa, pb, a, b, fid)


FLASH_CASES = [dict(kind="attn"), dict(kind="local", window=64),
               dict(kind="local", window=100), dict(kind="chunked", chunk=128),
               dict(kind="chunked", chunk=48), dict(kind="attn", softcap=50.0),
               dict(kind="local", window=100, softcap=30.0)]
# (B, Sq, Sk, Hq, Hkv): GQA groups 2, 1, 4 and 5, ragged Sq and Sk (1, 63,
# 65, 130, 200), and Sq < Sk (a row past Sk + window would see no key).
FLASH_SHAPES = [(2, 256, 256, 4, 2), (1, 200, 200, 3, 3), (1, 128, 320, 8, 2),
                (1, 128, 320, 10, 2), (1, 65, 65, 5, 1), (1, 63, 130, 2, 1),
                (1, 1, 1, 2, 1)]


def _flash_cases(dev, d, seed):
    """((q, k, v), case) on `dev` for every shape and case, in float32."""
    g = torch.Generator().manual_seed(seed)
    for b, sq, sk, hq, hkv in FLASH_SHAPES:
        q = torch.randn(b, sq, hq, d, generator=g)
        k = torch.randn(b, sk, hkv, d, generator=g)
        v = torch.randn(b, sk, hkv, d, generator=g)
        for case in FLASH_CASES:
            yield tuple(x.to(dev) for x in (q, k, v)), case


def _heads(x):
    return x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


def _flash_want(q, k, v, case, ref=flash_ref, **kw):
    b, sq, hq, d = q.shape
    want = ref(_heads(q), _heads(k), _heads(v), groups=hq // k.shape[2],
               **case, **kw)
    return want.reshape(b, hq, sq, d).permute(0, 2, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_kernel_matches_plain(cuda_device, d):
    """Each route `ROUTES` gives: float32 (SIMT) within 2e-5, the JAX
    tests' tolerance; bf16 (wgmma at D >= 64, SIMT below) within two bf16
    ulps of each output row's largest |want| (`within_bf16_rows`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for (q, k, v), case in _flash_cases(cuda_device, d, d):
        sq, sk = q.shape[1], k.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc = (x.to(dtype) for x in (q, k, v))
            got = flash_attention_op(qc, kc, vc, bq=sq, bk=sk, **case)
            want = _flash_want(qc, kc, vc, case)
            assert got.dtype == dtype
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            else:
                assert within_bf16_rows(got, want)[0], (q.shape, case)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [d for d in HEAD_DIMS
                               if FLASH_ROUTES[(torch.bfloat16, d)] == "wgmma"])
def test_flash_wgmma_matches_tiled_model(cuda_device, d):
    """The wgmma route against `flash_tiled_ref` at its own key tile
    (`WGMMA_BK`), within one bf16 ulp of each row's largest |want|: the
    two visit the same tiles, round the same P to bf16 and sum l from the
    same unrounded p, and differ only in the order of the float32 sums,
    exp2 for exp (~1e-7 relative) and the rare P whose rounding that
    flips (2^-8 p_k |v_k| / l each), so their float32 outputs agree to
    ~1e-5 of the row and their bf16 outputs by at most one rounding
    step. Also within two ulps of flash_ref."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for (q, k, v), case in _flash_cases(cuda_device, d, 500 + d):
        qc, kc, vc = (x.bfloat16() for x in (q, k, v))
        got = flash_attention_op(qc, kc, vc, bq=q.shape[1], bk=k.shape[1],
                                 route="wgmma", **case)
        tiled = _flash_want(qc, kc, vc, case, flash_tiled_ref,
                            bk=WGMMA_BK[d])
        assert within_bf16_rows(got, tiled, ulps=1)[0], (q.shape, case)
        assert within_bf16_rows(got, _flash_want(qc, kc, vc, case))[0], \
            (q.shape, case)


@pytest.mark.cuda
def test_flash_wgmma_takes_a_view_off_16_byte_alignment(cuda_device):
    """A contiguous view 2 bytes past an allocation's start: the wgmma
    route copies it (TMA needs 16-byte aligned addresses) and gives what
    the aligned tensor gives."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3 * 64 * 128 + 1, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = (x[1 + i * 64 * 128:1 + (i + 1) * 64 * 128].view(1, 64, 1, 128)
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    got = flash_attention_op(q, k, v, route="wgmma")
    want = flash_attention_op(q.clone(), k.clone(), v.clone(), route="wgmma")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_simt_route_on_bf16(cuda_device, d):
    """The SIMT kernel forced on bf16 at every head dim, where `ROUTES`
    sends D >= 64 to the tensor cores: within two bf16 ulps of each row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for (q, k, v), case in _flash_cases(cuda_device, d, 900 + d):
        qc, kc, vc = (x.bfloat16() for x in (q, k, v))
        got = flash_attention_op(qc, kc, vc, bq=q.shape[1], bk=k.shape[1],
                                 route="simt", **case)
        assert within_bf16_rows(got, _flash_want(qc, kc, vc, case))[0], \
            (q.shape, case)


def _factor(n, rng, dev):
    M = rng.standard_normal((n, n)) * 0.3
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (2.0 + rng.random(n))
    return (torch.tensor(M, dtype=torch.float32, device=dev),
            torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_trisolve_kernel_bitexact(cuda_device, fid, lower):
    """The solver's block 128 at n 1, 37, 256, 300 and 512, on the route
    `trisolve_route` gives ("shfl") and forced onto "smem"."""
    rng = np.random.default_rng(fid)
    for n in (1, 37, 256, 300, 512):
        Lu, b = _factor(n, rng, cuda_device)
        want = trisolve_ref(Lu, b, fid, lower=lower, block=128)
        for route in (None, "smem"):
            got = trisolve_op(Lu, b, fid, lower=lower, block=128, route=route)
            assert _same_bits(got, want), (n, route)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_trisolve_kernel_block_widths(cuda_device, fid, lower):
    """Every width of the "shfl" route (1 to 64; 128 above), each also on
    "smem", and widths only "smem" takes (3, 48, 100), at n 1 and 37, and
    the wider ones at n 300."""
    rng = np.random.default_rng(100 + fid)
    cases = [(n, blk) for n in (1, 37) for blk in (1, 2, 3, 4, 8, 16, 32,
                                                   48, 64, 100)]
    cases += [(300, blk) for blk in (16, 32, 64, 100)]
    for n, blk in cases:
        Lu, b = _factor(n, rng, cuda_device)
        want = trisolve_ref(Lu, b, fid, lower=lower, block=blk)
        routes = ["smem"] + (["shfl"] if TRISOLVE_ROUTES.get(blk) else [])
        assert trisolve_route(n, blk) == routes[-1]
        for route in (None, *routes):
            got = trisolve_op(Lu, b, fid, lower=lower, block=blk, route=route)
            assert _same_bits(got, want), (n, blk, route)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("kind", SPECIAL_MATVEC)
def test_trisolve_special_operands_bitexact(cuda_device, kind, lower):
    """Signed zeros (b = -0: the leading 0 + of the accumulator, the
    masked +0 products and b - acc decide the sign of every zero), NaN,
    infinities and subnormals, on both routes, all seven format ids."""
    for fid in FMT_IDS:
        for n, blk in ((37, 16), (37, 128), (300, 128)):
            Lu, b = special_system(kind, fid, n, seed=fid + n)
            Lu, b = Lu.to(cuda_device), b.to(cuda_device)
            want = trisolve_ref(Lu, b, fid, lower=lower, block=blk)
            for route in ("shfl", "smem"):
                got = trisolve_op(Lu, b, fid, lower=lower, block=blk,
                                  route=route)
                assert _same_bits(got, want), (fid, n, blk, route)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(cuda_device):
    library.reset_launches()
    x = torch.randn(64, 64, device=cuda_device)
    chop_op(x, 2)
    chop_expr_op("mul", x[0], x[1], fmt_id=2)
    chop_expr_op("sub_mul", x, x[:, :1].clone(), x[0].clone(), fmt_id=2,
                 out=x)
    qmv_op(x, x[0].contiguous(), 2)
    qgemm_op(x, x, 2)
    trisolve_op(x, x[0].contiguous(), 2, lower=True)
    qmatmul_op(x, x, 2)
    qmatmul_op(x.bfloat16(), x.bfloat16(), 2)
    h = x.reshape(1, 64, 2, 32)
    hb = x.reshape(1, 64, 1, 64).bfloat16()
    flash_attention_op(h, h, h)                  # float32: SIMT
    flash_attention_op(hb, hb, hb)               # bf16, D 64: wgmma
    flash_attention_op(hb, hb, hb, route="simt")
    # The float64 carrier's launches count under the kernel's name with
    # "_f64".
    xd = x.double()
    chop_op(xd, 2)
    qmv_op(xd, xd[0].contiguous(), 2)
    qgemm_op(xd, xd, 2)
    trisolve_op(xd, xd[0].contiguous(), 2, lower=False)
    assert library.LAUNCHES == {"chop": 3, "qmv": 1, "qgemm": 1,
                                "qmatmul": 2, "trisolve": 1,
                                "flash_attention": 3, "chop_f64": 1,
                                "qmv_f64": 1, "qgemm_f64": 1,
                                "trisolve_f64": 1}
    assert library.ROUTE_LAUNCHES == {
        "chop": {"x/" + chop_route(x.numel(), True, "x"): 1,
                 "mul/" + chop_route(64, True, "mul"): 1,
                 "sub_mul/" + chop_route(x.numel(), False, "sub_mul"): 1},
        "qmv": {"shfl": 1},
        "qgemm": {"wgmma": 1}, "qmatmul": {"wgmma": 2},
        "trisolve": {"shfl": 1}, "flash_attention": {"simt": 2, "wgmma": 1},
        "chop_f64": {"x/" + chop_route(x.numel(), True, "x"): 1},
        "qmv_f64": {"shfl": 1}, "qgemm_f64": {"dfma": 1},
        "trisolve_f64": {"shfl": 1}}
    with pytest.raises(TypeError):      # no kernel takes float16
        chop_op(x.half(), 2)
    with pytest.raises(TypeError):      # one carrier a call
        qmv_op(x, xd[0].contiguous(), 2)
    with pytest.raises(ValueError):     # above two dimensions, strided
        chop_op(x.t()[None], 2)
    with pytest.raises(TypeError):
        chop_expr_op("add", x, x.double(), fmt_id=2)
    with pytest.raises(TypeError):
        trisolve_op(x.half(), x[0].half(), 2, lower=True)
    with pytest.raises(ValueError):     # a CPU operand with a CUDA one
        chop_expr_op("add", x, torch.ones(()), fmt_id=2)
    with pytest.raises(ValueError):     # up to two dimensions
        chop_expr_op("add", x[None], x, fmt_id=2)
    with pytest.raises(ValueError):     # shapes that do not broadcast
        chop_expr_op("add", x, x[:3, :5], fmt_id=2)
    with pytest.raises(ValueError):     # out of another shape
        chop_expr_op("add", x, x, fmt_id=2, out=x[0])
    with pytest.raises(ValueError):     # out repeating an element
        chop_expr_op("add", x[0], x[1], fmt_id=2, out=x[0, :1].expand(64))
    with pytest.raises(ValueError):     # out on a but not element-wise
        chop_expr_op("add", x, x, fmt_id=2, out=x.t())
    with pytest.raises(ValueError):     # a live range of a matrix
        chop_expr_op("add", x, x, fmt_id=2, live=(0, 3))
    with pytest.raises(ValueError):     # the block route past BLOCK_MAX
        chop_expr_op("add", x, x, fmt_id=2, route="block")
    with pytest.raises(ValueError):     # the vector route off 16 bytes
        chop_expr_op("add", x.reshape(-1)[1:1001], x.reshape(-1)[:1000],
                     fmt_id=2, route="vector")
    assert library.LAUNCHES["chop"] == 3
    with pytest.raises(ValueError):
        trisolve_op(x, x[0].contiguous(), 2, lower=True, block=512)
    with pytest.raises(ValueError):     # "shfl" takes powers of two
        trisolve_op(x, x[0].contiguous(), 2, lower=True, block=48,
                    route="shfl")
    with pytest.raises(ValueError):     # and Kp up to 1024
        qmv_op(torch.randn(4, 2000, device=cuda_device),
               torch.randn(2000, device=cuda_device), 2, route="shfl")
    with pytest.raises(ValueError):
        flash_attention_op(x.reshape(1, 64, 1, 64)[..., :48],
                           x.reshape(1, 64, 1, 64)[..., :48],
                           x.reshape(1, 64, 1, 64)[..., :48])
    with pytest.raises(TypeError):
        flash_attention_op(h.half(), h.half(), h.half())
    with pytest.raises(ValueError):     # no float32 tensor-core route
        flash_attention_op(h, h, h, route="wgmma")
    with pytest.raises(ValueError):     # bf16 at D 32 has none either
        flash_attention_op(h.bfloat16(), h.bfloat16(), h.bfloat16(),
                           route="wgmma")
    with pytest.raises(ValueError):
        flash_attention_op(hb, hb, hb, route="tensor")
    assert library.LAUNCHES["flash_attention"] == 3


@pytest.mark.cuda
def test_strict_solve_on_card_equals_cpu(cuda_device):
    s = randsvd_dense(100, 1e4, np.random.default_rng(0))
    for action in ([2, 4, 5, 6], [0, 0, 2, 5], [5, 5, 5, 5]):
        cfg = IRConfig(tau=1e-6)
        gpu = gmres_ir(s.A, s.b, s.x_true, action, cfg, device=cuda_device)
        cpu = gmres_ir(s.A, s.b, s.x_true, action, cfg, device="cpu",
                       carrier_dtype="float32")
        for field, g, c in zip(gpu._fields, gpu, cpu):
            assert torch.equal(g.cpu(), c), field


@pytest.mark.cuda
def test_strict_cg_solve_on_card_equals_cpu(cuda_device):
    s = sparse_spd(100, 0.02, np.random.default_rng(0), 1e3)
    for action in ([5, 5, 5, 6], [2, 4, 5, 6], [3, 3, 4, 5]):
        cfg = CGConfig(tau=1e-6)
        gpu = cg_ir(s.A, s.b, s.x_true, action, cfg, device=cuda_device)
        cpu = cg_ir(s.A, s.b, s.x_true, action, cfg, device="cpu",
                    carrier_dtype="float32")
        for field, g, c in zip(gpu._fields, gpu, cpu):
            assert torch.equal(g.cpu(), c), field


@pytest.mark.cuda
def test_sweep_times_a_cuda_graph_of_the_pipeline(cuda_device):
    """The panel-width sweep's device timer: the pipeline (blocked LU +
    both substitutions) captures into a CUDA graph, whose replays leave
    the eager call's result bit for bit, and every width is timed."""
    from repro_torch.precision import FORMAT_ID, backend_for
    from repro_torch.solvers import block_autotune as tba
    n = 256
    rng = np.random.default_rng(0)
    bk = backend_for(cuda_device)
    A = torch.as_tensor(rng.standard_normal((n, n)) + n * np.eye(n),
                        dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=cuda_device)
    fmt = FORMAT_ID["bf16"]
    want = tba._pipeline(A, b, fmt, 64, 128, bk)
    outs = []
    seconds = tba._graph_seconds(
        lambda: outs.append(tba._pipeline(A, b, fmt, 64, 128, bk)), 3)
    torch.cuda.synchronize()
    assert seconds > 0 and len(outs) == 2     # warm-up, then the capture
    assert _same_bits(outs[0], want) and _same_bits(outs[1], want)
    times = tba.sweep_lu_block(n, device=cuda_device, repeats=2)
    assert sorted(times) == [32, 64, 128]
    assert all(0 < t < 1 for t in times.values())


@pytest.mark.cuda
def test_wrappers_launch_on_the_tensors_device(cuda_device):
    """Each wrapper on cuda:1 while cuda:0 is current: the launchers
    prepare their kernels on the tensors' device (the wrappers' device
    guard), and the results equal those of the same calls on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    g = torch.Generator().manual_seed(11)
    x = torch.randn(256, 256, generator=g)
    lu, b = _factor(300, np.random.default_rng(11), "cpu")
    hb = torch.randn(1, 128, 2, 64, generator=g).bfloat16()
    h = torch.randn(1, 128, 2, 32, generator=g)
    calls = (lambda d: chop_op(x.to(d), 2),
             lambda d: chop_expr_op("sub", x[0].to(d), x[1].to(d), fmt_id=2),
             lambda d: chop_expr_op("sub_div", x.to(d), x[0].to(d),
                                    x[:, :1].to(d), fmt_id=2),
             lambda d: chop_expr_op("mul", x[:, 3].to(d), x[0, 0].to(d),
                                    fmt_id=2, live=(4, 100)),
             lambda d: qmv_op(x.to(d), x[0].to(d), 2),
             lambda d: qmv_op(x.to(d), x[0].to(d), 2, route="smem"),
             lambda d: qgemm_op(x.to(d), x.to(d), 2),
             lambda d: qgemm_op(x.to(d), x.to(d), 5),
             lambda d: qmatmul_op(x.to(d), x.to(d), 2, bk=100),
             lambda d: trisolve_op(lu.to(d), b.to(d), 2, lower=False),
             lambda d: trisolve_op(lu.to(d), b.to(d), 2, lower=True,
                                   route="smem"),
             lambda d: flash_attention_op(hb.to(d), hb.to(d), hb.to(d)),
             lambda d: flash_attention_op(h.to(d), h.to(d), h.to(d)))
    torch.cuda.set_device(0)
    for call in calls:
        want = call(torch.device("cuda", 0))
        got = call(torch.device("cuda", 1))
        torch.cuda.synchronize(1)
        assert got.device == torch.device("cuda", 1)
        assert torch.equal(got.cpu(), want.cpu())
        assert torch.cuda.current_device() == 0


# The float64 carrier: the solver kernels' float64 instantiations.
F64 = torch.float64


def _same_nan_bits(got, want):
    """Equal bits, every NaN read as one NaN: the card's float64
    arithmetic passes an operand's NaN payload and sign through (its
    float32 arithmetic returns one canonical NaN), so a NaN's bits depend
    on the order of the operands, which the reference does not fix."""
    torch.cuda.synchronize()
    return got.dtype == want.dtype and same_bits_any_nan(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_chop_kernel_float64_routes_bitexact(cuda_device, fid):
    """chop_f64 on every route, at sizes on both sides of the route bounds
    with and without a tail of n mod 2, aligned and off 16 bytes, and as
    a (128, 128) matrix: every float64 exponent field, the carrier's
    subnormals, NaN, infinities, signed zeros and each format's edges
    (fp64 is the identity, e4m3 and e5m2 saturate)."""
    pats = float64_patterns(fid)
    reps = -(-(max(CHOP_SIZES[:-1]) + 1) // pats.numel())
    base = pats.repeat(reps)[torch.randperm(
        pats.numel() * reps, generator=torch.Generator().manual_seed(fid))]
    base = base.to(cuda_device)
    for n in CHOP_SIZES[:-1]:
        for x in (base[:n], base[1:n + 1]):
            aligned = n == 1 or x.data_ptr() % 16 == 0
            want = chop_ref(x, fid)
            routes = ["strided"] + (["block"] if n <= BLOCK_MAX else []) \
                + (["vector"] if aligned else [])
            for route in [None] + routes:
                assert _same_nan_bits(chop_op(x, fid, route=route), want), \
                    (n, aligned, route)
    m = base[:128 * 128].reshape(128, 128)
    assert _same_nan_bits(chop_op(m, fid), chop_ref(m, fid))
    if fid == 6:            # fp64 on float64: every pattern unchanged
        assert _same_nan_bits(chop_op(base, fid), base)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
@pytest.mark.parametrize("form", FORMS)
def test_chop_expr_kernel_float64_bitexact(cuda_device, form, fid):
    """Every form on float64 operands (`expr_cases` on the float64
    carrier: the call sites' shapes, the special operands, division by
    zero), on every route that takes it, into output views and `a`
    itself, and with live ranges, bit for bit against the plain
    version."""
    cases = expr_cases(fid, seed=30 + fid, dtype=F64,
                       sizes=(40, BLOCK_MAX, 4099, 30_001))
    for name, *ops in cases:
        ops = [to_keeping_layout(t, cuda_device) for t in ops[:ARITY[form]]]
        want = chop_expr_ref(form, *ops, fmt_id=fid)
        shape, M, N, _ = expr_layout(ops)
        for route in [None] + _routes_taking(ops, want, M, N):
            got = chop_expr_op(form, *ops, fmt_id=fid, route=route)
            assert _same_nan_bits(got, want), (name, route)
        views = out_views(tuple(shape), want)
        if ops[0].shape == shape:
            views.append(("a itself", ops[0].clone()))
        for view, out in views:
            mine = [out] + ops[1:] if view == "a itself" else ops
            for route in _routes_taking(mine, out, M, N):
                if view == "a itself":
                    out.copy_(ops[0])
                got = chop_expr_op(form, *mine, fmt_id=fid, out=out,
                                   route=route)
                assert got is out and _same_nan_bits(out, want), \
                    (name, view, route)
        if len(shape) == 1:
            idx = torch.arange(N, device=cuda_device)
            zero = torch.zeros((), dtype=F64, device=cuda_device)
            for lo, hi in live_ranges(N):
                masked = torch.where((idx >= lo) & (idx < hi), want, zero)
                for route in _routes_taking(ops, want, M, N):
                    got = chop_expr_op(form, *ops, fmt_id=fid,
                                       live=(lo, hi), route=route)
                    assert _same_nan_bits(got, masked), (name, lo, hi, route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "shfl", "smem"])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmv_kernel_float64_bitexact(cuda_device, fid, route):
    """qmv on float64 operands: the solver's widths and every M and K of
    QMV_SIZES, lda != K, both routes, the special operands, and K past
    "shfl" on "smem", bit for bit."""
    g = torch.Generator().manual_seed(fid)
    shapes = [(n, n) for n in (128, 256, 384, 512)]
    shapes += [(m, k) for m in QMV_SIZES for k in QMV_SIZES]
    for M, K in shapes:
        wide = (torch.randn(M, K + 3, generator=g, dtype=F64)
                * 10.0 ** torch.randint(-3, 4, (M, K + 3), generator=g)
                ).to(cuda_device)
        v = torch.randn(K, generator=g, dtype=F64).to(cuda_device)
        for a in (wide[:, :K].contiguous(), wide[:, :K]):
            for chop_out in (True, False):
                got = qmv_op(a, v, fid, chop_out=chop_out, route=route)
                want = qmv_ref(a, v, fid, chop_out=chop_out)
                assert _same_nan_bits(got, want), (M, K, a.stride(), chop_out)
    for kind in SPECIAL_MATVEC:
        for M, K in ((33, 128), (17, 300)):
            a, v = (t.double().to(cuda_device)
                    for t in special_matvec(kind, fid, M, K, seed=fid + K))
            assert _same_nan_bits(qmv_op(a, v, fid, route=route),
                              qmv_ref(a, v, fid)), (kind, M, K)
    if route != "shfl":
        a = torch.randn(5, 2000, generator=g, dtype=F64).to(cuda_device)
        v = torch.randn(2000, generator=g, dtype=F64).to(cuda_device)
        assert _same_nan_bits(qmv_op(a, v, fid, route=route),
                              qmv_ref(a, v, fid))


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_trisolve_kernel_float64_bitexact(cuda_device, fid, lower):
    """trisolve on float64: the solver's block 128 at n 1, 37, 300 and
    512 ("shfl" with its packed diagonal blocks, and "smem"), the other
    widths of each route at n 37 and 300, and the special systems, bit
    for bit (the row chain divides with __ddiv_rn)."""
    rng = np.random.default_rng(200 + fid)
    cases = [(n, 128) for n in (1, 37, 300, 512)]
    cases += [(n, blk) for n in (37, 300) for blk in (1, 16, 32, 48, 64)]
    for n, blk in cases:
        Lu, b = (t.double() for t in _factor(n, rng, cuda_device))
        want = trisolve_ref(Lu, b, fid, lower=lower, block=blk)
        routes = ["smem"] + (["shfl"] if TRISOLVE_ROUTES.get(blk) else [])
        assert trisolve_route(n, blk, F64) == routes[-1]
        for route in (None, *routes):
            got = trisolve_op(Lu, b, fid, lower=lower, block=blk, route=route)
            assert _same_nan_bits(got, want), (n, blk, route)
    for kind in SPECIAL_MATVEC:
        for n, blk in ((37, 16), (300, 128)):
            Lu, b = (t.double().to(cuda_device)
                     for t in special_system(kind, fid, n, seed=fid + n))
            want = trisolve_ref(Lu, b, fid, lower=lower, block=blk)
            for route in ("shfl", "smem"):
                got = trisolve_op(Lu, b, fid, lower=lower, block=blk,
                                  route=route)
                assert _same_nan_bits(got, want), (kind, n, blk, route)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qgemm_kernel_float64_within_order_tolerance(cuda_device, fid):
    """qgemm on float64 (`ROUTES_F64`: the DFMA kernel for every id) at
    the trailing updates and ragged shapes, and with each format's edge
    operands, within `held` on float64 (Kp 2^-53 sum |a||b| + ulp)."""
    assert ROUTES_F64[fid] == (F64, "dfma")
    g = torch.Generator().manual_seed(fid)
    cases = [(torch.randn(M, K, generator=g, dtype=F64),
              torch.randn(K, N, generator=g, dtype=F64))
             for M, K, N in ((448, 64, 448), (192, 64, 192), (480, 32, 480),
                             (384, 128, 384), (100, 300, 70), (1, 1, 1),
                             (65, 17, 63))]
    cases += [tuple(t.double() for t in special_operands(
        kind, fid, 448, 64, 448, g)) for kind in SPECIAL_KINDS]
    for a, b in cases:
        a, b = a.to(cuda_device), b.to(cuda_device)
        for chop_out in (True, False):
            got = qgemm_op(a, b, fid, chop_out=chop_out)
            want = qgemm_ref(a, b, fid, chop_out=chop_out)
            Kp = -(-a.shape[1] // 128) * 128
            ok, err, share = held(got, want, a, b, fid, Kp, chop_out)
            assert got.dtype == F64 and ok, (tuple(a.shape), err, share)


@pytest.mark.cuda
def test_strict_solves_on_the_float64_carrier_equal_cpu(cuda_device):
    """GMRES-IR and CG-IR on the card's float64 carrier against the same
    solves on the CPU (float64, plain versions), bit for bit in every
    field: the strict path is pinned op for op on both carriers."""
    s = randsvd_dense(100, 1e8, np.random.default_rng(0))
    for action in ([6, 6, 6, 6], [2, 4, 5, 6], [3, 5, 6, 6]):
        cfg = IRConfig(tau=1e-10)
        gpu = gmres_ir(s.A, s.b, s.x_true, action, cfg, device=cuda_device,
                       carrier_dtype="float64")
        cpu = gmres_ir(s.A, s.b, s.x_true, action, cfg, device="cpu",
                       carrier_dtype="float64")
        for field, g_, c_ in zip(gpu._fields, gpu, cpu):
            assert g_.dtype == c_.dtype and torch.equal(g_.cpu(), c_), \
                (action, field)
    s = sparse_spd(100, 0.02, np.random.default_rng(0), 1e9)
    for action in ([6, 6, 6, 6], [5, 5, 6, 6]):
        cfg = CGConfig(tau=1e-10)
        gpu = cg_ir(s.A, s.b, s.x_true, action, cfg, device=cuda_device,
                    carrier_dtype="float64")
        cpu = cg_ir(s.A, s.b, s.x_true, action, cfg, device="cpu",
                    carrier_dtype="float64")
        for field, g_, c_ in zip(gpu._fields, gpu, cpu):
            assert torch.equal(g_.cpu(), c_), (action, field)
