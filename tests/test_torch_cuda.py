"""The CUDA kernels of the torch port against their plain versions, on the
card. Every test here needs a CUDA device and nvcc; without them each one
skips (the kernels have no CPU mode). This file imports no JAX, so it also
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX.)

Tolerances: chop, qmv and trisolve are bit-exact against their plain
versions; qgemm may differ from its plain version (a library matmul) by
ulp_fmt(|want|) + Kp 2^-24 sum_k |a_ik||b_kj| per element, the bound of
two summation orders plus one flipped output rounding. A strict-path
solve on the card equals the same solve on the CPU bit for bit: every
operation on that path is pinned.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.matrices import randsvd_dense
from repro_torch.kernels import library
from repro_torch.kernels.chop import chop_op, chop_ref
from repro_torch.kernels.qmatmul import qgemm_op, qgemm_ref, qmv_op, qmv_ref
from repro_torch.kernels.trisolve import trisolve_op, trisolve_ref
from repro_torch.precision import FORMAT_LIST, chop
from repro_torch.solvers import IRConfig, gmres_ir

FMT_IDS = list(range(len(FORMAT_LIST)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _patterns(seed):
    """Every float32 exponent field, both signs, random fractions, plus
    zeros, infs, NaN and the smallest subnormals."""
    rng = np.random.default_rng(seed)
    exps = np.repeat(np.arange(256, dtype=np.uint32), 64)
    pats = (rng.integers(0, 2, exps.size, dtype=np.uint32) << 31) \
        | (exps << 23) | rng.integers(0, 1 << 23, exps.size, dtype=np.uint32)
    extra = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        448.0, 464.0, 57344.0, 61440.0], np.float32)
    return torch.from_numpy(np.concatenate([pats.view(np.float32), extra]))


def _ulp_fmt(y, fid):
    f = FORMAT_LIST[fid]
    t, emin = min(f.t, 24), max(f.emin, -126)
    ay = y.double().abs()
    e = torch.floor(torch.log2(torch.where(ay > 0, ay, torch.ones_like(ay))))
    e = torch.clamp(torch.where(ay > 0, e, torch.full_like(e, emin)),
                    min=emin)
    return torch.pow(2.0, e - t + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_chop_kernel_bitexact(cuda_device, fid):
    x = _patterns(fid).to(cuda_device)
    for shape in ((x.numel(),), (128, 128), (1,)):
        xs = x[:int(np.prod(shape))].reshape(shape).contiguous()
        got, want = chop_op(xs, fid), chop_ref(xs, fid)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmv_kernel_bitexact(cuda_device, fid):
    g = torch.Generator().manual_seed(fid)
    for n in (128, 200, 256, 384, 512):
        a = (torch.randn(n, n, generator=g) * 3).to(cuda_device)
        v = torch.randn(n, generator=g).to(cuda_device)
        for chop_out in (True, False):
            got = qmv_op(a, v, fid, chop_out=chop_out)
            want = qmv_ref(a, v, fid, chop_out=chop_out)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
        bound = Kp * 2.0 ** -24 * (ac.abs() @ bc.abs()) + _ulp_fmt(want, fid)
        diff = (got.double() - want.double()).abs()
        assert bool(((got == want) | (diff <= bound)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_trisolve_kernel_bitexact(cuda_device, fid, lower):
    rng = np.random.default_rng(fid)
    for n in (256, 300, 512):
        M = rng.standard_normal((n, n)) * 0.3
        M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (
            2.0 + rng.random(n))
        Lu = torch.tensor(M, dtype=torch.float32, device=cuda_device)
        b = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=cuda_device)
        got = trisolve_op(Lu, b, fid, lower=lower, block=128)
        want = trisolve_ref(Lu, b, fid, lower=lower, block=128)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(cuda_device):
    library.reset_launches()
    x = torch.randn(64, 64, device=cuda_device)
    chop_op(x, 2)
    qmv_op(x, x[0].contiguous(), 2)
    qgemm_op(x, x, 2)
    trisolve_op(x, x[0].contiguous(), 2, lower=True)
    assert library.LAUNCHES == {"chop": 1, "qmv": 1, "qgemm": 1,
                                "trisolve": 1}
    with pytest.raises(TypeError):
        chop_op(x.double(), 2)
    with pytest.raises(ValueError):
        chop_op(x.t(), 2)
    with pytest.raises(ValueError):
        trisolve_op(x, x[0].contiguous(), 2, lower=True, block=512)


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
