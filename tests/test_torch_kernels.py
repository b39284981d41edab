"""Torch port vs the JAX package: the plain versions of the chopped matvec,
the chopped GEMM and the blocked trisolve, and their CUDA kernels.

  * qmv plain version vs `repro.kernels.qmatmul.ref.qmv_ref`: bit-exact,
    K not a multiple of 128 included (the lane padding is part of the
    reduction contract).
  * qgemm plain version vs `qgemm_ref`: a tolerance. The only difference
    is the summation order of the carrier dot, which neither side pins
    (DESIGN.md §6.2). Per element, |got - want| may reach
    ulp_fmt(|want|) + gamma_Kp * sum_k |a_ik| |b_kj|, gamma_Kp = Kp * u
    (u = 2^-24 for the float32 carrier, 2^-53 for float64): the second
    term bounds two summation orders of the same products, the first an
    output rounding that the accumulator's last bit flipped.
  * trisolve plain version vs `trisolve_ref`: bit-exact, lower and upper,
    padded and unpadded.

Inputs are made with numpy from a seed and fed to both packages. The
CUDA kernels are held against these plain versions on the card in
test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul.ref import qgemm_ref as jqgemm_ref
from repro.kernels.qmatmul.ref import qmv_ref as jqmv_ref
from repro.kernels.trisolve.ref import trisolve_ref as jtrisolve_ref
from repro.precision import FORMAT_LIST
from repro_torch.kernels import library
from repro_torch.kernels.qmatmul import qgemm_op, qmv_op
from repro_torch.kernels.trisolve import trisolve_op
from repro_torch.precision import chop as tchop

FMT_IDS = list(range(len(FORMAT_LIST)))
DTYPES = [np.float32, np.float64]

# One compiled reference per shape, shared by every format id (runtime).
_jqmv = jax.jit(jqmv_ref, static_argnames=("chop_out",))
_jqgemm = jax.jit(jqgemm_ref, static_argnames=("chop_out",))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _factor_like(n, seed, dtype):
    """A combined-LU-shaped matrix: O(1) strictly-lower part, an upper
    part with a dominant diagonal (some exact zeros on the diagonal are
    not wanted: the solve would divide by the safe 1)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) * 0.3
    M[np.diag_indices(n)] = rng.choice([-1.0, 1.0], n) * (
        2.0 + rng.random(n))
    return M.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmv_plain_bitexact(fid, dtype):
    rng = np.random.default_rng(fid)
    for M, K in ((24, 40), (9, 200), (5, 384)):
        a = (rng.standard_normal((M, K)) * 3).astype(dtype)
        v = rng.standard_normal(K).astype(dtype)
        for chop_out in (True, False):
            want = np.asarray(_jqmv(jnp.asarray(a), jnp.asarray(v), fid,
                                    chop_out=chop_out))
            got = qmv_op(torch.from_numpy(a), torch.from_numpy(v), fid,
                         chop_out=chop_out).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _ulp_fmt(y, fid, dtype):
    """Spacing of the format (capped at the carrier's) at |y|."""
    f = FORMAT_LIST[fid]
    t = min(f.t, 24 if dtype == np.float32 else 53)
    emin = max(f.emin, -126 if dtype == np.float32 else -1022)
    ay = np.abs(y.astype(np.float64))
    e = np.floor(np.log2(np.where(ay > 0, ay, 1.0)))
    e = np.maximum(np.where(ay > 0, e, emin), emin)
    return 2.0 ** (e - t + 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fid", FMT_IDS)
def test_qgemm_plain_within_order_tolerance(fid, dtype):
    rng = np.random.default_rng(100 + fid)
    u = 2.0 ** -24 if dtype == np.float32 else 2.0 ** -53
    for M, K, N in ((32, 16, 32), (33, 64, 17), (16, 130, 16)):
        a = rng.standard_normal((M, K)).astype(dtype)
        b = rng.standard_normal((K, N)).astype(dtype)
        Kp = -(-K // 128) * 128
        ac = tchop(torch.from_numpy(a), fid).numpy().astype(np.float64)
        bc = tchop(torch.from_numpy(b), fid).numpy().astype(np.float64)
        order = Kp * u * (np.abs(ac) @ np.abs(bc))
        for chop_out in (True, False):
            want = np.asarray(_jqgemm(jnp.asarray(a), jnp.asarray(b), fid,
                                      chop_out=chop_out))
            got = qgemm_op(torch.from_numpy(a), torch.from_numpy(b), fid,
                           chop_out=chop_out).numpy()
            bound = order + (_ulp_fmt(want, fid, dtype) if chop_out else 0.0)
            diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
            assert np.all((got == want) | (diff <= bound)), (
                float(np.max(diff - bound)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_trisolve_plain_bitexact(fid, lower, dtype):
    # n = 32 is a block multiple; n = 37 is identity-padded to 48.
    for n, seed in ((32, 1), (37, 2)):
        Lu = _factor_like(n, seed + fid, dtype)
        b = np.random.default_rng(seed).standard_normal(n).astype(dtype)
        want = np.asarray(jtrisolve_ref(jnp.asarray(Lu), jnp.asarray(b), fid,
                                        lower=lower, block=16))
        got = trisolve_op(torch.from_numpy(Lu), torch.from_numpy(b), fid,
                          lower=lower, block=16).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_plain_versions_launch_nothing():
    library.reset_launches()
    a = torch.randn(8, 8)
    qmv_op(a, a[0], 2)
    qgemm_op(a, a, 2)
    trisolve_op(a, a[0], 2, lower=True, block=4)
    assert sum(library.LAUNCHES.values()) == 0
