"""Torch port vs the JAX package: the K-blocked chopped matmul
`qmatmul_op`, run on the CPU (its plain version, `qmatmul_ref_blocked`
over K zero-padded to a multiple of the K block).

Held against the JAX package's `qmatmul_op` (the Pallas kernel in
interpret mode) and its oracle `qmatmul_ref_blocked`, for all seven
format ids, with and without the output rounding, at ragged M/N/K, with
one and several K blocks, and for bf16, f16 and f64 inputs (cast to
float32 by both ops).

Tolerance, per element: |got - want| <= ulp_fmt(|want|) (with the output
rounding) + Kp 2^-24 sum_k |chop(a)_ik| |chop(b)_kj|, Kp the padded K.
The second term bounds two summation orders of the same float32
products: within a K block the order of the reference's dot is XLA's,
which nothing pins (DESIGN.md §6.2), and the port's is the CPU matmul's.
The first allows one output rounding that a flipped last accumulator
bit moved. Outside that bound a result is a fault.

The CUDA kernel is held against the same plain version on the card in
test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul.ops import qmatmul_op as jqmatmul_op
from repro.kernels.qmatmul.ref import \
    qmatmul_ref_blocked as jqmatmul_ref_blocked
from repro.precision import FORMAT_LIST
from repro_torch.kernels import library
from repro_torch.kernels.qmatmul import (qmatmul_op, qmatmul_ref,
                                         qmatmul_ref_blocked)
from repro_torch.precision import chop as tchop

FMT_IDS = list(range(len(FORMAT_LIST)))

# (M, K, N, bk): ragged everywhere, two K blocks at the default bk = 256
# (K = 300 pads to 512), four forced blocks of 128, one block (K <= 128).
SHAPES = [(200, 300, 130, None), (48, 512, 40, 128), (9, 40, 17, None)]

# One compiled reference per (shape, bk), shared by every format id.
_jref_blocked = jax.jit(jqmatmul_ref_blocked,
                        static_argnames=("bk", "chop_out"))


def _bk(K, bk):
    """The K block the JAX op picks (`repro.kernels.qmatmul.ops`)."""
    return min(bk or 256, max(128, 1 << int(np.ceil(np.log2(max(K, 1))))))


def _ulp_fmt(y, fid):
    """Spacing of the format (capped at float32's) at |y|."""
    f = FORMAT_LIST[fid]
    t, emin = min(f.t, 24), max(f.emin, -126)
    ay = np.abs(y.astype(np.float64))
    e = np.floor(np.log2(np.where(ay > 0, ay, 1.0)))
    e = np.maximum(np.where(ay > 0, e, emin), emin)
    return 2.0 ** (e - t + 1)


def _assert_within(got, want, a32, b32, fid, Kp, chop_out):
    ac = tchop(torch.from_numpy(a32), fid).numpy().astype(np.float64)
    bc = tchop(torch.from_numpy(b32), fid).numpy().astype(np.float64)
    bound = Kp * 2.0 ** -24 * (np.abs(ac) @ np.abs(bc))
    if chop_out:
        bound = bound + _ulp_fmt(want, fid)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    ok = (got == want) | (diff <= bound)
    assert ok.all(), float(np.max(diff - bound))


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((M, K)) * 10.0 ** rng.integers(
        -2, 3, (M, K))).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("fid", FMT_IDS)
def test_qmatmul_matches_jax_op_and_blocked_oracle(fid):
    for i, (M, K, N, bk) in enumerate(SHAPES):
        a, b = _operands(M, K, N, 10 * fid + i)
        bk_ = _bk(K, bk)
        Kp = -(-K // bk_) * bk_
        ap = np.pad(a, ((0, 0), (0, Kp - K)))
        bp = np.pad(b, ((0, Kp - K), (0, 0)))
        for chop_out in (True, False):
            got = qmatmul_op(torch.from_numpy(a), torch.from_numpy(b), fid,
                             chop_out=chop_out, bk=bk).numpy()
            assert got.dtype == np.float32 and got.shape == (M, N)
            want_op = np.asarray(jqmatmul_op(
                jnp.asarray(a), jnp.asarray(b), fid, chop_out=chop_out,
                bk=bk, interpret=True))
            want_ref = np.asarray(_jref_blocked(
                jnp.asarray(ap), jnp.asarray(bp), fid, bk=bk_,
                chop_out=chop_out))
            for want in (want_op, want_ref):
                _assert_within(got, want, a, b, fid, Kp, chop_out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_qmatmul_casts_any_float_input_to_float32(dtype):
    M, K, N = 40, 300, 24
    a, b = _operands(M, K, N, 7)
    at = torch.from_numpy(a).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    # The same numbers in the same dtype for the JAX op; both ops cast
    # them to float32 themselves.
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float64: jnp.float64}[dtype]
    aj = jnp.asarray(at.double().numpy()).astype(jdt)
    bj = jnp.asarray(bt.double().numpy()).astype(jdt)
    a32, b32 = at.float().numpy(), bt.float().numpy()
    for fid in (2, 5):
        got = qmatmul_op(at, bt, fid).numpy()
        assert got.dtype == np.float32
        want = np.asarray(jqmatmul_op(aj, bj, fid, interpret=True))
        _assert_within(got, want, a32, b32, fid, 512, True)


def test_qmatmul_block_choice_follows_the_jax_op():
    """K = 100 -> one block of 128; K = 300 -> 256; bk = 512 for K = 1000
    -> 512; bk = 128 for K = 64 -> 128. With one block, the blocked sum is
    the unblocked `qmatmul_ref`."""
    from repro_torch.kernels.qmatmul.ops import _next_pow2
    for K, bk, want in ((100, None, 128), (300, None, 256),
                        (1000, 512, 512), (64, 128, 128), (1, None, 128)):
        assert min(bk or 256, max(128, _next_pow2(K))) == want == _bk(K, bk)
    a, b = _operands(16, 100, 8, 3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    one = qmatmul_op(at, bt, 2).numpy()
    for want in (qmatmul_ref_blocked(at, bt, 2, bk=100),
                 qmatmul_ref(at, bt, 2)):
        _assert_within(one, want.numpy(), a, b, 2, 128, True)


def test_qmatmul_rejects_bad_arguments_and_plain_launches_nothing():
    a = torch.randn(8, 16)
    with pytest.raises(ValueError):
        qmatmul_op(a, torch.randn(8, 4), 2)
    with pytest.raises(ValueError):
        qmatmul_op(a, torch.randn(16, 4), 2, bk=0)
    with pytest.raises(ValueError):
        qmatmul_ref_blocked(a, torch.randn(16, 4), 2, bk=5)
    library.reset_launches()
    qmatmul_op(a, torch.randn(16, 4), 2)
    assert sum(library.LAUNCHES.values()) == 0
