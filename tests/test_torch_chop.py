"""Torch port vs the JAX package: round-to-format and the fixed reductions.

The port's plain versions (`repro_torch.precision.chop`) must agree with
`repro.precision.chop` bit for bit: `_chop_core`/`chop` for all seven
format ids on the float32 and float64 carriers, over stratified bit
patterns (signed zeros, infs, NaN, carrier subnormals, every exponent,
the edges of each format's xmax, fp8 saturation), `tree_sum` on odd and
even widths, and `fma_barrier`. The CUDA chop kernel is held against the
same plain version on the card in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.precision import FORMAT_LIST
from repro.precision import chop as jchop
from repro.precision import chop_static as jchop_static
from repro.precision import fma_barrier as jfma_barrier
from repro.precision import rounding_unit as jrounding_unit
from repro.precision import tree_sum as jtree_sum
from repro_torch.kernels import library
from repro_torch.kernels.chop import chop_op, chop_ref
from repro_torch.precision import chop as tchop
from repro_torch.precision import chop_static as tchop_static
from repro_torch.precision import fma_barrier as tfma_barrier
from repro_torch.precision import rounding_unit as trounding_unit
from repro_torch.precision import tree_sum as ttree_sum

FMT_IDS = list(range(len(FORMAT_LIST)))
UINT = {np.float32: np.uint32, np.float64: np.uint64}


def _stratified(dtype, seed=0):
    """Bit patterns covering every exponent field, both signs, zeros,
    infs, NaN, subnormals, and the neighbourhood (incl. the rounding
    midpoints) of every format's xmax and of its smallest subnormal."""
    rng = np.random.default_rng(seed)
    ui = UINT[dtype]
    mbits = 23 if dtype == np.float32 else 52
    width = 32 if dtype == np.float32 else 64
    n_exp = 256 if dtype == np.float32 else 2048
    exps = np.repeat(np.arange(n_exp, dtype=np.uint64), 8)
    fracs = rng.integers(0, 2 ** mbits, exps.size, dtype=np.uint64)
    signs = rng.integers(0, 2, exps.size, dtype=np.uint64)
    pats = (signs << np.uint64(width - 1)) | (exps << np.uint64(mbits)) \
        | fracs
    vals = [pats.astype(ui).view(dtype)]
    special = [0.0, -0.0, np.inf, -np.inf, np.nan,
               np.finfo(dtype).tiny, np.finfo(dtype).smallest_subnormal,
               -np.finfo(dtype).smallest_subnormal, np.finfo(dtype).max]
    vals.append(np.asarray(special, dtype))
    for f in FORMAT_LIST:
        for v in (min(f.xmax, float(np.finfo(dtype).max)), f.xmin_sub,
                  f.xmin):
            base = np.asarray(v, dtype)
            ulp = np.asarray(2.0 ** (np.floor(np.log2(float(base)))
                                     - (f.t - 1)), np.float64)
            with np.errstate(over="ignore"):   # past xmax is wanted
                near = [base, np.nextafter(base, dtype(np.inf)),
                        np.nextafter(base, dtype(0)),
                        base + ulp / 2, base - ulp / 2, base * 1.5,
                        base * 4]
                arr = np.asarray(near, dtype)
            vals.extend([arr, -arr])
    vals.append(np.asarray([464.0, 480.0, 1e4, 57344.0, 61440.0, 1e6],
                           dtype))
    return np.concatenate(vals)


def _bits(x):
    return np.asarray(x).view(UINT[np.asarray(x).dtype.type])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fid", FMT_IDS)
def test_chop_bitexact(fid, dtype):
    x = _stratified(dtype, seed=fid)
    want = np.asarray(jax.jit(jchop)(jnp.asarray(x), fid))
    got = tchop(torch.from_numpy(x.copy()), fid).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The kernel wrapper on a CPU tensor is the plain version.
    np.testing.assert_array_equal(
        _bits(chop_op(torch.from_numpy(x.copy()), fid).numpy()), _bits(want))


@pytest.mark.parametrize("name", [f.name for f in FORMAT_LIST])
def test_chop_static_bitexact(name):
    for dtype in (np.float32, np.float64):
        x = _stratified(dtype, seed=3)
        want = np.asarray(jchop_static(jnp.asarray(x), name))
        got = tchop_static(torch.from_numpy(x.copy()), name).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12, 40, 127, 128, 384, 513])
def test_tree_sum_bitexact(n):
    rng = np.random.default_rng(n)
    for dtype in (np.float32, np.float64):
        x = (rng.standard_normal((3, n)) * 10.0 ** rng.integers(
            -8, 8, (3, n))).astype(dtype)
        for axis in (0, 1):
            want = np.asarray(jax.jit(lambda v, a=axis: jtree_sum(v, a))(
                jnp.asarray(x)))
            got = ttree_sum(torch.from_numpy(x), dim=axis).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fma_barrier_is_identity_like_reference():
    for dtype in (np.float32, np.float64):
        x = _stratified(dtype, seed=7)
        want = np.asarray(jax.jit(jfma_barrier)(jnp.asarray(x)))
        got = tfma_barrier(torch.from_numpy(x.copy())).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fid", FMT_IDS)
def test_rounding_unit_matches(fid):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        want = np.asarray(jrounding_unit(fid, jnp.dtype(jdt)))
        got = trounding_unit(fid, tdt).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrappers_import_and_take_cpu_tensors_without_nvcc():
    """The kernel modules import on a host without nvcc and build nothing
    at import; a CPU tensor runs the plain version and counts no launch."""
    library.reset_launches()
    x = torch.linspace(-3, 3, 50, dtype=torch.float32)
    np.testing.assert_array_equal(chop_op(x, 2).numpy(),
                                  chop_ref(x, 2).numpy())
    assert library.LAUNCHES == {k: 0 for k in library.KERNELS}
    assert library._LIB is None
