"""The rest of the torch port's public precision API against the JAX
package, on the CPU.

  * `chop_stochastic` (the plain version of the `chop_sr` kernel) bit for
    bit against `repro.precision.chop_stochastic` fed the same words:
    `jax.random.bits(KEY, shape, uint32)`, the draw the reference makes
    from KEY. Every format, every float32 exponent field, each format's
    edges, the specials, float32 subnormals and deep underflow. The
    reference tests' checks on the port's own draws
    (`stochastic_bits` from a `torch.Generator`): results representable,
    one of the two neighbours, unbiased (the mean of 64 draws has bias
    under 0.35 x the RNE error), specials and exact values unchanged.
    The float64 carrier raises `TypeError`, as in the reference.
  * `chop_sr_f32` of `csrc/chop_core.cuh` compiled for the host with g++
    (`scripts/chop_host_check.py`) against the plain version.
  * `chop_tree` on a nested tree, `chop_matmul` within the GEMM order
    tolerance (DESIGN.md §6.2, `kernels.qmatmul.checks.held`),
    `simulate_dtype` for all seven formats with out-of-range and NaN
    inputs, and `runtime_tables`, each against the reference.
"""
import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.precision as rp
import repro_torch.precision as tp
from repro_torch.kernels.chop import chop_sr_op, chop_sr_ref
from repro_torch.kernels.chop.checks import sr_patterns
from repro_torch.kernels.qmatmul.checks import held

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = [f.name for f in tp.FORMAT_LIST]
KEY = jax.random.PRNGKey(0)
X = np.random.default_rng(0).standard_normal(8000).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("fmt", FORMATS)
def test_chop_stochastic_bit_equal_to_reference(fmt):
    fid = tp.FORMAT_ID[fmt]
    x = sr_patterns().numpy()
    want = _bits(rp.chop_stochastic(jnp.asarray(x), fid, KEY))
    words = np.asarray(jax.random.bits(KEY, x.shape, jnp.uint32))
    xt = torch.from_numpy(x.copy())
    for w in (torch.from_numpy(words.view(np.int32).copy()),
              torch.from_numpy(words.copy())):          # int32 and uint32
        got = tp.chop_stochastic(xt, fid, w)
        np.testing.assert_array_equal(_bits(got.numpy()), want)
    # Shapes the kernel takes: 0-dim and 2-D, same bits as flat.
    sq = xt[:4096].reshape(64, 64)
    wq = torch.from_numpy(words[:4096].view(np.int32).copy()).reshape(64, 64)
    np.testing.assert_array_equal(
        _bits(chop_sr_ref(sq, fid, wq).numpy()).ravel(), want[:4096])
    np.testing.assert_array_equal(
        _bits(chop_sr_ref(xt[7], fid, wq.view(-1)[7]).numpy()), want[7])


def _draws(x, fid, seeds):
    g = torch.Generator()
    out = []
    for s in seeds:
        g.manual_seed(s)
        out.append(tp.chop_stochastic(x, fid, tp.stochastic_bits(x, g)))
    return out


@pytest.mark.parametrize("fmt", ["bf16", "e4m3", "fp16", "tf32"])
def test_sr_outputs_are_representable(fmt):
    fid = tp.FORMAT_ID[fmt]
    x = torch.from_numpy(X.copy())
    (y,) = _draws(x, fid, [0])
    assert torch.equal(tp.chop(y, fid), y)


def test_sr_unbiased_vs_rne():
    """Averaged SR reconstructs x ~sqrt(n)x better than a single rounding."""
    fid = tp.FORMAT_ID["bf16"]
    x = torch.from_numpy(X.copy())
    mean = torch.stack(_draws(x, fid, range(64))).double().mean(0)
    bias_sr = (mean - x.double()).abs().mean()
    err_rn = (tp.chop(x, fid) - x).abs().double().mean()
    assert bias_sr < 0.35 * err_rn


def test_sr_rounds_to_neighbors():
    """SR result is one of the two enclosing representable values."""
    fid = tp.FORMAT_ID["bf16"]
    x = torch.from_numpy(X.copy())
    (y,) = _draws(x, fid, [1])
    lo = tp.chop(x - x.abs() * 4e-3, fid)
    hi = tp.chop(x + x.abs() * 4e-3, fid)
    assert bool(((y >= torch.minimum(lo, hi))
                 & (y <= torch.maximum(lo, hi))).all())


def test_sr_specials_and_exact_passthrough():
    sp = torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0])
    (y,) = _draws(sp, tp.FORMAT_ID["e4m3"], [2])
    assert y[0] == 0 and torch.signbit(y[1]) and torch.isposinf(y[2])
    assert torch.isneginf(y[3]) and torch.isnan(y[4])
    assert y[5] == 1.0 and y[6] == 2.0          # exactly representable


def test_sr_rejects_what_the_reference_rejects():
    x64 = torch.zeros(4, dtype=torch.float64)
    w = torch.zeros(4, dtype=torch.int32)
    for call in (lambda: tp.chop_stochastic(x64, 2, w),
                 lambda: chop_sr_op(x64, 2, w),
                 lambda: chop_sr_ref(x64, 2, w)):
        with pytest.raises(TypeError, match="f32 carrier"):
            call()
    with pytest.raises(TypeError, match="f32 carrier"):
        rp.chop_stochastic(jnp.zeros(4, jnp.float64), 2, KEY)
    x = torch.zeros(4)
    with pytest.raises(TypeError, match="int32 or uint32"):
        tp.chop_stochastic(x, 2, w.long())
    with pytest.raises(ValueError, match="shape"):
        tp.chop_stochastic(x, 2, w[:3])
    # The words come from a generator on x's device, one per element.
    g = torch.Generator().manual_seed(5)
    b = tp.stochastic_bits(torch.zeros(3, 5), g)
    assert b.dtype == torch.int32 and b.shape == (3, 5)
    assert torch.equal(b, tp.stochastic_bits(torch.zeros(3, 5),
                                             torch.Generator().manual_seed(5)))


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="needs a host C++ compiler")
def test_chop_sr_kernel_rounding_compiled_for_the_host():
    spec = importlib.util.spec_from_file_location(
        "chop_host_check", os.path.join(ROOT, "scripts",
                                        "chop_host_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    assert mod.check_sr(per_field=8, seed=2, out=lines.append) == 0, lines
    assert len(lines) == len(tp.FORMAT_LIST)


# ---------------------------------------------------------------------------
# chop_tree, chop_matmul, simulate_dtype, runtime_tables
# ---------------------------------------------------------------------------

def test_chop_tree_on_a_nested_tree():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((5, 7)) * 1e3).astype(np.float32)
    b = rng.standard_normal(9)
    c = rng.standard_normal((2, 3, 4)).astype(np.float32)
    ints = np.arange(6, dtype=np.int32)
    fid = tp.FORMAT_ID["fp16"]
    want = rp.chop_tree({"w": [jnp.asarray(a), (jnp.asarray(b),
                                                jnp.asarray(ints))],
                         "c": jnp.asarray(c)}, fid)
    got = tp.chop_tree({"w": [torch.from_numpy(a), (torch.from_numpy(b),
                                                    torch.from_numpy(ints))],
                        "c": torch.from_numpy(c)}, fid)
    assert isinstance(got, dict) and isinstance(got["w"], list)
    assert isinstance(got["w"][1], tuple)
    for g, w in ((got["w"][0], want["w"][0]), (got["w"][1][0],
                                               want["w"][1][0]),
                 (got["c"], want["c"])):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert torch.equal(got["w"][1][1], torch.from_numpy(ints))


@pytest.mark.parametrize("fmt", ["e4m3", "bf16", "fp16", "tf32"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chop_matmul_within_the_gemm_tolerance(fmt, dtype):
    fid = tp.FORMAT_ID[fmt]
    rng = np.random.default_rng(fid)
    a = rng.standard_normal((33, 70)).astype(dtype)
    b = rng.standard_normal((70, 19)).astype(dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for chop_out in (True, False):
        want = torch.from_numpy(np.asarray(rp.chop_matmul(
            jnp.asarray(a), jnp.asarray(b), fid,
            chop_output=chop_out)).copy())
        got = tp.chop_matmul(ta, tb, fid, chop_output=chop_out)
        ok, err, share = held(got, want, ta, tb, fid, 70, chop_out)
        assert ok, (err, share)
    # Unchopped inputs: the plain product of the carrier.
    got = tp.chop_matmul(ta, tb, fid, chop_inputs=False, chop_output=False)
    assert torch.equal(got, ta @ tb)


def _simulate_inputs(dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(512) * 10.0 ** rng.integers(-6, 7, 512)
    big = [7e4, -7e4, 5e2, 1e39 if dtype == np.float64 else 3e38, -3e38]
    with np.errstate(over="ignore"):
        x = np.concatenate([x, big, [np.nan, np.inf, -np.inf, 0.0, -0.0,
                                     1.0, 65504.0, 65520.0, 448.0, 464.0]])
    return x.astype(dtype)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_simulate_dtype_equal_to_reference(fmt, dtype):
    x = _simulate_inputs(dtype)
    want = np.asarray(rp.simulate_dtype(jnp.asarray(x), fmt))
    got = tp.simulate_dtype(torch.from_numpy(x.copy()), fmt).numpy()
    assert got.dtype == want.dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    # A FloatFormat object takes the same path as its name.
    got2 = tp.simulate_dtype(torch.from_numpy(x.copy()), tp.FORMATS[fmt])
    np.testing.assert_array_equal(_bits(got2.numpy())[~nan], _bits(got)[~nan])


def test_simulate_dtype_custom_format_takes_chop_static():
    f = tp.FloatFormat("e3m4", t=5, emin=-2, emax=3, xmax=15.5,
                       saturate=True)
    rf = rp.FloatFormat("e3m4", t=5, emin=-2, emax=3, xmax=15.5,
                        saturate=True)
    x = _simulate_inputs(np.float32)
    want = np.asarray(rp.simulate_dtype(jnp.asarray(x), rf))
    got = tp.simulate_dtype(torch.from_numpy(x.copy()), f).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_runtime_tables_equal_to_reference(dtype):
    want = rp.runtime_tables(getattr(jnp, dtype))
    got = tp.runtime_tables(getattr(torch, dtype))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu"
        assert str(g.dtype) == f"torch.{w.dtype}".replace("bool_", "bool")
        np.testing.assert_array_equal(g.numpy(), w)
    assert tp.runtime_tables()[3].dtype == torch.float32
