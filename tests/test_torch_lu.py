"""Torch port vs the JAX package: LU factorizations and the strict
triangular solves.

  * strict `lu_factor` and the strict `solve_unit_lower`/`solve_upper`:
    bit-exact, all seven format ids, float32 and float64 carriers;
  * blocked `lu_factor_blocked`: a tolerance. The blocked LU has two
    carrier dots whose order neither package pins (the `Lpan @ U12` row
    product and the trailing chopped GEMM, DESIGN.md §6.2). Both
    factorizations are backward stable, P A + dA = L U with
    |dA| <= gamma_n |L||U| (gamma_n = n u / (1 - n u), u the unit
    roundoff of the format, or of the carrier when the format is wider),
    so the two products may differ by 2 gamma_n |L_ref||U_ref| per entry.
    Pivots and the failure flag must be equal. Where n u >= 1 (fp8 at
    n = 40) the bound says nothing and only those two are held.

The JAX side runs `JnpBackend` under jit, as its solvers do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.data.matrices import randsvd_dense
from repro.precision import FORMAT_LIST, JnpBackend
from repro.solvers import lu_factor as jlu_factor
from repro.solvers import lu_factor_blocked as jlu_factor_blocked
from repro.solvers import solve_unit_lower as jsolve_lower
from repro.solvers import solve_upper as jsolve_upper
from repro_torch.solvers import (lu_factor, lu_factor_blocked,
                                 solve_unit_lower, solve_upper)

FMT_IDS = list(range(len(FORMAT_LIST)))
DTYPES = [np.float32, np.float64]
JNP = JnpBackend()


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


def _system(n, kappa, seed, dtype):
    s = randsvd_dense(n, kappa, np.random.default_rng(seed))
    return s.A.astype(dtype), s.b.astype(dtype)


_jlu = jax.jit(lambda A, f: jlu_factor(A, f, backend=JNP))
_jlu_blk = jax.jit(lambda A, f: jlu_factor_blocked(A, f, block=16,
                                                   backend=JNP))
_jlower = jax.jit(lambda L, b, f: jsolve_lower(L, b, f, backend=JNP))
_jupper = jax.jit(lambda L, b, f: jsolve_upper(L, b, f, backend=JNP))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fid", FMT_IDS)
def test_strict_lu_and_substitution_bitexact(fid, dtype):
    A, b = _system(24, 1e4, fid, dtype)
    want = _jlu(jnp.asarray(A), fid)
    got = lu_factor(torch.from_numpy(A), fid)
    np.testing.assert_array_equal(_bits(got.lu.numpy()), _bits(want.lu))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert bool(got.fail) == bool(want.fail)

    LU = np.asarray(want.lu)
    for jf, tf in ((_jlower, solve_unit_lower), (_jupper, solve_upper)):
        w = jf(jnp.asarray(LU), jnp.asarray(b), fid)
        g = tf(torch.from_numpy(LU.copy()), torch.from_numpy(b), fid)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fid", FMT_IDS)
def test_blocked_lu_within_backward_error(fid, dtype):
    n = 40                      # identity-padded to 48 inside both LUs
    A, _ = _system(n, 1e3, 10 + fid, dtype)
    want = _jlu_blk(jnp.asarray(A), fid)
    got = lu_factor_blocked(torch.from_numpy(A), fid, block=16)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert bool(got.fail) == bool(want.fail)

    f = FORMAT_LIST[fid]
    u = max(2.0 ** -f.t, 2.0 ** -(24 if dtype == np.float32 else 53))
    if n * u >= 1:
        return
    gamma = n * u / (1 - n * u)

    def lu_parts(M):
        M = np.asarray(M, np.float64)
        return np.tril(M, -1) + np.eye(n), np.triu(M)

    Lr, Ur = lu_parts(want.lu)
    Lp, Up = lu_parts(got.lu.numpy())
    diff = np.abs(Lp @ Up - Lr @ Ur)
    assert np.all(diff <= 2 * gamma * (np.abs(Lr) @ np.abs(Ur)))
