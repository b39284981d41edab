"""Torch port vs the JAX package: whole GMRES-IR solves.

Every format id, float32 and float64 carriers, on the strict path
(n = 20) and on the blocked path (n = 20 with 16-wide blocks, so the
blocked LU and trisolve identity-pad to 32). The same seeded system goes
through `repro.solvers.gmres_ir` (JnpBackend, jitted) and
`repro_torch.solvers.gmres_ir(device="cpu")`.

Held: `status`, `n_outer` and `n_gmres` equal; `ferr`, `nbe` and
`res_norm` within rtol = 4 eps of the carrier. The one operation of the
solve whose bits the reference leaves open on these cases is the final
`normA * ||x|| + ||b||` of the backward error, which XLA may contract
into an FMA (one rounding apart, i.e. within 2 ulp of nbe).

GMRES with u_g = fp64 on the float64 carrier (ROADMAP.md Queue 3) is
traced to the Givens step, which the reference leaves unrounded and
XLA:CPU contracts: `test_gmres_fp64_queue3_traced_to_the_givens_step`.

Not held to that: the blocked path when the factorization's format is
not narrower than the carrier (fp32/fp64 on float32, fp64 on float64).
There the blocked LU's carrier dots (`lu.py` `Lpan @ U12` and the
trailing chopped GEMM) are not rounded afterwards, their order is pinned
by neither package (DESIGN.md §6.2), and the factors differ in the last
bits (held to the backward-error bound in test_torch_lu.py); the solve
that follows may then take another path. The JAX package's own two
backends disagree on exactly these cases. For them the test holds what
follows the factorization: GMRES on the reference's own factors must
agree bit for bit. ROADMAP.md Queue 3 records the cases.
"""
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.data.matrices import generate_dense_set, pad_system, randsvd_dense
from repro.precision import FORMAT_LIST, JnpBackend
from repro.solvers import BlockingPolicy as JBlocking
from repro.solvers import IRConfig as JIRConfig
from repro.solvers import gmres_ir as jgmres_ir
from repro.solvers import gmres_precond as jgmres_precond
from repro.solvers import lu_factor_auto as jlu_factor_auto
from repro_torch.solvers import BlockingPolicy, IRConfig, gmres_ir
from repro_torch.solvers import gmres as tgmres
from repro_torch.solvers.gmres import gmres_precond

FMT_IDS = list(range(len(FORMAT_LIST)))
N = 20
BLK = dict(min_n=16, lu_block=16, trisolve_block=16)
CFG = dict(tau=1e-5, i_max=4, m_max=12)
PATHS = {
    "strict": (JIRConfig(**CFG), IRConfig(**CFG)),
    "blocked": (JIRConfig(**CFG, blocking=JBlocking(**BLK)),
                IRConfig(**CFG, blocking=BlockingPolicy(**BLK))),
}
CARRIERS = {"float32": JnpBackend(carrier_dtype="float32"),
            "float64": JnpBackend()}


def _system(seed):
    s = randsvd_dense(N, 1e3, np.random.default_rng(seed))
    return s.A, s.b, s.x_true


def _lu_pinned(path, carrier, fid):
    """The blocked LU's bits are pinned only when its format rounds below
    the carrier (every dot result is rounded then)."""
    t_carrier = 24 if carrier == "float32" else 53
    return path == "strict" or FORMAT_LIST[fid].t < t_carrier


@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fid", FMT_IDS)
def test_gmres_ir_matches_reference(fid, path, carrier):
    A, b, x = _system(fid)
    jcfg, tcfg = PATHS[path]
    if not _lu_pinned(path, carrier, fid):
        _check_gmres_on_reference_factors(A, b, fid, jcfg, tcfg, carrier)
        return
    got, want = _solve_both(fid, path, carrier)
    for field in ("status", "n_outer", "n_gmres"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    rtol = 4 * float(np.finfo(carrier).eps)
    for field in ("ferr", "nbe", "res_norm"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=rtol, atol=0, err_msg=field)


def _solve_both(fid, path, carrier):
    A, b, x = _system(fid)
    jcfg, tcfg = PATHS[path]
    action = np.full(4, fid, np.int32)
    want = jgmres_ir(A, b, x, action, jcfg, CARRIERS[carrier])
    got = gmres_ir(A, b, x, action, tcfg, device="cpu",
                   carrier_dtype=carrier)
    return got, want


_REF_FN = {}


def _reference_lu_and_gmres(jcfg, carrier):
    """Jitted reference LU + GMRES for one (config, carrier), compiled
    once and shared by the format ids (runtime arguments)."""
    key = (jcfg, carrier)
    if key not in _REF_FN:
        bk = CARRIERS[carrier]
        lu = jax.jit(lambda M, f: jlu_factor_auto(M, f, backend=bk,
                                                  blocking=jcfg.blocking))
        run = jax.jit(lambda M, LU, p, r, f: jgmres_precond(
            M, LU, p, r, f, m_max=jcfg.m_max, tol=jcfg.tol_inner,
            backend=bk, blocking=jcfg.blocking))
        _REF_FN[key] = (lu, run)
    return _REF_FN[key]


def _check_gmres_on_reference_factors(A, b, fid, jcfg, tcfg, carrier):
    A, b = (np.asarray(v, carrier) for v in (A, b))
    jlu, jrun = _reference_lu_and_gmres(jcfg, carrier)
    lu = jlu(A, fid)
    want = jrun(A, lu.lu, lu.perm, b, fid)
    got = gmres_precond(torch.from_numpy(A), torch.tensor(np.asarray(lu.lu)),
                        torch.tensor(np.asarray(lu.perm)).long(),
                        torch.from_numpy(b), fid, m_max=tcfg.m_max,
                        tol=tcfg.tol_inner, blocking=tcfg.blocking)
    assert got.iters == int(want.iters)
    assert got.fail == bool(want.fail)
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    np.testing.assert_array_equal(got.res_rel.numpy(),
                                  np.asarray(want.res_rel))


# ROADMAP.md Queue 3: GMRES with u_g = fp64 on the float64 carrier. There
# `chop` is the identity and the reference's Givens step is plain carrier
# arithmetic (src/repro/solvers/gmres.py:122-123, 127) that XLA compiles
# as it likes: on the CPU it contracts the rotation's second row
# `-sn * hi + cs * hi1` into fma(cs, hi1, -(sn * hi)) and the norm's
# `hj * hj + hj1 * hj1` into fma(hj, hj, hj1 * hj1). The port rounds each
# product, then the sum (`gmres._rotate`, `gmres._sum_squares`). So the
# reference leaves these bits to its compiler, and the port is held to a
# tolerance here: the same iterations and res_rel, z within 4 kappa eps
# of the reference's, and the whole solve's status and counts equal with
# ferr within 4 kappa_est eps. With those two operations contracted as
# XLA contracts them, the port equals the reference bit for bit: that
# traces the difference to them.


def _fma(a, b, c):
    """a * b + c rounded once, as an FMA rounds it (exact through
    fractions), a 0-dim float64 tensor."""
    return torch.tensor(float(Fraction(float(a)) * Fraction(float(b))
                              + Fraction(float(c))), dtype=torch.float64)


def _xla_rotate(c, s, hi, hi1):
    return c * hi + s * hi1, _fma(c, hi1, -s * hi)


def _xla_sum_squares(a, b):
    return _fma(a, a, b * b)


def _queue3_case():
    """The case of the record: the eighth system of the JAX service
    tests' generator, n 13, kappa_est 4.6e6, identity-padded to 16."""
    s = generate_dense_set(8, np.random.default_rng(0), n_range=(8, 13),
                           log10_kappa_range=(1, 8))[7]
    return s, pad_system(s, 16)


@pytest.mark.parametrize("contracted", [False, True],
                         ids=["port", "xla_contractions"])
def test_gmres_fp64_queue3_traced_to_the_givens_step(monkeypatch,
                                                     contracted):
    s, (A, b, x) = _queue3_case()
    kappa = s.features["kappa_est"]
    assert s.n == 13 and 4e6 < kappa < 5e6
    if contracted:
        monkeypatch.setattr(tgmres, "_rotate", _xla_rotate)
        monkeypatch.setattr(tgmres, "_sum_squares", _xla_sum_squares)
    jcfg, tcfg = JIRConfig(), IRConfig()
    jlu, jrun = _reference_lu_and_gmres(jcfg, "float64")
    # The first inner solve (x0 = 0, so r = b) on the same factors (the
    # two packages' fp16 factors are bit-equal).
    lu = jlu(A, 3)
    want = jrun(A, lu.lu, lu.perm, b, 6)
    got = gmres_precond(torch.from_numpy(A), torch.tensor(np.asarray(lu.lu)),
                        torch.tensor(np.asarray(lu.perm)).long(),
                        torch.from_numpy(b), 6, m_max=tcfg.m_max,
                        tol=tcfg.tol_inner)
    zw = np.asarray(want.z)
    assert got.iters == int(want.iters) and not got.fail
    np.testing.assert_array_equal(got.res_rel.numpy(),
                                  np.asarray(want.res_rel))
    if contracted:
        np.testing.assert_array_equal(got.z.numpy(), zw)
    else:
        err = np.abs(got.z.numpy() - zw).max()
        assert err <= 4 * kappa * EPS64 * np.abs(zw).max(), err
    for uf in (3, 4):           # fp16 or tf32 factors, as recorded
        action = np.array([uf, 6, 6, 6], np.int32)
        w = jgmres_ir(A, b, x, action, jcfg, CARRIERS["float64"])
        g = gmres_ir(A, b, x, action, tcfg, device="cpu")
        for field in ("status", "n_outer", "n_gmres"):
            assert int(getattr(g, field)) == int(getattr(w, field)), field
        if contracted:
            for field in ("ferr", "res_norm"):
                np.testing.assert_array_equal(
                    getattr(g, field).numpy(), np.asarray(getattr(w, field)))
            np.testing.assert_allclose(g.nbe.numpy(), np.asarray(w.nbe),
                                       rtol=4 * EPS64, atol=0)
        else:
            assert abs(float(g.ferr) - float(w.ferr)) <= 4 * kappa * EPS64


EPS64 = float(np.finfo(np.float64).eps)


if __name__ == "__main__":
    # Report which held cases are bit-equal, field by field:
    #   PYTHONPATH=src python tests/test_torch_gmres_ir.py
    jax.config.update("jax_enable_x64", True)
    equal = held = 0
    for carrier in CARRIERS:
        for path in PATHS:
            for fid in FMT_IDS:
                if not _lu_pinned(path, carrier, fid):
                    print(f"{carrier} {path} fid={fid}: held on the "
                          "reference's factors")
                    continue
                got, want = _solve_both(fid, path, carrier)
                diff = [f for f in got._fields if not np.array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)))]
                held += 1
                equal += not diff
                print(f"{carrier} {path} fid={fid}: "
                      + ("bit-equal" if not diff else f"differ in {diff}"))
    print(f"{equal} of {held} held cases bit-equal in every field")
