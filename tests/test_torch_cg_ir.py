"""Torch port vs the JAX package: CG-IR and its task.

  * Whole `cg_ir` solves, every format id, float32 and float64
    carriers, on the strict path (n = 20) and on the blocked path (n = 20
    with 16-wide blocks, so the blocked LU and trisolve identity-pad to
    32), on seeded sparse SPD systems (`sparse_spd`, kappa 1e3, which the
    float32 carrier resolves). The same system goes through
    `repro.solvers.cg_ir` (JnpBackend, jitted) and
    `repro_torch.solvers.cg_ir(device="cpu")`. Held: `status`,
    `n_outer` and `n_cg` equal; `ferr`, `nbe` and `res_norm` within
    rtol = 4 eps of the carrier (the backward error's final
    `normA * ||x|| + ||b||` is the one operation whose bits the reference
    leaves open on these cases: XLA may contract it into an FMA).
  * Not held to that: the blocked path when the factorization's format
    is not narrower than the carrier (fp32/fp64 on float32, fp64 on
    float64). The blocked LU's carrier dots are not rounded afterwards
    and neither package pins their order (DESIGN.md §6.2), so the
    factors differ in the last bits and the refinement may take another
    path; the JAX package's own backends disagree on exactly these cases
    (`test_cg_ir_blocked_path_bitexact[5, 6]`, ROADMAP.md Queue 3). For
    them the port's refinement runs on the reference's own factors and
    is held as above.
  * `pcg` alone, on the reference's factors of the same system, bit for
    bit in `z`, `iters` and `fail`, on the SPD system and on an
    indefinite one (the breakdown path: non-positive curvature).
  * Whole solves of the indefinite system: FAILED after CG iterations,
    every field as above.
  * `adapt_legacy` / `coerce_task` take a `CGConfig`; the entry points
    raise without CUDA unless given `device="cpu"`.

`cg_ir_batch` and the bandit loop on `CGIRTask` are held in
test_torch_batch_train.py, where they share the reference's compiled
batch programs.
"""
import jax
import numpy as np
import pytest
import torch

import repro.solvers.cg as jcg_mod
from repro.data.matrices import sparse_spd as jsparse_spd
from repro.precision import FORMAT_LIST, JnpBackend
from repro.solvers import BlockingPolicy as JBlocking
from repro.solvers import lu_factor_auto as jlu_factor_auto
from repro.solvers.cg import CGConfig as JCGConfig
from repro_torch import core as tcore
from repro_torch.solvers import (FAILED, BlockingPolicy, CGConfig, LUFactors,
                                 cg_ir, cg_ir_batch, pcg)
from repro_torch.solvers import ir as tir
from repro_torch.tasks import CGIRTask, adapt_legacy

FMT_IDS = list(range(len(FORMAT_LIST)))
N = 20
BLK = dict(min_n=16, lu_block=16, trisolve_block=16)
CFG = dict(tau=1e-5, i_max=4, m_max=12)
PATHS = {
    "strict": (JCGConfig(**CFG), CGConfig(**CFG)),
    "blocked": (JCGConfig(**CFG, blocking=JBlocking(**BLK)),
                CGConfig(**CFG, blocking=BlockingPolicy(**BLK))),
}
CARRIERS = {"float32": JnpBackend(carrier_dtype="float32"),
            "float64": JnpBackend()}


def _spd(seed, n=N):
    s = jsparse_spd(n, 0.05, np.random.default_rng(seed), 1e3)
    return s.A, s.b, s.x_true


def _indefinite(seed, n=N):
    """Symmetric, a third of its eigenvalues negative: CG's curvature
    p^T A p turns non-positive."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1, 10, n) * np.where(np.arange(n) % 3 == 0, -1, 1)
    A = (q * lam) @ q.T
    x = rng.standard_normal(n)
    return A, A @ x, x


def _lu_pinned(path, carrier, fid):
    """The blocked LU's bits are pinned only when its format rounds below
    the carrier (every dot result is rounded then)."""
    t_carrier = 24 if carrier == "float32" else 53
    return path == "strict" or FORMAT_LIST[fid].t < t_carrier


def _held(got, want, carrier, what=""):
    for field in ("status", "n_outer", "n_cg"):
        assert int(getattr(got, field)) == int(getattr(want, field)), \
            (what, field)
    rtol = 4 * float(np.finfo(carrier).eps)
    for field in ("ferr", "nbe", "res_norm"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=rtol,
                                   atol=0, err_msg=f"{what} {field}")


_REF_FN = {}


def _reference_programs(path, carrier):
    """Jitted reference LU and pcg for one (path, carrier), compiled once
    and shared by the format ids (runtime arguments)."""
    key = (path, carrier)
    if key not in _REF_FN:
        jcfg = PATHS[path][0]
        bk = CARRIERS[carrier]
        lu = jax.jit(lambda M, f: jlu_factor_auto(M, f, backend=bk,
                                                  blocking=jcfg.blocking))
        run = jax.jit(lambda M, LU, p, r, f: jcg_mod.pcg(
            M, LU, p, r, f, m_max=jcfg.m_max, tol=jcfg.tol_inner,
            backend=bk, blocking=jcfg.blocking))
        _REF_FN[key] = (lu, run)
    return _REF_FN[key]


def _reference_factors(A, fid, path, carrier):
    lu = _reference_programs(path, carrier)[0](np.asarray(A, carrier), fid)
    return LUFactors(torch.tensor(np.asarray(lu.lu)),
                     torch.tensor(np.asarray(lu.perm)).long(),
                     torch.tensor(bool(lu.fail)))


@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fid", FMT_IDS)
def test_cg_ir_matches_reference(fid, path, carrier, monkeypatch):
    A, b, x = _spd(fid)
    jcfg, tcfg = PATHS[path]
    action = np.full(4, fid, np.int32)
    want = jcg_mod.cg_ir(A, b, x, action, jcfg, CARRIERS[carrier])
    if not _lu_pinned(path, carrier, fid):
        # The refinement on the reference's own factors (module
        # docstring).
        factors = _reference_factors(A, fid, path, carrier)
        # The refinement factors a batch (of one system here).
        monkeypatch.setattr(tir, "lu_factor_auto",
                            lambda *args, **kw: LUFactors(*(
                                f[None] for f in factors)))
    got = cg_ir(A, b, x, action, tcfg, device="cpu", carrier_dtype=carrier)
    _held(got, want, carrier)


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("fid", FMT_IDS)
def test_pcg_matches_reference_on_the_same_factors(fid, path, carrier, kind):
    A, b, _ = (_spd if kind == "spd" else _indefinite)(fid)
    A, b = (np.asarray(v, carrier) for v in (A, b))
    jlu, jrun = _reference_programs(path, carrier)
    lu = jlu(A, fid)
    want = jrun(A, lu.lu, lu.perm, b, fid)
    tcfg = PATHS[path][1]
    got = pcg(torch.from_numpy(A), torch.tensor(np.asarray(lu.lu)),
              torch.tensor(np.asarray(lu.perm)).long(), torch.from_numpy(b),
              fid, m_max=tcfg.m_max, tol=tcfg.tol_inner,
              blocking=tcfg.blocking)
    assert got.iters == int(want.iters)
    assert got.fail == bool(want.fail)
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))


@pytest.mark.parametrize("action", [[2, 2, 2, 2], [0, 4, 4, 4],
                                    [2, 5, 5, 5]])
@pytest.mark.parametrize("carrier", list(CARRIERS))
@pytest.mark.parametrize("path", list(PATHS))
def test_cg_ir_breakdown_matches_reference(path, carrier, action):
    """The indefinite system: CG's curvature turns non-positive, the
    solve FAILS after CG iterations, and every field is held."""
    A, b, x = _indefinite(0)
    jcfg, tcfg = PATHS[path]
    want = jcg_mod.cg_ir(A, b, x, np.asarray(action, np.int32), jcfg,
                         CARRIERS[carrier])
    got = cg_ir(A, b, x, action, tcfg, device="cpu", carrier_dtype=carrier)
    assert int(want.status) == FAILED and int(want.n_cg) > 0
    _held(got, want, carrier)


def test_adapt_legacy_takes_a_cg_config(monkeypatch):
    """A bare `CGConfig` becomes a `CGIRTask` (on the CPU here, through a
    stand-in for the default device)."""
    import repro_torch.tasks.base as tbase
    monkeypatch.setattr(tbase, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    cfg = CGConfig(tau=1e-7)
    for task in (adapt_legacy(cfg), tcore.coerce_task(cfg)):
        assert isinstance(task, CGIRTask) and task.cg_cfg is cfg
        assert task.name == "cg_ir" and task.inner_iter_metric == "n_cg"
    with pytest.raises(TypeError, match="CGConfig"):
        adapt_legacy(object())


def test_cg_entry_points_without_device_raise_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.solvers import tuned_blocking
    A, b, x = _spd(0, n=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_ir(A, b, x, [6, 6, 6, 6])
    with pytest.raises(RuntimeError, match="CUDA"):
        cg_ir_batch(A[None], b[None], x[None], [[6, 6, 6, 6]])
    with pytest.raises(RuntimeError, match="CUDA"):
        CGIRTask()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.evaluate_fixed_action(CGConfig(), 0, 1e-6)
    with pytest.raises(RuntimeError, match="CUDA"):
        tuned_blocking(256)
    # Asked for the CPU, the same calls run the plain versions.
    st = cg_ir(A, b, x, [6, 6, 6, 6], device="cpu")
    assert int(st.status) == 0 and float(st.ferr) < 1e-12
