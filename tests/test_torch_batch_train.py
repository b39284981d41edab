"""Torch port vs the JAX package: batched solves and the bandit loop.

  * `gmres_ir_batch`: eight padded systems (the seven format ids and one
    mixed action) through the vmapped reference (`solve_fixed_batch`, the
    route the reference engine takes, so the training test below reuses
    its compiled programs) and through the port's row loop, on the strict
    path (float64) and the blocked path (float64 and float32). Rows whose factorization the reference pins
    (test_torch_gmres_ir.py says which) are held as the single solves are:
    status/n_outer/n_gmres equal, ferr/nbe/res_norm within 4 eps. Every
    batch row equals the port's single solve of that row bit for bit (one
    row checked: the batch is a loop over the single solve).
  * `train_policy` + `evaluate_policy` in both packages on the same seeded
    systems, two buckets (32 strict, 48 blocked), float64 carrier:
    equal visit counts, equal greedy action in every state, equal
    evaluation picks, and Q within 1e-9. Rewards depend on a solve only
    through status, n_gmres and log10 of ferr/nbe floored at 1e-10
    (`RewardConfig.eps`), so solves that agree to 4 eps move Q by
    ~1e-15 per update.
  * `policy_from_reference`: the JAX package's trained arrays build a
    port policy that predicts what the reference policy predicts.
  * `evaluate_fixed_action` (the all-fp64 baseline) on the trained
    engines: equal counts and success rates; ferr/nbe within 4 eps on
    the strict bucket (the blocked bucket's fp64 factorization is not
    pinned, test_torch_gmres_ir.py says why).
  * The same for CG-IR: `cg_ir_batch` on sparse SPD rows (kappa 1e1-1e5)
    with different actions against the reference's vmapped batch, held
    as test_torch_cg_ir.py holds single solves, one row bit-equal to the
    port's single solve; `CGIRTask` through `train_policy`,
    `evaluate_policy` and `evaluate_fixed_action` against the
    reference's, to the tolerances above; and `policy_from_reference`
    carrying the reference's CG-trained policy into the port, where it
    picks the reference's greedy actions on the port's `CGIRTask`.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro.solvers.cg as jcg_mod
from repro.core.batching import solve_fixed_batch as jsolve_fixed_batch
from repro.data.matrices import pad_system as jpad_system
from repro.data.matrices import randsvd_dense as jrandsvd_dense
from repro.data.matrices import sparse_spd as jsparse_spd
from repro.precision import FORMAT_LIST, JnpBackend
from repro.solvers import BlockingPolicy as JBlocking
from repro.solvers import IRConfig as JIRConfig
from repro.solvers.cg import CGConfig as JCGConfig
from repro.tasks import CGIRTask as JCGIRTask
from repro.tasks import GMRESIRTask as JGMRESIRTask
from repro_torch import core as tcore
from repro_torch.data.matrices import randsvd_dense, sparse_spd
from repro_torch.solvers import (BlockingPolicy, CGConfig, IRConfig, cg_ir,
                                 cg_ir_batch, gmres_ir, gmres_ir_batch)
from repro_torch.tasks import CGIRTask, GMRESIRTask

CFG = dict(tau=1e-5, i_max=4, m_max=12)
BLK = dict(min_n=48, lu_block=16, trisolve_block=16)
JCFG = JIRConfig(**CFG, blocking=JBlocking(**BLK))
TCFG = IRConfig(**CFG, blocking=BlockingPolicy(**BLK))
CHUNK = 8
ACTIONS = np.array([[f] * 4 for f in range(len(FORMAT_LIST))]
                   + [[2, 3, 5, 6]], np.int32)


def _batch(n_pad, seed, make=jrandsvd_dense):
    """CHUNK systems `make(n, kappa, rng)` padded to n_pad, stacked."""
    rng = np.random.default_rng(seed)
    rows = [jpad_system(make(int(rng.integers(n_pad - 12, n_pad + 1)),
                             10.0 ** rng.uniform(1, 5), rng),
                        n_pad) for _ in range(CHUNK)]
    return tuple(np.stack(r) for r in zip(*rows))


def _jspd(n, kappa, rng):
    return jsparse_spd(n, 0.05, rng, kappa)


def _spd(n, kappa, rng):
    return sparse_spd(n, 0.05, rng, kappa)


def _lu_pinned(n_pad, carrier, uf):
    t_carrier = 24 if carrier == "float32" else 53
    return n_pad < BLK["min_n"] or FORMAT_LIST[uf].t < t_carrier


@pytest.mark.parametrize("n_pad, carrier", [(32, "float64"),
                                            (48, "float64"),
                                            (48, "float32")])
def test_gmres_ir_batch_matches_reference(n_pad, carrier):
    A, b, x = _batch(n_pad, seed=n_pad)
    # JnpBackend() for float64 is the backend the training test's engine
    # uses, so the two tests share one compiled reference per bucket.
    bk = JnpBackend(carrier_dtype="float32" if carrier == "float32"
                    else None)
    recs = jsolve_fixed_batch(list(A), list(b), list(x), list(ACTIONS), JCFG,
                              CHUNK, backend=bk)
    got = gmres_ir_batch(A, b, x, ACTIONS, TCFG, device="cpu",
                         carrier_dtype=carrier)
    k = CHUNK - 1
    single = gmres_ir(A[k], b[k], x[k], ACTIONS[k], TCFG, device="cpu",
                      carrier_dtype=carrier)
    for field, g, s in zip(got._fields, got, single):
        np.testing.assert_array_equal(g[k].numpy(), s.numpy(), err_msg=field)
    rtol = 4 * float(np.finfo(carrier).eps)
    for k in range(CHUNK):
        if not _lu_pinned(n_pad, carrier, ACTIONS[k][0]):
            continue
        for field in ("status", "n_outer", "n_gmres"):
            assert int(getattr(got, field)[k]) == \
                getattr(recs[k], field), (k, field)
        for field in ("ferr", "nbe", "res_norm"):
            np.testing.assert_allclose(
                float(getattr(got, field)[k]), getattr(recs[k], field),
                rtol=rtol, atol=0, err_msg=f"row {k} {field}")


def _systems(seed=5, count=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(20, 45))
        kappa = 10.0 ** rng.uniform(1, 5)
        out.append((n, kappa, int(rng.integers(1 << 30))))
    return out


def _train(core, make_task, make, episodes=3):
    """Train, evaluate and take the all-fp64 baseline on systems
    `make(n, kappa, rng)`: (task, engine, policy, history, evaluation,
    baseline)."""
    systems = [make(n, k, np.random.default_rng(s))
               for n, k, s in _systems()]
    task = make_task(systems, core.reduced_action_space())
    engine = core.AutotuneEngine(task, chunk=CHUNK)
    cfg = core.TrainConfig(episodes=episodes, n_bins=(3, 2), seed=3)
    policy, hist = core.train_policy(engine, core.W1, cfg)
    ev = core.evaluate_policy(policy, engine, tau_base=1e-6)
    base = core.evaluate_fixed_action(
        engine, engine.action_space.n_actions - 1, 1e-6)
    return task, engine, policy, hist, ev, base


@pytest.fixture(scope="module")
def trained():
    ref = _train(jcore, lambda s, sp: JGMRESIRTask(
        s, sp, ir_cfg=JCFG, bucket_step=16, min_bucket=32,
        backend=JnpBackend()), jrandsvd_dense)
    port = _train(tcore, lambda s, sp: GMRESIRTask(
        s, sp, ir_cfg=TCFG, bucket_step=16, min_bucket=32, device="cpu"),
        randsvd_dense)
    return ref, port


def test_train_policy_matches_reference(trained):
    (jtask, _, jpol, jhist, jev, _), (ttask, _, tpol, thist, tev, _) = \
        trained
    assert sorted({jtask.bucket_key(s) for s in jtask.instances}) == \
        [32, 48]
    assert sorted({ttask.bucket_key(s) for s in ttask.instances}) == \
        [32, 48]
    np.testing.assert_array_equal(tpol.qtable.N, jpol.qtable.N)
    np.testing.assert_allclose(tpol.qtable.Q, jpol.qtable.Q, rtol=0,
                               atol=1e-9)
    for s in range(jpol.qtable.n_states):
        assert tpol.qtable.greedy(s) == jpol.qtable.greedy(s), s
    assert tev["actions"] == jev["actions"]
    assert thist.unique_solves == jhist.unique_solves
    np.testing.assert_allclose(thist.episode_reward, jhist.episode_reward,
                               rtol=0, atol=1e-9)


def test_policy_from_reference_round_trip(trained):
    (jtask, _, jpol, _, _, _), _ = trained
    d = jpol.discretizer
    port = tcore.policy_from_reference(
        jpol.qtable.Q, jpol.qtable.N, d.mins, d.maxs, d.n_bins,
        jpol.action_space.actions)
    np.testing.assert_array_equal(port.action_space.actions,
                                  jpol.action_space.actions)
    np.testing.assert_array_equal(port.action_space.ladder_idx,
                                  jpol.action_space.ladder_idx)
    assert port.action_space.ladder == jpol.action_space.ladder
    rng = np.random.default_rng(0)
    feats = np.concatenate([jtask.features,
                            rng.uniform(-1, 8, (20, 2))])
    for f in feats:
        a_ref, row_ref = jpol.predict(f)
        a_port, row_port = port.predict(f)
        assert a_port == a_ref
        np.testing.assert_array_equal(row_port, row_ref)
    with pytest.raises(ValueError):
        tcore.policy_from_reference(jpol.qtable.Q[:1], jpol.qtable.N[:1],
                                    d.mins, d.maxs, d.n_bins,
                                    jpol.action_space.actions)


def _held_baseline(tbase, jbase, strict):
    """The fixed-action results: equal counts and table rows' sizes and
    success rates; ferr/nbe within 4 eps on the `strict` rows, whose
    factorization the reference pins."""
    assert set(tbase) == set(jbase)
    for key in ("n_outer", "n_inner", "n_gmres"):
        np.testing.assert_array_equal(tbase[key], jbase[key], err_msg=key)
    assert strict.any()
    for key in ("ferr", "nbe"):
        np.testing.assert_allclose(tbase[key][strict], jbase[key][strict],
                                   rtol=4 * np.finfo(np.float64).eps,
                                   atol=0, err_msg=key)
    assert tbase["table"].keys() == jbase["table"].keys()
    for name, row in jbase["table"].items():
        assert tbase["table"][name]["n"] == row["n"]
        assert tbase["table"][name]["xi"] == row["xi"]


def test_evaluate_fixed_action_matches_reference(trained):
    (jtask, _, _, _, _, jbase), (_, _, _, _, _, tbase) = trained
    strict = np.array([jtask.bucket_key(s) < BLK["min_n"]
                       for s in jtask.instances])
    _held_baseline(tbase, jbase, strict)


# --- CG-IR ----------------------------------------------------------------

CG_JCFG = JCGConfig(**CFG, blocking=JBlocking(**BLK))
CG_TCFG = CGConfig(**CFG, blocking=BlockingPolicy(**BLK))


def _held_cg(got, want, carrier, what):
    for field in ("status", "n_outer", "n_cg"):
        assert int(getattr(got, field)) == int(getattr(want, field)), \
            (what, field)
    rtol = 4 * float(np.finfo(carrier).eps)
    for field in ("ferr", "nbe", "res_norm"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=rtol,
                                   atol=0, err_msg=f"{what} {field}")


@pytest.mark.parametrize("n_pad, carrier", [(32, "float64"),
                                            (48, "float64"),
                                            (48, "float32")])
def test_cg_ir_batch_matches_reference(n_pad, carrier):
    A, b, x = _batch(n_pad, seed=n_pad, make=_jspd)
    # JnpBackend() for float64 and the chunk of the CG training test:
    # the two share one compiled reference per bucket.
    bk = JnpBackend(carrier_dtype="float32" if carrier == "float32"
                    else None)
    want = jcg_mod.cg_ir_batch(A, b, x, ACTIONS, CG_JCFG, bk)
    got = cg_ir_batch(A, b, x, ACTIONS, CG_TCFG, device="cpu",
                      carrier_dtype=carrier)
    k = CHUNK - 1
    single = cg_ir(A[k], b[k], x[k], ACTIONS[k], CG_TCFG, device="cpu",
                   carrier_dtype=carrier)
    for field, g, s in zip(got._fields, got, single):
        np.testing.assert_array_equal(g[k].numpy(), s.numpy(), err_msg=field)
    held = 0
    for k in range(CHUNK):
        if not _lu_pinned(n_pad, carrier, ACTIONS[k][0]):
            continue
        _held_cg(type(got)(*(f[k] for f in got)),
                 type(want)(*(np.asarray(f)[k] for f in want)), carrier,
                 f"row {k}")
        held += 1
    assert held >= 6
    assert len({int(s) for s in got.status}) > 1   # not one outcome


@pytest.fixture(scope="module")
def cg_trained():
    ref = _train(jcore, lambda s, sp: JCGIRTask(
        s, sp, cg_cfg=CG_JCFG, bucket_step=16, min_bucket=32,
        backend=JnpBackend()), _jspd)
    port = _train(tcore, lambda s, sp: CGIRTask(
        s, sp, cg_cfg=CG_TCFG, bucket_step=16, min_bucket=32, device="cpu"),
        _spd)
    return ref, port


def test_cg_train_and_evaluate_match_reference(cg_trained):
    (jtask, _, jpol, jhist, jev, _), (ttask, _, tpol, thist, tev, _) = \
        cg_trained
    assert sorted({jtask.bucket_key(s) for s in jtask.instances}) == \
        [32, 48]
    assert sorted({ttask.bucket_key(s) for s in ttask.instances}) == \
        [32, 48]
    np.testing.assert_array_equal(tpol.qtable.N, jpol.qtable.N)
    np.testing.assert_allclose(tpol.qtable.Q, jpol.qtable.Q, rtol=0,
                               atol=1e-9)
    for s in range(jpol.qtable.n_states):
        assert tpol.qtable.greedy(s) == jpol.qtable.greedy(s), s
    assert tev["actions"] == jev["actions"]
    assert thist.unique_solves == jhist.unique_solves
    np.testing.assert_allclose(thist.episode_reward, jhist.episode_reward,
                               rtol=0, atol=1e-9)
    for key in ("n_outer", "n_inner", "n_gmres"):
        np.testing.assert_array_equal(tev[key], jev[key], err_msg=key)
    assert tev["usage_per_solve"] == jev["usage_per_solve"]


def test_cg_evaluate_fixed_action_matches_reference(cg_trained):
    (jtask, _, _, _, _, jbase), (_, _, _, _, _, tbase) = cg_trained
    strict = np.array([jtask.bucket_key(s) < BLK["min_n"]
                       for s in jtask.instances])
    _held_baseline(tbase, jbase, strict)
    # The all-fp64 baseline solves these SPD systems accurately.
    assert np.all(tbase["ferr"] < 1e-6)


def test_cg_policy_from_reference_round_trip(cg_trained):
    (jtask, _, jpol, _, jev, _), (_, tengine, _, _, _, _) = cg_trained
    d = jpol.discretizer
    port = tcore.policy_from_reference(
        jpol.qtable.Q, jpol.qtable.N, d.mins, d.maxs, d.n_bins,
        jpol.action_space.actions)
    for f in jtask.features:
        assert port.predict(f)[0] == jpol.predict(f)[0]
    ev = tcore.evaluate_policy(port, tengine, tau_base=1e-6)
    assert ev["actions"] == jev["actions"]
    np.testing.assert_array_equal(ev["n_inner"], jev["n_inner"])
