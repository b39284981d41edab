"""AOT warmup of the torch port (`repro_torch.core.aot`, the dispatch of
`repro_torch.core.executor`, the tasks' warm batches, the server's
``warmup=``) against the JAX package's (`repro.core.aot`), on the CPU.

  * The planning layer — `bucket_traffic`, `order_buckets`, `plan`,
    including a trajectory log with bad lines — and `stack_fixed` equal
    the JAX package's on the same inputs (`stack_fixed` bit for bit).
  * `enable_persistent_cache`: a no-op without a directory, idempotent
    with one, in both packages (the JAX one with `jax.config` replaced
    by a recorder, so that the worker's compilation cache is left as
    it is); the port's maps onto the kernel library's build directory,
    which does not move once the library is loaded.
  * The contracts of the JAX package's `tests/test_aot.py`, ported (n
    12-14, bucket 16, `IRConfig(i_max=4, m_max=12)`, the plain versions
    on the CPU): two tasks over one (cfg, device, carrier) share one
    dispatcher and its cells; a warm engine's `precompile` runs nothing;
    ``warmup="sync"`` is ready before traffic, and its first two
    requests run no cold cell and build no dispatcher;
    ``warmup="background"`` flips `/readyz` per bucket in trajectory
    order under a `pace` semaphore; a warmed server's first outcome is
    bit-equal to a cold server's. Each test that runs cells uses its own
    `tau`, so that its dispatcher is new (the dispatchers are
    process-wide).
  * Servers over a stub task with no dispatchable form report the same
    warmup state in both packages (the sweep's fail-open path), and the
    port's `ShadowServer` passes `warmup_buckets` to its primary.

The JAX server is not booted with a real task (its compile takes 10-20
s); the card's side (0 cold launches on a warmed server's first
request, a warm restart with 0 misses) is in `tests/test_torch_cuda.py`
under ``-m cuda``.
"""
import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.core.aot as raot
import repro.obs.metrics as rmetrics
import repro.service as rsvc
import repro.tasks.base as rbase
import repro_torch.core.aot as taot
import repro_torch.core.executor as EX
import repro_torch.obs.metrics as tmetrics
import repro_torch.service as tsvc
from repro.core import bandit as rbandit
from repro.core import discretize as rdisc
from repro.core import policy as rpolicy
from repro.core import task as rtask
from repro.core.action_space import reduced_action_space as r_space
from repro.core.engine import AutotuneEngine as REngine
from repro_torch.core import bandit as tbandit
from repro_torch.core import discretize as tdisc
from repro_torch.core import policy as tpolicy
from repro_torch.core import task as ttask
from repro_torch.core.action_space import reduced_action_space as t_space
from repro_torch.core.engine import AutotuneEngine
from repro_torch.core.features import PAPER_FEATURES
from repro_torch.data.matrices import generate_dense_set
from repro_torch.kernels import library
from repro_torch.obs import Observability
from repro_torch.solvers import IRConfig
from repro_torch.tasks import GMRESIRTask
from repro_torch.tasks.base import stack_fixed

REF = dict(svc=rsvc, bandit=rbandit, disc=rdisc, policy=rpolicy,
           task=rtask, space=r_space)
PORT = dict(svc=tsvc, bandit=tbandit, disc=tdisc, policy=tpolicy,
            task=ttask, space=t_space)
SPACE = t_space()
BCFG = tsvc.BatcherConfig(max_batch=2, max_wait_s=0.001, bucket_step=16,
                          min_bucket=16)
HTTP_TIMEOUT = 10.0


@pytest.fixture(autouse=True)
def private_default_registries(monkeypatch):
    """Each package's process-default metrics registry is a fresh one
    for this test only (the engines, the warmup sweep and the
    dispatchers count there)."""
    monkeypatch.setattr(rmetrics, "_DEFAULT_REGISTRY",
                        rmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "_DEFAULT_REGISTRY",
                        tmetrics.MetricsRegistry())


def _ir(tau):
    return IRConfig(tau=tau, i_max=4, m_max=12)


def _task(tau, systems=(), **kw):
    return GMRESIRTask(systems, SPACE, _ir(tau), bucket_step=16,
                       min_bucket=16, device="cpu", **kw)


def _policy():
    nf = len(PAPER_FEATURES)
    feats = np.random.default_rng(0).normal(size=(8, nf))
    disc = tdisc.Discretizer.fit(feats, [2] * nf)
    return tpolicy.PrecisionPolicy(
        SPACE, disc, tbandit.QTable(disc.n_states, SPACE.n_actions))


def _systems(k, seed=0):
    return generate_dense_set(k, np.random.default_rng(seed),
                              n_range=(12, 14), log10_kappa_range=(3, 4))


def _readyz(url):
    try:
        with urllib.request.urlopen(url + "/readyz",
                                    timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        finally:
            e.close()


# ---------------------------------------------------------------------------
# The planning layer and stack_fixed, against the JAX package
# ---------------------------------------------------------------------------

TRAJ_LINES = ([json.dumps({"bucket": 48})] * 3
              + [json.dumps({"bucket": 16}), json.dumps({"other": 1}),
                 "not json", "", json.dumps({"bucket": "32"}),
                 json.dumps([1, 2])])


@pytest.mark.parametrize("case", [
    "no traffic", "explicit traffic", "trajectory log", "log and traffic",
    "missing log", "no log", "plan", "plan with log"])
def test_planning_layer_matches_reference(case, tmp_path):
    log = tmp_path / "traj.jsonl"
    log.write_text("\n".join(TRAJ_LINES) + "\n")
    buckets, traffic, path = [48, 16, 32], None, None
    if case == "explicit traffic":
        traffic = {32: 5, 48: 5}
    elif case in ("trajectory log", "plan with log"):
        path = str(log)
    elif case == "log and traffic":
        traffic, path = {16: 1, 32: 3}, str(log)
    elif case == "missing log":
        path = str(tmp_path / "missing.jsonl")
    if case.startswith("plan"):
        t1, t2 = object(), object()
        got = taot.plan([t1, t2], buckets, chunk=4, traffic={32: 9},
                        trajectory_path=path)
        want = raot.plan([t1, t2], buckets, chunk=4, traffic={32: 9},
                         trajectory_path=path)
        assert [(e.task, e.bucket, e.chunk) for e in got] == \
            [(e.task, e.bucket, e.chunk) for e in want]
        assert [e.labels() for e in got] == [e.labels() for e in want]
        return
    assert taot.bucket_traffic(path) == raot.bucket_traffic(path)
    assert taot.order_buckets(buckets, traffic, path) == \
        raot.order_buckets(buckets, traffic, path)


@pytest.mark.parametrize("k,chunk", [(1, 1), (1, 4), (3, 4), (4, 4)])
def test_stack_fixed_bit_for_bit(k, chunk):
    rng = np.random.default_rng(k * 10 + chunk)
    rows = [(rng.normal(size=(16, 16)), rng.normal(size=16),
             rng.normal(size=16)) for _ in range(k)]
    acts = [rng.integers(0, 7, size=4) for _ in range(k)]
    got, want = stack_fixed(rows, acts, chunk), \
        rbase.stack_fixed(rows, acts, chunk)
    assert got[-1] == want[-1] == k
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# The persistent build cache
# ---------------------------------------------------------------------------

class _RecordingConfig:
    """Stands in for `jax.config` while the JAX package's
    `enable_persistent_cache` runs: records the updates."""

    def __init__(self):
        self.updates = []

    def update(self, name, value):
        self.updates.append((name, value))


@pytest.fixture
def fresh_caches(monkeypatch):
    """Both packages' cache state as in a fresh process, restored after
    the test: no directory enabled, no environment variable, and the
    port's library not loaded, building in its default directory."""
    import jax
    rec = _RecordingConfig()
    monkeypatch.delenv(raot.ENV_CACHE_DIR, raising=False)
    monkeypatch.setattr(jax, "config", rec)
    monkeypatch.setattr(raot, "_cache_dir", None)
    monkeypatch.setattr(raot, "_listener_installed", True)
    monkeypatch.setattr(taot, "_cache_dir", None)
    monkeypatch.setattr(library, "BUILD_DIR", library.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(library, "_LIB", None)
    return rec


def test_enable_persistent_cache_noop_and_idempotent(fresh_caches,
                                                     tmp_path,
                                                     monkeypatch):
    # No kwarg, no env: nothing changes in either package.
    assert taot.enable_persistent_cache() is None
    assert raot.enable_persistent_cache() is None
    assert taot.cache_stats()["dir"] == raot.cache_stats()["dir"] is None
    assert library.BUILD_DIR == library.DEFAULT_BUILD_DIR
    # With a directory: that directory, twice; the port builds there.
    d = str(tmp_path / "cache")
    for _ in range(2):
        assert taot.enable_persistent_cache(d) == \
            raot.enable_persistent_cache(d) == d
    assert taot.cache_stats()["dir"] == raot.cache_stats()["dir"] == d
    assert library.BUILD_DIR == tmp_path / "cache"
    assert library.library_path().parent == tmp_path / "cache"
    assert ("jax_compilation_cache_dir", d) in fresh_caches.updates
    # No kwarg now returns the directory in force; so does the env var.
    assert taot.enable_persistent_cache() == raot.enable_persistent_cache()
    monkeypatch.setenv(raot.ENV_CACHE_DIR, d)
    assert taot.enable_persistent_cache() == \
        raot.enable_persistent_cache() == d


def test_build_dir_fixed_once_the_library_is_loaded(fresh_caches,
                                                    tmp_path):
    assert library.set_build_dir(tmp_path / "a") == tmp_path / "a"
    library._LIB = object()                  # as after the first load
    assert library.set_build_dir(tmp_path / "b") == tmp_path / "a"
    assert taot.enable_persistent_cache(str(tmp_path / "b")) == \
        str(tmp_path / "a")
    assert library.BUILD_DIR == tmp_path / "a"


def test_cache_stats_mirrors_hits_and_misses(monkeypatch):
    monkeypatch.setattr(library, "CACHE", {"hits": 2, "misses": 1})
    monkeypatch.setattr(taot, "_mirrored", {"hits": 0, "misses": 0})
    reg = tmetrics.default_registry()
    for _ in range(2):                       # mirrored once, not twice
        stats = taot.cache_stats()
    assert (stats["hits"], stats["misses"]) == (2, 1)
    library.CACHE["misses"] += 1
    taot.cache_stats()
    value = {f.name: f.samples()[0][1].value for f in reg.collect()}
    assert value["repro_compile_cache_hits_total"] == 2
    assert value["repro_compile_cache_misses_total"] == 2


def test_cold_launch_record_outlives_reset(monkeypatch):
    monkeypatch.setattr(library, "_LAUNCHED", set())
    monkeypatch.setattr(library, "COLD_LAUNCHES", [])
    monkeypatch.setattr(library, "LAUNCHES", dict(library.LAUNCHES))
    monkeypatch.setattr(library, "ROUTE_LAUNCHES",
                        {k: {} for k in library.ROUTE_LAUNCHES})
    library.count_launch("chop", "x/block", 0)
    library.count_launch("chop", "x/block", 0)
    library.count_launch("chop", "x/block", 0, True)
    library.count_launch("chop", "x/block", 1)
    library.count_launch("trisolve", "shfl", 0, False, (True, 128))
    library.count_launch("trisolve", "shfl", 0, False, (False, 128))
    assert library.cold_launch_count() == 5
    assert library.LAUNCHES["chop"] == 4
    library.reset_launches()
    assert library.LAUNCHES["chop"] == 0
    library.count_launch("chop", "x/block", 0)
    assert library.cold_launch_count() == 5
    assert library.COLD_LAUNCHES[0] == ("chop", "x/block", None, False, 0)


# ---------------------------------------------------------------------------
# The dispatch layer and the warm batches
# ---------------------------------------------------------------------------

def test_cross_task_precompile_shares_one_dispatcher():
    t1, t2 = _task(3.5e-6, _systems(1, 1)), _task(3.5e-6, _systems(1, 2))
    assert t1.lowerable_for(16) == t2.lowerable_for(16)
    assert EX.computation_key(t1.lowerable_for(16)) == \
        EX.computation_key(t2.lowerable_for(16))
    c0 = EX.executor_compile_count()
    assert t1.precompile_bucket(16, 2)
    log = EX.executor_compile_log()[c0:]
    # One cell of one row, one of several: the two launch layouts.
    assert sorted(r["rows"] > 1 for r in log) == [False, True]
    assert {(r["bucket"], r["carrier"], r["device"], r["backend"])
            for r in log} == {(16, "float64", "cpu", "torch")}
    assert t2.precompile_bucket(16, 2)       # same dispatcher: nothing new
    assert EX.executor_compile_count() == c0 + 2
    wrapped = EX.batch_callable(t1.executor, None, t1.lowerable_for(16))
    assert len(wrapped.cells) == 2
    assert EX.batch_callable(t2.executor, None,
                             t2.lowerable_for(16)) is wrapped


def test_warm_actions_cover_the_routes_and_both_layouts():
    """Every warm batch within the chunk; one-row batches under both
    extremes and, blocked, one factor format of each GEMM route (float32
    carrier); mixed batches with per-row ids in every role."""
    from repro_torch.kernels.qmatmul.ops import ROUTES
    task = _task(1e-6, carrier_dtype="float32")
    acts = SPACE.actions
    for blocked, chunk in ((False, 4), (True, 4), (True, 2), (True, 1)):
        batches = task.warm_actions(512, chunk, blocked)
        assert all(1 <= len(b) <= chunk for b in batches)
        singles = [b[0] for b in batches if len(b) == 1]
        assert {0, len(acts) - 1} <= set(singles)
        routes = {ROUTES[int(acts[a][0])] for a in singles}
        want = {ROUTES[int(a[0])] for a in acts} if blocked else \
            {ROUTES[int(acts[0][0])], ROUTES[int(acts[-1][0])]}
        assert routes == want
        if chunk > 1:
            mixed = [b for b in batches if len(b) > 1
                     and len({tuple(acts[a]) for a in b}) > 1]
            assert any(all(len({acts[a][r] for a in b}) > 1
                           for r in range(4)) for b in mixed)
            assert any(len(b) == 2 for b in mixed)
            assert [b for b in batches if len(b) > 1
                    and len(set(b)) == 1] == [[0] * chunk]


@pytest.mark.parametrize("carrier", [None, "float32"])
def test_warm_rows_take_the_inner_solver_past_its_first_step(carrier):
    """The warm row's right-hand side is held by no low format: across
    the action space some row runs more GMRES steps than refinement
    steps. With b = ones (the JAX package's row) every row runs one
    Arnoldi step an outer iteration, no more."""
    task = _task(1.5e-6, carrier_dtype=carrier)
    low = task.lowerable_for(16)
    A, b, x = task.warm_rows(16)
    assert A.shape == (16, 16) and b.shape == x.shape == (16,)
    np.testing.assert_array_equal(A, np.eye(16))
    np.testing.assert_array_equal(b, x)
    k = SPACE.n_actions
    for rhs, more in ((b, True), (np.ones(16), False)):
        stats = low(np.stack([A] * k), np.stack([rhs] * k),
                    np.stack([rhs] * k), SPACE.actions)
        inner = stats.n_gmres.numpy()
        outer = stats.n_outer.numpy()
        assert bool((inner >= outer).any()) == more, (inner, outer)
        assert bool((inner >= 1).all())


def test_engine_precompile_matches_reference_and_is_noop_when_warm():
    """`precompile` returns (bucket, warmed) pairs as the JAX engine's:
    [] for a task without warm batches, False for a task without an
    action space (both checked against the JAX engine on the same
    stand-in tasks), (16, True) on the GMRES task, as the JAX package's
    own test asserts; on an engine whose chunk and one-row cells have
    both run it runs nothing."""
    class NoForm:
        instances, action_space, name = [], SPACE, "noform"

    def no_space(base):
        class NoSpace:
            """A linear-system task of `base`'s package with a
            dispatchable form but no action space."""
            instances, action_space, name = [], None, "nospace"
            precompile_bucket = base.precompile_bucket

            def lowerable_for(self, n_pad):
                return object()
        return NoSpace()

    assert AutotuneEngine(NoForm(), chunk=2).precompile() == \
        REngine(NoForm(), chunk=2).precompile() == []
    from repro_torch.tasks.base import LinearSystemTask
    assert AutotuneEngine(no_space(LinearSystemTask),
                          chunk=2).precompile([16, 32]) == \
        REngine(no_space(rbase.LinearSystemTask),
                chunk=2).precompile([16, 32]) == [(16, False), (32, False)]
    task = _task(4.5e-6, _systems(2, seed=3))
    eng = AutotuneEngine(task, chunk=2)
    eng.solve_pairs([(0, 0), (1, 0)])        # the chunk's cell
    eng.solve_pairs([(0, 1)])                # the one-row cell
    c0, w0 = EX.executor_compile_count(), len(EX._WRAPPED)
    assert eng.precompile() == [(16, True)]
    assert EX.executor_compile_count() == c0
    assert len(EX._WRAPPED) == w0


def test_precompile_changes_no_task_or_engine_state():
    task = _task(5.0e-6, _systems(2, seed=5))
    eng = AutotuneEngine(task, chunk=2, seed=3, policy=_policy())
    before = (eng._rng.bit_generator.state, eng.n_solves, eng.cache_size,
              eng.qtable.Q.copy(), eng.qtable.N.copy())
    assert eng.precompile() == [(16, True)]
    after = (eng._rng.bit_generator.state, eng.n_solves, eng.cache_size,
             eng.qtable.Q, eng.qtable.N)
    assert before[:3] == after[:3]
    np.testing.assert_array_equal(before[3], after[3])
    np.testing.assert_array_equal(before[4], after[4])


# ---------------------------------------------------------------------------
# Server warmup modes
# ---------------------------------------------------------------------------

def test_sync_warmup_first_request_runs_no_cold_cell():
    """``warmup="sync"``: ready before traffic, and the first two live
    requests run no cold cell and build no dispatcher."""
    task = _task(5.5e-6)
    srv = tsvc.AutotuneServer(_policy(), task, batcher_cfg=BCFG, obs=False,
                              seed=0, warmup="sync",
                              warmup_buckets=[12, 28])
    assert sorted(srv._warmup_expected) == [16, 32]   # sizes -> buckets
    assert srv.ready                                  # before any traffic
    state = srv.warmup_state()
    assert state["mode"] == "sync" and state["done"]
    assert state["warmed_buckets"] == [16, 32] and not state["errors"]
    assert state["compile_cache"] == taot.cache_stats()
    c0, w0 = EX.executor_compile_count(), len(EX._WRAPPED)
    cold0 = library.cold_launch_count()
    for s in _systems(2, seed=4):
        srv.submit(s)
    srv.drain()
    assert EX.executor_compile_count() == c0          # no cold cell
    assert len(EX._WRAPPED) == w0                     # no new dispatcher
    assert library.cold_launch_count() == cold0
    assert srv.telemetry.snapshot()["n_solves"] == 2
    assert srv.degradation_state()["warmup"]["done"]


def test_background_warmup_flips_readyz_per_bucket_in_priority_order(
        tmp_path):
    """``warmup="background"``: /readyz starts 503 with the grid pending,
    flips per bucket in trajectory-traffic order, and answers 200 when
    the expected grid is warm."""
    traj = tmp_path / "traj.jsonl"
    traj.write_text("".join(json.dumps({"bucket": b}) + "\n"
                            for b in (32, 32, 32, 16)))
    gate = threading.Semaphore(0)
    obs = Observability(registry=tmetrics.MetricsRegistry(),
                        trajectory_path=str(traj))
    srv = tsvc.AutotuneServer(_policy(), _task(6.5e-6), batcher_cfg=BCFG,
                              seed=0, obs=obs, warmup="background",
                              warmup_buckets=[16, 32],
                              warmup_pace=lambda e: gate.acquire())
    http = srv.serve_obs()
    try:
        code, body = _readyz(http.url)
        assert code == 503
        assert body["warmup"]["pending_buckets"] == [16, 32]
        assert not srv.ready
        gate.release()                       # let bucket #1 warm
        deadline = time.monotonic() + 120
        while len(srv.warm_order) < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        code, body = _readyz(http.url)
        assert code == 503                   # 32 warm, 16 still pending
        assert body["warmup"]["warmed_buckets"] == [32]
        gate.release()                       # let bucket #2 warm
        assert srv.warmup.wait(120).done
        code, body = _readyz(http.url)
        assert code == 200
        assert body["warmup"]["done"] and not body["warmup"]["errors"]
        assert srv.warm_order == [32, 16]    # trajectory priority held
        assert srv.ready
    finally:
        http.close()
        obs.close()


def test_warm_first_outcome_bit_equal_to_cold(monkeypatch):
    """The first request of a warmed server gives the outcome of the
    same request on a cold server, bit for bit (the cold server's cells
    are run by its request; the warmed one gets dispatchers of its own)."""
    system = _systems(1, seed=7)[0]

    def first(warmup):
        srv = tsvc.AutotuneServer(_policy(), _task(7.5e-6),
                                  batcher_cfg=BCFG, obs=False, seed=0,
                                  warmup=warmup, warmup_buckets=[12])
        c0 = EX.executor_compile_count()
        rid = srv.submit(system)
        srv.drain()
        return srv.poll(rid), EX.executor_compile_count() - c0

    cold, cold_cells = first(None)
    monkeypatch.setattr(EX, "_WRAPPED", {})
    warm, warm_cells = first("sync")
    assert (cold_cells, warm_cells) == (1, 0)
    assert (warm.action, warm.state, warm.bucket) == \
        (cold.action, cold.state, cold.bucket)
    assert int(warm.record.status) == int(cold.record.status)
    assert warm.record.cost == cold.record.cost
    for k, v in cold.record.metrics.items():
        w = warm.record.metrics[k]
        assert np.float64(w).tobytes() == np.float64(v).tobytes(), k
    assert math.isfinite(warm.reward) and warm.reward == cold.reward


# ---------------------------------------------------------------------------
# A task with no dispatchable form, in both packages; ShadowServer
# ---------------------------------------------------------------------------

class _Inst:
    def __init__(self, n):
        self.n, self.features = n, np.zeros(2)


class StubTask:
    """Duck-typed task without `precompile_bucket`: the warmup sweep
    fails open on it (the gate still flips)."""

    name = "stub"
    bucket_step = min_bucket = 16

    def __init__(self, pkg, space):
        self.Outcome = pkg["task"].Outcome
        self.action_space = space
        self.instances = []

    features = np.zeros((0, 2))

    def feature_of(self, inst):
        return inst.features

    def bucket_key(self, inst):
        return 16 * ((inst.n + 15) // 16)

    def prepare(self, inst):
        return inst

    def solve_rows(self, rows, action_rows, chunk):
        return [self.Outcome(status=0, cost=1.0,
                             metrics={"ferr": 1e-8, "nbe": 1e-9,
                                      "n_inner": 1.0}) for _ in rows]

    def reward(self, outcome, action_idx, instance, cfg):
        return 1.0


def _stub_policy(pkg):
    rng = np.random.default_rng(0)
    disc = pkg["disc"].Discretizer.fit(rng.uniform(0.0, 1.0, (64, 2)),
                                       (2, 2))
    space = pkg["space"]()
    return pkg["policy"].PrecisionPolicy(
        space, disc, pkg["bandit"].QTable(disc.n_states, space.n_actions))


@pytest.mark.parametrize("mode", ["sync", "background"])
def test_fail_open_warmup_state_matches_reference(mode):
    states = []
    for pkg in (REF, PORT):
        snap = _stub_policy(pkg)
        srv = pkg["svc"].AutotuneServer(
            snap, StubTask(pkg, snap.action_space),
            batcher_cfg=pkg["svc"].BatcherConfig(max_batch=2,
                                                 bucket_step=16,
                                                 min_bucket=16),
            obs=False, seed=0, warmup=mode, warmup_buckets=[40, 12, 28])
        if mode == "background":
            srv.warmup.wait(60)
        state = dict(srv.warmup_state())
        state.pop("elapsed_s")
        state.pop("compile_cache")
        states.append((state, srv.ready, list(srv.warm_order)))
    assert states[0] == states[1]
    assert states[1][0]["errors"] and states[1][1]


def test_shadow_server_passes_warmup_buckets(tmp_path):
    from repro_torch.service import PolicyRegistry, ShadowServer
    reg = PolicyRegistry(str(tmp_path / "reg"))
    reg.promote(reg.publish(_policy(), note="v1"))
    shadow = ShadowServer(reg, _task(8.5e-6), batcher_cfg=BCFG, obs=False,
                          warmup="sync", warmup_buckets=[12])
    state = shadow.primary.warmup_state()
    assert state["expected_buckets"] == state["warmed_buckets"] == [16]
    assert state["done"] and not state["errors"]
    assert shadow.primary.ready
