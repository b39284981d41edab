"""The sharded solve executor (`repro_torch.core.executor.ShardedExecutor`)
on the CPU: the port's counterpart of `tests/test_executor.py`'s
in-process tests and of its 8-device parity blocks.

PyTorch has one CPU device. The executor asks the host for devices in
one function, `core.executor.mesh_devices`; the `eight_devices` fixture
replaces it to expose the CPU eight times, the counterpart of the JAX
package's `--xla_force_host_platform_device_count=8`, so a batch's rows
split over up to eight shards and are gathered back. Shards on one
device run in turn on the caller's thread. `distinct_devices` exposes
`cpu:0`, `cpu:1`, ..., which the executor tells apart, so their shards
run on threads of their own (tensors put on `cpu:i` land on the CPU).

  * The contract: `preferred_chunk` rounding, the registry and
    `resolve_executor("sharded")`, value hashing, a mesh larger than
    the host raises ValueError, the "model" path raises
    NotImplementedError when it would engage, the contiguous split with
    no padding rows.
  * `ShardedExecutor(data=1)` against the JAX package's
    `ShardedExecutor(data=1)` on the host's one device, on the reference
    test's systems and actions: status and counts equal; ferr, nbe and
    res_norm within 4 eps of the float64 carrier, the whole-solve tests'
    tolerance (nbe's denominator may be an FMA in XLA, ROADMAP Queue 3);
    and the port's sharded records bit-equal to its local ones.
  * Through the 8-device seam, every record bit-equal to
    `LocalExecutor`'s: all 7 format ids as the rows of one batch,
    strict and blocked (`BlockingPolicy(min_n=16, ...)`), at data 1, 2,
    4 and 8 (at 8 each row is a shard of one, the one-format path); the
    engine with both tasks over the whole action space (`n_devices ==
    8`, no padding rows); one dispatcher per bucket for equal executors
    and entry points; the server (`flush_target(16) == 8`) with
    responses equal to a local server's.
  * Shards on distinct devices run on threads and gather in row order;
    a shard's failure is raised after every thread has ended; the
    launch counters stay exact when several threads count.
  * No thread is left running after the file (the last test).
"""
import threading

import numpy as np
import pytest
import torch

import repro.obs.metrics as rmetrics
import repro_torch.obs.metrics as tmetrics
from repro.core import ShardedExecutor as RefShardedExecutor
from repro.core import pad_to_bucket as ref_pad_to_bucket
from repro.core import reduced_action_space as ref_space
from repro.core import solve_fixed_batch as ref_solve_fixed_batch
from repro.data.matrices import randsvd_dense as ref_randsvd_dense
from repro.solvers import IRConfig as RefIRConfig
from repro_torch.core import (LocalExecutor, ShardedExecutor, W1,
                              available_executors, pad_to_bucket,
                              reduced_action_space, resolve_executor,
                              set_default_executor, solve_fixed_batch)
from repro_torch.core import executor as EX
from repro_torch.core.bandit import QTable
from repro_torch.core.discretize import Discretizer
from repro_torch.core.engine import AutotuneEngine
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.data.matrices import randsvd_dense, sparse_spd
from repro_torch.kernels import library
from repro_torch.service import AutotuneServer, BatcherConfig, OnlineConfig
from repro_torch.solvers import (BlockingPolicy, CGConfig, IRConfig,
                                 gmres_ir_batch_lowerable)
from repro_torch.tasks import CGIRTask, GMRESIRTask

CPU = "cpu"
EPS64 = float(np.finfo(np.float64).eps)
SPACE = reduced_action_space()
IR = IRConfig(tau=1e-5, i_max=4, m_max=12)
CG = CGConfig(tau=1e-5, i_max=4, m_max=12)
# Threshold-lowered blocking so the small systems run the blocked LU and
# trisolve end to end (DESIGN.md §6.4), as the reference's parity suite.
IRB = IRConfig(tau=1e-5, i_max=4, m_max=12,
               blocking=BlockingPolicy(min_n=16, lu_block=16,
                                       trisolve_block=16))
CFGS = {"strict": IR, "blocked": IRB}


@pytest.fixture(scope="module", autouse=True)
def threads_at_start():
    """The threads alive when the file's first test starts (threads that
    earlier files of the same worker left are not this file's)."""
    return set(threading.enumerate())


@pytest.fixture(autouse=True)
def private_default_registries(monkeypatch):
    """Each package's process-default metrics registry (the dispatchers
    and engines count there) is a fresh one for this test only."""
    monkeypatch.setattr(rmetrics, "_DEFAULT_REGISTRY",
                        rmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "_DEFAULT_REGISTRY",
                        tmetrics.MetricsRegistry())


@pytest.fixture
def eight_devices(monkeypatch):
    monkeypatch.setattr(EX, "mesh_devices",
                        lambda device_type: [torch.device(device_type)] * 8)


@pytest.fixture
def distinct_devices(monkeypatch):
    monkeypatch.setattr(EX, "mesh_devices", lambda device_type: [
        torch.device(device_type, i) for i in range(4)])


def _fields(records):
    return [r.__dict__ for r in records]


def _solve(rows, acts, cfg, executor=None):
    return solve_fixed_batch([r[0] for r in rows], [r[1] for r in rows],
                             [r[2] for r in rows], acts, cfg, device=CPU,
                             executor=executor)


# ---------------------------------------------------------------------------
# Contract: chunk rounding, registry, hashing, mesh, split
# ---------------------------------------------------------------------------

def test_preferred_chunk_rounding():
    assert LocalExecutor().preferred_chunk(9) == 9
    ex = ShardedExecutor(data=4)
    assert ex.preferred_chunk(1) == 4    # at least one row per device
    assert ex.preferred_chunk(3) == 4
    assert ex.preferred_chunk(4) == 4
    assert ex.preferred_chunk(8) == 8
    assert ex.preferred_chunk(9) == 12   # round UP, never down
    assert ex.preferred_chunk(8, bucket=128) == 8
    assert (ex.device_count(), ex.mesh_shape()) == (4, {"data": 4,
                                                        "model": 1})
    assert ShardedExecutor(data=2, model=3).device_count() == 6


def test_registry_and_selection():
    assert {"local", "sharded"} <= set(available_executors())
    assert resolve_executor(None).name == "local"
    assert resolve_executor("local") == LocalExecutor()
    sh = resolve_executor("sharded")
    assert isinstance(sh, ShardedExecutor) and sh == ShardedExecutor()
    inst = ShardedExecutor(data=1)
    assert resolve_executor(inst) is inst
    with pytest.raises(ValueError):
        resolve_executor("nope")
    prev = set_default_executor("sharded")
    try:
        assert resolve_executor(None) == ShardedExecutor()
    finally:
        set_default_executor(prev)
    assert resolve_executor(None).name == "local"


def test_executors_hash_by_value():
    assert hash(ShardedExecutor(data=2)) == hash(ShardedExecutor(data=2))
    assert ShardedExecutor(data=2) == ShardedExecutor(data=2)
    assert ShardedExecutor(data=2) != ShardedExecutor(data=4)
    assert ShardedExecutor(data=2) != LocalExecutor()


def test_mesh_larger_than_host_raises(eight_devices):
    mesh = ShardedExecutor(data=4, model=2).mesh(CPU)
    assert mesh.shape == (4, 2)
    assert mesh.mesh_dim_names == ("data", "model")
    assert ShardedExecutor().data_size() == 8      # every device exposed
    with pytest.raises(ValueError, match="devices"):
        ShardedExecutor(data=8 * 64).mesh(CPU)
    with pytest.raises(ValueError, match="devices"):
        ShardedExecutor(data=8, model=2).mesh(CPU)


def test_mesh_on_the_real_host():
    """Without the seam the CPU is one device: a mesh of two raises."""
    assert ShardedExecutor(data=1).mesh(CPU).devices == (
        (torch.device(CPU),),)
    with pytest.raises(ValueError, match="devices"):
        ShardedExecutor(data=2).mesh(CPU)


def test_shards_are_contiguous_with_no_padding_rows(eight_devices):
    ex = ShardedExecutor(data=4)
    assert ex.shard_rows(10) == [3, 3, 2, 2]
    assert ex.shard_rows(3) == [1, 1, 1, 0]
    rows = np.arange(10 * 2).reshape(10, 2)
    shards = ex.shard((rows, rows[:, 0]), 16, CPU)
    assert [len(r[0]) for _, r in shards] == [3, 3, 2, 2]
    assert np.array_equal(np.concatenate([r[0] for _, r in shards]), rows)
    # A data position with no rows runs nothing.
    assert len(ex.shard((rows[:3], rows[:3, 0]), 16, CPU)) == 3


def test_model_path_raises_when_engaged(eight_devices):
    rows = [pad_to_bucket(randsvd_dense(12, 10.0, np.random.default_rng(0)),
                          16, 16)]
    acts = [SPACE.actions[-1]]
    # Below model_min_n the replicas along "model" run each shard once.
    got = _solve(rows, acts, IR, ShardedExecutor(data=2, model=2))
    assert _fields(got) == _fields(_solve(rows, acts, IR))
    with pytest.raises(NotImplementedError, match="model"):
        _solve(rows, acts, IR, ShardedExecutor(data=2, model=2,
                                               model_min_n=16))


# ---------------------------------------------------------------------------
# One data position against the reference's, on the host's one device
# ---------------------------------------------------------------------------

def test_one_device_mesh_matches_the_reference():
    """The reference's `test_one_device_mesh_bitmatches_local` systems and
    actions through both packages' `ShardedExecutor(data=1)`."""
    space = ref_space()
    rng = np.random.default_rng(2)
    ref_rows = [ref_pad_to_bucket(ref_randsvd_dense(int(n), 1e3, rng),
                                  16, 16) for n in (13, 10, 12)]
    rng = np.random.default_rng(2)
    rows = [pad_to_bucket(randsvd_dense(int(n), 1e3, rng), 16, 16)
            for n in (13, 10, 12)]
    for r, t in zip(ref_rows, rows):
        assert all(np.array_equal(a, b) for a, b in zip(r, t))
    acts = [space.actions[i] for i in (0, 20, space.n_actions - 1)]
    want = ref_solve_fixed_batch(
        [r[0] for r in ref_rows], [r[1] for r in ref_rows],
        [r[2] for r in ref_rows], acts,
        RefIRConfig(tau=1e-5, i_max=4, m_max=12), chunk=4,
        executor=RefShardedExecutor(data=1))
    got = _solve(rows, acts, IR, ShardedExecutor(data=1))
    assert _fields(got) == _fields(_solve(rows, acts, IR))
    for g, w in zip(got, want):
        assert (g.status, g.n_outer, g.n_gmres) == (w.status, w.n_outer,
                                                    w.n_gmres)
        for f in ("ferr", "nbe", "res_norm"):
            a, b = getattr(g, f), getattr(w, f)
            assert abs(a - b) <= 4 * EPS64 * abs(b), (f, a, b)


# ---------------------------------------------------------------------------
# Through the 8-device seam: records bit-equal to the local executor's
# ---------------------------------------------------------------------------

_LOCAL = {}


def _format_rows():
    """Row k: a system of kappa 10^(k % 5) under the all-`k` action, for
    the 7 format ids."""
    rows = [pad_to_bucket(randsvd_dense(13, 10.0 ** (fid % 5),
                                        np.random.default_rng(fid)), 16, 16)
            for fid in range(7)]
    return rows, [np.asarray([fid] * 4, np.int32) for fid in range(7)]


@pytest.mark.parametrize("data", [1, 2, 4, 8])
@pytest.mark.parametrize("path", ["strict", "blocked"])
def test_all_formats_sharded_equal_local(eight_devices, path, data):
    rows, acts = _format_rows()
    cfg = CFGS[path]
    if path not in _LOCAL:
        _LOCAL[path] = _fields(_solve(rows, acts, cfg))
    got = _solve(rows, acts, cfg, ShardedExecutor(data=data))
    assert _fields(got) == _LOCAL[path]
    # A single row lands on the first shard: the one-format path.
    one = _solve(rows[6:], acts[6:], cfg, ShardedExecutor(data=data))
    assert _fields(one) == _LOCAL[path][6:]


def _engine(cls, systems, cfg, kw, ex):
    task = cls(systems, SPACE, bucket_step=16, min_bucket=16, executor=ex,
               device=CPU, **{kw: cfg})
    eng = AutotuneEngine(task, chunk=64)
    eng.prefill_all()
    return eng


@pytest.mark.parametrize("name", ["gmres_ir", "cg_ir"])
def test_engine_both_tasks_sharded_equal_local(eight_devices, name):
    if name == "gmres_ir":
        cls, cfg, kw = GMRESIRTask, IR, "ir_cfg"
        systems = [randsvd_dense(int(n), 10.0 ** (i + 1),
                                 np.random.default_rng(i))
                   for i, n in enumerate((9, 13))]
    else:
        cls, cfg, kw = CGIRTask, CG, "cg_cfg"
        systems = [sparse_spd(int(n), 0.2, np.random.default_rng(i), 1e4)
                   for i, n in enumerate((9, 13))]
    loc = _engine(cls, systems, cfg, kw, None)
    sh = _engine(cls, systems, cfg, kw, ShardedExecutor(data=8))
    for i in range(len(systems)):
        for a in range(SPACE.n_actions):
            got, want = sh.outcome(i, a), loc.outcome(i, a)
            assert got.status == want.status, (name, i, a)
            assert got.metrics == want.metrics, (name, i, a)
    total = len(systems) * SPACE.n_actions
    s = sh.summarize()
    assert s["n_devices"] == 8
    assert (sh.n_solves, sh.n_pad_solves) == (total, 0)
    assert s["rows_per_device"] == -(-total // 8)


def test_one_dispatcher_per_bucket(eight_devices):
    rows, acts = _format_rows()
    before = EX.executor_compile_count()
    for k in range(3):
        _solve(rows[k:k + 4], acts[k:k + 4], IR, ShardedExecutor(data=8))
    wrapped = EX.batch_callable(ShardedExecutor(data=8), None,
                                gmres_ir_batch_lowerable(IR, CPU))
    # An equal executor and an equal entry point give the same
    # dispatcher; its cells are one bucket's, on the one CPU device.
    assert EX.batch_callable(ShardedExecutor(data=8), None,
                             gmres_ir_batch_lowerable(IR, CPU)) is wrapped
    assert {(c[0], c[2]) for c in wrapped.cells} == {(16, torch.device(CPU))}
    assert EX.executor_compile_count() - before <= 2   # one row / several


def _serve(ex, max_batch):
    task = GMRESIRTask((), SPACE, IR, bucket_step=16, min_bucket=16,
                       executor=ex, device=CPU)
    reqs = [randsvd_dense(int(n), 10.0 ** (1 + i % 3),
                          np.random.default_rng(100 + i))
            for i, n in enumerate((10, 13, 12, 14, 11, 9, 15, 10, 12, 13))]
    # A greedy policy whose states and actions vary over the requests.
    disc = Discretizer.fit(np.array([task.feature_of(s) for s in reqs]),
                           (3, 3))
    q = QTable(disc.n_states, SPACE.n_actions)
    q.Q[:] = np.random.default_rng(7).uniform(size=q.Q.shape)
    srv = AutotuneServer(PrecisionPolicy(SPACE, disc, q), task, W1,
                         BatcherConfig(max_batch=max_batch, max_wait_s=1e9,
                                       bucket_step=16, min_bucket=16),
                         OnlineConfig(eps0=0.0, eps_min=0.0), seed=0)
    ids = [srv.submit(s) for s in reqs]
    srv.drain()
    return srv, [srv.poll(i) for i in ids]


def test_server_through_the_sharded_executor(eight_devices):
    """The sharded server's max_batch 4 flushes 8 rows (the mesh width),
    so the local server it is held against flushes 8 too: the same
    flushes, so the same Q-updates before each later selection (the
    first flush comes at the 8th request, the rest at the drain)."""
    srv_s, resp_s = _serve(ShardedExecutor(data=8), 4)
    srv_l, resp_l = _serve(None, 8)
    assert srv_s.batcher.flush_target(16) == 8
    assert srv_l.batcher.flush_target(16) == 8
    assert len({r.action for r in resp_l}) > 1
    for rs, rl in zip(resp_s, resp_l):
        assert rs.action == rl.action
        assert rs.record.status == rl.record.status
        assert rs.record.metrics == rl.record.metrics
        assert rs.reward == rl.reward
    tel = srv_s.telemetry.snapshot()
    assert (tel["n_solves"], tel["n_pad_solves"]) == (10, 0)


# ---------------------------------------------------------------------------
# Threads: distinct devices, failures, the launch counters
# ---------------------------------------------------------------------------

def _probe_call(fn):
    """`fn(A, *, device)` as a dispatchable call on the CPU."""
    return EX.LowerableCall(fn, (("device", torch.device(CPU)),))


def _column(rows):
    """`rows` rows of one bucket's shape: A (rows, 1, 1), row i = i."""
    return (torch.arange(rows, dtype=torch.float64).view(rows, 1, 1),)


def test_distinct_devices_run_on_threads_and_gather_in_order(
        distinct_devices):
    seen = []

    def probe(A, *, device):
        seen.append((threading.current_thread().name, device,
                     A.flatten().tolist()))
        return A.flatten() * 10, torch.full((len(A),), device.index)

    out = ShardedExecutor(data=3).dispatch(_probe_call(probe), _column(7),
                                           1)
    assert out[0].tolist() == [0, 10, 20, 30, 40, 50, 60]
    assert out[1].tolist() == [0, 0, 0, 1, 1, 2, 2]    # rows 3, 2, 2
    names = {name for name, _, _ in seen}
    assert len(names) == 3 and threading.current_thread().name in names
    # The solver's records on threads: bit-equal to the local executor's.
    rows, acts = _format_rows()
    got = _solve(rows[:6], acts[:6], IR, ShardedExecutor(data=3))
    assert _fields(got) == _fields(_solve(rows[:6], acts[:6], IR))


def test_a_shard_failure_is_raised_after_every_thread_ends(
        distinct_devices, threads_at_start):
    ended = []

    def fn(A, *, device):
        if device.index == 1:
            raise RuntimeError("shard 1 failed")
        ended.append(device.index)
        return A

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        ShardedExecutor(data=3).dispatch(_probe_call(fn), _column(6), 1)
    assert sorted(ended) == [0, 2]
    assert set(threading.enumerate()) <= threads_at_start


def test_launch_counts_exact_from_several_threads(monkeypatch):
    monkeypatch.setattr(library, "LAUNCHES", dict(library.LAUNCHES))
    monkeypatch.setattr(library, "ROUTE_LAUNCHES",
                        {k: {} for k in library.KERNELS})
    monkeypatch.setattr(library, "FLASH_KIND_LAUNCHES",
                        dict.fromkeys(library.FLASH_KIND_LAUNCHES, 0))
    library.reset_launches()
    n_threads, n = 8, 4000
    start = threading.Barrier(n_threads)

    def count():
        start.wait()
        for _ in range(n):
            library.count_launch("chop", "block/vector")
            library.count_launch("flash_attention", "simt", kind="local")

    threads = [threading.Thread(target=count) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert library.LAUNCHES["chop"] == n_threads * n
    assert library.ROUTE_LAUNCHES["chop"] == {"block/vector": n_threads * n}
    assert library.FLASH_KIND_LAUNCHES["local"] == n_threads * n


def test_no_thread_left_running(threads_at_start):
    """Runs last in the file: every thread its tests started has ended."""
    assert set(threading.enumerate()) <= threads_at_start
