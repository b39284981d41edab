"""The torch port's online serving path (`repro_torch.service`) against
the JAX package's (`repro.service`), on the CPU.

Both servers take the same request stream on their own `FakeClock`s,
with the same seed, the same policy snapshot and the same fault plan
(each package's own injector, installed only through `injected`). Every
server gets an `Observability` with a private `MetricsRegistry`, and an
autouse fixture gives each package's process-default registry (which
the engines, registries and injectors count on) a fresh registry for
the test only, so nothing is left behind for a later test file.

  * With a duck-typed stub task whose outcome is a pure function of
    (instance, action), the response streams are equal field for field
    (action, state, eps, reward, drift, quarantined, pinned, probe,
    expired, seq, bucket, latency, record), and so are the Q/N tables
    after the stream, with and without a ``solver.outcome:nan`` plan
    (breaker trips, pins, probes and closes, and the metrics families
    that count them), and with deadline expiry on the clock.
  * With the real `GMRESIRTask` at the JAX service tests' sizes (n 8-14,
    bucket 16, the strict path): statuses, iteration counts, actions and
    states equal; rewards, ferr and nbe within 4 eps of the float64
    carrier, the tolerance of the whole-solve tests (nbe's denominator
    may be an FMA in XLA and is not in the port, ROADMAP.md Queue 3).
  * A registry round trip: the JAX package publishes, the port loads and
    verifies, and the reverse, with equal tables.
  * The JAX package's `eval.replay.replay_records` reads a trajectory
    log the port's server wrote: bit for bit on the stub task; on the
    GMRES task with `check_metrics=False`, where the logged nbe may
    differ in its last bits, and rewards within the same tolerance.
  * The port's server refuses the warmup modes the JAX server refuses
    and takes the rest (AOT warmup itself: tests/test_torch_aot.py); with
    no warmup it reports no warmup state; `/metrics`, `/healthz` and
    `/readyz` answer on 127.0.0.1 (every socket with a timeout, closed
    in `finally`).
"""
import json
import math
import urllib.request

import numpy as np
import pytest

import repro.faults as rfaults
import repro.faults.injector as rinj
import repro.obs as robs
import repro.obs.metrics as rmetrics
import repro.service as rsvc
import repro_torch.faults as tfaults
import repro_torch.obs as tobs
import repro_torch.obs.metrics as tmetrics
import repro_torch.service as tsvc
from repro.core import bandit as rbandit
from repro.core import discretize as rdisc
from repro.core import policy as rpolicy
from repro.core import rewards as rrewards
from repro.core import task as rtask
from repro.core.action_space import reduced_action_space as r_space
from repro.eval.replay import replay_records
from repro_torch.core import bandit as tbandit
from repro_torch.core import discretize as tdisc
from repro_torch.core import policy as tpolicy
from repro_torch.core import rewards as trewards
from repro_torch.core import task as ttask
from repro_torch.core.action_space import reduced_action_space as t_space

REF = dict(svc=rsvc, obs=robs, metrics=rmetrics, faults=rfaults,
           bandit=rbandit, disc=rdisc, policy=rpolicy, rewards=rrewards,
           task=rtask, space=r_space)
PORT = dict(svc=tsvc, obs=tobs, metrics=tmetrics, faults=tfaults,
            bandit=tbandit, disc=tdisc, policy=tpolicy, rewards=trewards,
            task=ttask, space=t_space)
FIELDS = ("request_id", "action", "action_names", "state", "eps",
          "reward", "drift", "quarantined", "pinned", "probe", "expired",
          "seq", "bucket", "latency_s", "policy_version")
N_BINS = (4, 4)
HTTP_TIMEOUT = 10.0


# Observability bundles of the servers a test built (closed on teardown).
_OPEN = []


@pytest.fixture(autouse=True)
def private_default_registries(monkeypatch):
    """Each package's process-default metrics registry is a fresh one
    for this test only, and the JAX injector's environment-plan flag
    (which its clock wrapper sets on every read) is restored on
    teardown; every server's trajectory log and HTTP front door are
    closed after the test."""
    monkeypatch.setattr(rinj, "_ENV_PARSED", rinj._ENV_PARSED)
    monkeypatch.setattr(rmetrics, "_DEFAULT_REGISTRY",
                        rmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "_DEFAULT_REGISTRY",
                        tmetrics.MetricsRegistry())
    yield
    while _OPEN:
        _OPEN.pop().close()
    assert rinj._ACTIVE is None and tfaults.active() is None


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# The stub task: an outcome that is a pure function of (instance, action)
# ---------------------------------------------------------------------------

class Inst:
    def __init__(self, i, n, features):
        self.i, self.n, self.features = i, n, features


def stub_instances(k, seed):
    rng = np.random.default_rng(seed)
    return [Inst(i, int(rng.integers(6, 40)), rng.uniform(0.0, 1.0, 2))
            for i in range(k)]


class StubTask:
    """Duck-typed `TunableTask` over `Inst`s, building the package's own
    `Outcome`s. Buckets 16 / 32 / 48 by n."""

    name = "stub"

    def __init__(self, pkg, space):
        self.Outcome, self.FAILED = pkg["task"].Outcome, pkg["task"].FAILED
        self.action_space = space
        self.instances = []
        self.calls = []

    @property
    def features(self):
        return np.zeros((0, 2))

    def feature_of(self, inst):
        return inst.features

    def bucket_key(self, inst):
        return 16 * ((inst.n + 15) // 16)

    def prepare(self, inst):
        return inst

    def solve_rows(self, rows, action_rows, chunk):
        self.calls.append((len(rows), chunk))
        out = []
        for inst, a in zip(rows, action_rows):
            lvl = int(np.asarray(a).sum())
            h = (7 * inst.i + 3 * lvl) % 11
            ferr = 10.0 ** -(lvl % 9 + inst.i % 3)
            out.append(self.Outcome(
                status=self.FAILED if h == 0 else (1 if h == 5 else 0),
                cost=float(lvl + inst.n % 5),
                metrics={"ferr": ferr, "nbe": ferr / 10.0,
                         "n_inner": float(lvl % 5 + 1)}))
        return out

    def reward(self, outcome, action_idx, instance, cfg):
        if int(outcome.status) == self.FAILED:
            return cfg.fail_reward
        m = outcome.metrics
        return float(-0.5 * math.log10(m["ferr"]) - 0.1 * m["n_inner"]
                     + 0.01 * action_idx)


def stub_policy(pkg, seed=0):
    """The same snapshot built from each package's classes: a 4x4
    discretizer on [0, 1]^2 and a seeded Q-table with a quarter of its
    states never visited (the nearest-visited fallback)."""
    rng = np.random.default_rng(seed)
    disc = pkg["disc"].Discretizer.fit(rng.uniform(0.0, 1.0, (64, 2)),
                                       N_BINS)
    space = pkg["space"]()
    qt = pkg["bandit"].QTable(disc.n_states, space.n_actions, 0.5, seed)
    qt.Q = rng.normal(0.0, 1.0, qt.Q.shape)
    qt.N = rng.integers(0, 3, qt.N.shape).astype(np.int64)
    qt.N[::4] = 0
    qt.Q[::4] = 0.0
    return pkg["policy"].PrecisionPolicy(space, disc, qt)


def make_server(pkg, snapshot, task, clock, tmp_path=None, **kw):
    log = (str(tmp_path / "traj.jsonl") if tmp_path is not None else None)
    obs = pkg["obs"].Observability(registry=pkg["metrics"].MetricsRegistry(),
                                   trajectory_path=log)
    _OPEN.append(obs)
    return pkg["svc"].AutotuneServer(snapshot, task, clock=clock, seed=0,
                                     obs=obs, **kw)


def drive(server, clock, stream, step_every=3):
    """Submit `stream` (pairs of clock advance, instance), stepping the
    server every few requests and draining at the end. Returns the
    responses in completion order, each polled exactly once."""
    done = []
    server.on_response = done.append
    ids = []
    for k, (dt, inst) in enumerate(stream):
        clock.advance(dt)
        ids.append(server.submit(inst))
        if k % step_every == step_every - 1:
            clock.advance(0.01)
            server.step()
    clock.advance(0.01)
    server.drain()
    for resp in done:
        assert server.poll(resp.request_id) is resp
        assert server.poll(resp.request_id) is None
    assert sorted(r.request_id for r in done) == sorted(ids)
    return done


def stream_of(instances, seed):
    rng = np.random.default_rng(seed)
    return [(float(rng.choice([0.0, 0.02, 0.3, 0.7])), inst)
            for inst in instances]


def assert_same_responses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            gv, wv = getattr(g, f), getattr(w, f)
            if isinstance(wv, float) and math.isnan(wv):
                assert math.isnan(gv), (f, g.request_id)
            else:
                assert gv == wv, (f, g.request_id, gv, wv)
        assert int(g.record.status) == int(w.record.status)
        assert g.record.metrics.keys() == w.record.metrics.keys()
        for k, wv in w.record.metrics.items():
            gv = g.record.metrics[k]
            assert gv == wv or (math.isnan(gv) and math.isnan(wv)), k


def assert_same_tables(port_server, ref_server):
    np.testing.assert_array_equal(port_server.live.qtable.Q,
                                  ref_server.live.qtable.Q)
    np.testing.assert_array_equal(port_server.live.qtable.N,
                                  ref_server.live.qtable.N)


def families(server, names):
    """Exposition lines of the named metric families of a server's
    private registry (its package's own renderer)."""
    if isinstance(server.obs.registry, tmetrics.MetricsRegistry):
        from repro_torch.obs.expo import render_prometheus
    else:
        from repro.obs.expo import render_prometheus
    return [ln for ln in render_prometheus(server.obs.registry).splitlines()
            if ln.split("{")[0].split(" ")[0] in names
            or any(ln.startswith(f"# TYPE {n} ") for n in names)]


def serve_both(batcher_kw, stream_seed, n_requests=40, plan=None,
               breaker_kw=None, online_kw=None, tmp_path=None):
    """One stream through the port's and the JAX package's servers,
    under each package's injector for `plan` (a list of FaultSpec
    keyword dicts) when given."""
    insts = stub_instances(n_requests, stream_seed)
    stream = stream_of(insts, stream_seed + 1)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        svc = pkg["svc"]
        kw = dict(batcher_cfg=svc.BatcherConfig(**batcher_kw),
                  reward_cfg=pkg["rewards"].W1)
        if breaker_kw is not None:
            kw["breaker_cfg"] = svc.BreakerConfig(**breaker_kw)
        if online_kw is not None:
            kw["online_cfg"] = svc.OnlineConfig(**online_kw)
        clock = FakeClock()
        snap = stub_policy(pkg)
        task = StubTask(pkg, snap.action_space)
        server = make_server(pkg, snap, task, clock,
                             tmp_path / name if tmp_path else None, **kw)
        if plan is None:
            resp = drive(server, clock, stream)
            counts = None
        else:
            specs = [pkg["faults"].FaultSpec(**s) for s in plan]
            with pkg["faults"].injected(*specs, seed=3) as inj:
                resp = drive(server, clock, stream)
            counts = inj.counts()
        out[name] = (server, resp, counts, task)
    return out, insts


@pytest.fixture
def tmp_dirs(tmp_path):
    for name in ("port", "ref"):
        (tmp_path / name).mkdir()
    return tmp_path


def test_stub_stream_equal_to_reference(tmp_dirs):
    out, _ = serve_both(dict(max_batch=3, max_wait_s=0.5, bucket_step=16,
                             min_bucket=16), stream_seed=11,
                        n_requests=48, tmp_path=tmp_dirs,
                        online_kw=dict(warmup_updates=8,
                                       cooldown_updates=8))
    (ps, presp, _, ptask), (rs, rresp, _, rtask_) = out["port"], out["ref"]
    assert_same_responses(presp, rresp)
    assert_same_tables(ps, rs)
    # The same solve_rows calls; the port runs no padding rows, where the
    # JAX batcher pads each flush to max_batch.
    assert ptask.calls == rtask_.calls
    assert ps.telemetry.snapshot()["padded_rows"] == 0 < \
        rs.telemetry.snapshot()["padded_rows"]
    assert {r.bucket for r in presp} == {16, 32, 48}
    assert any(r.reward != presp[0].reward for r in presp)
    names = ("repro_service_requests_total", "repro_service_responses_total",
             "repro_service_actions_total", "repro_online_updates_total",
             "repro_service_request_latency_seconds")
    assert families(ps, names) == families(rs, names)
    assert ps.telemetry.snapshot()["latency_s"] == \
        rs.telemetry.snapshot()["latency_s"]
    assert ps.degradation_state() == rs.degradation_state()


def test_breaker_under_nan_plan_equal_to_reference():
    plan = [dict(site="solver.outcome", kind="nan", p=0.7, max_fires=14)]
    out, _ = serve_both(dict(max_batch=2, max_wait_s=0.5, bucket_step=16,
                             min_bucket=16), stream_seed=5, n_requests=60,
                        plan=plan,
                        breaker_kw=dict(window=8, min_samples=4,
                                        failure_threshold=0.5,
                                        probe_interval=3,
                                        probe_successes=2))
    (ps, presp, pcounts, _), (rs, rresp, rcounts, _) = out["port"], \
        out["ref"]
    assert pcounts == rcounts
    assert_same_responses(presp, rresp)
    assert_same_tables(ps, rs)
    # The plan tripped, pinned, probed and closed breakers.
    assert any(r.pinned for r in presp) and any(r.probe for r in presp)
    assert any(r.quarantined and not r.pinned for r in presp)
    names = ("repro_breaker_transitions_total", "repro_breaker_state",
             "repro_quarantined_updates_total")
    lines = families(ps, names)
    assert lines == families(rs, names)
    assert any('to="open"' in ln for ln in lines)
    assert any('to="closed"' in ln for ln in lines)
    assert ps.degradation_state() == rs.degradation_state()
    assert ps.quarantined_updates == rs.quarantined_updates > 0


def test_deadline_expiry_equal_to_reference():
    out, _ = serve_both(dict(max_batch=4, max_wait_s=5.0, bucket_step=16,
                             min_bucket=16, request_deadline_s=0.6),
                        stream_seed=21, n_requests=30)
    (ps, presp, _, _), (rs, rresp, _, _) = out["port"], out["ref"]
    assert_same_responses(presp, rresp)
    assert_same_tables(ps, rs)
    expired = [r for r in presp if r.expired]
    assert expired and all(r.quarantined and r.record.status == 3
                           for r in expired)
    assert ps.expired_requests == rs.expired_requests == len(expired)
    names = ("repro_expired_requests_total",)
    assert families(ps, names) == families(rs, names)


def test_trajectory_log_replays_in_reference(tmp_dirs):
    out, insts = serve_both(dict(max_batch=3, max_wait_s=0.5,
                                 bucket_step=16, min_bucket=16),
                            stream_seed=31, n_requests=24,
                            tmp_path=tmp_dirs)
    ps, rs = out["port"][0], out["ref"][0]
    ps.obs.close()
    rs.obs.close()
    from repro.core.engine import AutotuneEngine as RefEngine
    from repro.obs import TrajectoryLog as RefLog
    from repro_torch.obs import TrajectoryLog as PortLog
    port_recs = RefLog.read(str(tmp_dirs / "port" / "traj.jsonl"))
    ref_recs = PortLog.read(str(tmp_dirs / "ref" / "traj.jsonl"))
    assert len(port_recs) == len(ref_recs) == 24
    assert all(set(RefLog.FIELDS) <= set(r) for r in port_recs)
    for p, r in zip(port_recs, ref_recs):
        assert {k: v for k, v in p.items() if k != "ts"} == \
            {k: v for k, v in r.items() if k != "ts"}
    snap = stub_policy(REF)
    engine = RefEngine(StubTask(REF, snap.action_space), rrewards.W1,
                       policy=snap)
    # Request ids count submissions from 0: id k is the k-th instance.
    report = replay_records(engine, port_recs, dict(enumerate(insts)))
    assert report.n_replayed == 24 and report.ok, report.summary()


# ---------------------------------------------------------------------------
# Registry round trip
# ---------------------------------------------------------------------------

def _same_policy(a, b):
    np.testing.assert_array_equal(a.qtable.Q, b.qtable.Q)
    np.testing.assert_array_equal(a.qtable.N, b.qtable.N)
    np.testing.assert_array_equal(a.action_space.actions,
                                  b.action_space.actions)
    assert a.discretizer.to_dict() == b.discretizer.to_dict()


@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_registry_round_trip(tmp_path, writer, reader):
    pol = stub_policy(writer, seed=4)
    wreg = writer["svc"].PolicyRegistry(str(tmp_path))
    v1 = wreg.publish(pol, note="one")
    wreg.promote(v1)
    v2 = wreg.publish(stub_policy(writer, seed=5), note="two")
    wreg.promote(v2)
    rreg = reader["svc"].PolicyRegistry(str(tmp_path))
    assert rreg.versions() == [v1, v2] and rreg.current_version() == v2
    assert rreg.history() == [v1, v2]
    assert rreg.verify(v1)["checksums"] == wreg.verify(v1)["checksums"]
    _same_policy(rreg.load(v1), pol)
    _same_policy(rreg.load(), stub_policy(writer, seed=5))
    assert rreg.rollback() == v1
    assert wreg.current_version() == v1
    # A damaged data file fails the other package's checksum too.
    path = tmp_path / "versions" / v2 / "policy.json"
    path.write_text(path.read_text() + " ")
    with pytest.raises(reader["svc"].SnapshotCorrupted):
        rreg.load(v2)
    got, version, skipped = rreg.load_last_good()
    assert version == v1 and skipped == []


def test_snapshot_from_port_server_loads_in_reference(tmp_path):
    clock = FakeClock()
    reg = tsvc.PolicyRegistry(str(tmp_path))
    reg.promote(reg.publish(stub_policy(PORT), note="start"))
    snap = reg.load()
    server = make_server(PORT, reg, StubTask(PORT, snap.action_space),
                         clock, batcher_cfg=tsvc.BatcherConfig(
                             max_batch=2, bucket_step=16, min_bucket=16))
    drive(server, clock, stream_of(stub_instances(10, 2), 3))
    v = server.snapshot()
    assert v == "v0002" and server.policy_version == v
    meta = rsvc.PolicyRegistry(str(tmp_path)).verify(v)
    assert meta["wal"]["seq"] == server.update_seq == 10
    assert meta["telemetry"]["responses"] == 10
    _same_policy(rsvc.PolicyRegistry(str(tmp_path)).load(), server.live)


# ---------------------------------------------------------------------------
# The real GMRES-IR task at the JAX service tests' sizes
# ---------------------------------------------------------------------------

def _gmres_servers(tmp_path):
    from repro.core.policy import PrecisionPolicy as RefPolicy
    from repro.data.matrices import randsvd_dense
    from repro.solvers import IRConfig as RefIR
    from repro.tasks import GMRESIRTask as RefTask
    from repro_torch.solvers import IRConfig as PortIR
    from repro_torch.tasks import GMRESIRTask as PortTask
    # The JAX service tests' systems (tests/test_service.py `_systems`).
    rng = np.random.default_rng(0)
    systems = [randsvd_dense(int(rng.integers(8, 14)), 100.0, rng)
               for _ in range(16)]
    ref_task = RefTask(systems, r_space(), RefIR(tau=1e-6),
                       bucket_step=16, min_bucket=16)
    disc = rdisc.Discretizer.fit(ref_task.features, N_BINS)
    qt = rbandit.QTable(disc.n_states, 35, 0.5, 0)
    qrng = np.random.default_rng(7)
    qt.Q = qrng.normal(0.0, 1.0, qt.Q.shape)
    qt.N = qrng.integers(0, 2, qt.N.shape).astype(np.int64)
    reg = rsvc.PolicyRegistry(str(tmp_path / "reg"))
    reg.promote(reg.publish(RefPolicy(r_space(), disc, qt)))
    out = {}
    for name, pkg, task in (
            ("ref", REF, RefTask((), r_space(), RefIR(tau=1e-6),
                                 bucket_step=16, min_bucket=16)),
            ("port", PORT, PortTask((), t_space(), PortIR(tau=1e-6),
                                    bucket_step=16, min_bucket=16,
                                    device="cpu"))):
        (tmp_path / name).mkdir()
        clock = FakeClock()
        registry = pkg["svc"].PolicyRegistry(str(tmp_path / "reg"))
        server = make_server(
            pkg, registry, task, clock, tmp_path / name,
            reward_cfg=pkg["rewards"].W1,
            batcher_cfg=pkg["svc"].BatcherConfig(
                max_batch=4, max_wait_s=0.5, bucket_step=16,
                min_bucket=16))
        out[name] = (server, drive(server, clock,
                                   stream_of(systems, 9)))
    return systems, out


def test_gmres_task_stream_matches_reference(tmp_path):
    systems, out = _gmres_servers(tmp_path)
    (ps, presp), (rs, rresp) = out["port"], out["ref"]
    tol = 4 * np.finfo(np.float64).eps
    assert len(presp) == len(rresp) == len(systems)
    for g, w in zip(presp, rresp):
        for f in ("request_id", "action", "state", "eps", "quarantined",
                  "seq", "bucket", "latency_s", "expired"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("status", "n_outer", "n_gmres"):
            assert int(getattr(g.record, f)) == int(getattr(w.record, f)), f
        for f in ("ferr", "nbe"):
            np.testing.assert_allclose(getattr(g.record, f),
                                       getattr(w.record, f), rtol=tol,
                                       atol=0)
        np.testing.assert_allclose(g.reward, w.reward, rtol=tol, atol=tol)
    np.testing.assert_array_equal(ps.live.qtable.N, rs.live.qtable.N)
    np.testing.assert_allclose(ps.live.qtable.Q, rs.live.qtable.Q,
                               rtol=tol, atol=tol)
    # The port's task loops over the live rows: no padding rows run.
    assert ps.telemetry.snapshot()["padded_rows"] == 0
    assert ps.engine.n_pad_solves == 0

    # The JAX package replays the port's log. `check_metrics=False`:
    # the logged nbe may differ from the JAX solve's in its last bits
    # (the FMA above); statuses must be equal and rewards within tol.
    from repro.core.engine import AutotuneEngine as RefEngine
    ps.obs.close()
    recs = tobs.TrajectoryLog.read(str(tmp_path / "port" / "traj.jsonl"))
    engine = RefEngine(rs.task, rrewards.W1, policy=rs.live)
    report = replay_records(engine, recs,
                            {k: s for k, s in enumerate(systems)},
                            check_metrics=False)
    assert report.n_replayed == len(systems)
    for m in report.mismatches:
        assert m.field == "reward", m
        np.testing.assert_allclose(m.replayed, m.logged, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# What the port does not have, and the HTTP surface
# ---------------------------------------------------------------------------

def test_server_refuses_aot_warmup_and_compile_cache(tmp_path,
                                                     monkeypatch):
    """AOT warmup is ported: the server refuses only the warmup modes the
    JAX server refuses, and takes ``warmup``, ``warmup_buckets``,
    ``warmup_pace`` and ``compile_cache_dir`` (over the stub task, which
    has no warm batches, the sweep fails open and the gate flips; the
    full contracts are in tests/test_torch_aot.py)."""
    import repro_torch.core.aot as taot
    from repro_torch.kernels import library
    monkeypatch.setattr(taot, "_cache_dir", None)
    monkeypatch.setattr(library, "BUILD_DIR", library.BUILD_DIR)
    for pkg in (REF, PORT):
        snap = stub_policy(pkg)
        with pytest.raises(ValueError, match="warmup must be None"):
            pkg["svc"].AutotuneServer(snap,
                                      StubTask(pkg, snap.action_space),
                                      obs=False, warmup="eager")
    snap = stub_policy(PORT)
    paced = []
    for kw in (dict(warmup="sync", warmup_buckets=[20]),
               dict(warmup="background", warmup_pace=paced.append),
               dict(compile_cache_dir=str(tmp_path / "cache"))):
        server = tsvc.AutotuneServer(snap,
                                     StubTask(PORT, snap.action_space),
                                     obs=False, **kw)
        if "warmup" not in kw:
            assert server.warmup_state() is None
            continue
        if server.warmup_state()["mode"] == "background":
            server.warmup.wait(60)
        state = server.warmup_state()
        assert state["done"] and server.ready
        assert state["warmed_buckets"] == [128]     # the batcher's bucket
    assert [e.bucket for e in paced] == [128]
    assert taot.cache_stats()["dir"] == str(tmp_path / "cache")
    assert library.BUILD_DIR == tmp_path / "cache"


def test_executor_spec():
    from repro_torch.core.executor import LocalExecutor, resolve_executor
    ex = resolve_executor(None)
    assert ex == resolve_executor("local") == LocalExecutor()
    assert (ex.name, ex.preferred_chunk(5, 128), ex.device_count(),
            ex.mesh_shape()) == ("local", 5, 1, None)
    assert resolve_executor(ex) is ex
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        resolve_executor("sharded")
    with pytest.raises(ValueError):
        resolve_executor("mesh")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.read().decode()
        finally:
            e.close()


def test_serve_obs_on_loopback_matches_reference_surface():
    clock = FakeClock()
    snap = stub_policy(PORT)
    server = make_server(PORT, snap, StubTask(PORT, snap.action_space),
                         clock, batcher_cfg=tsvc.BatcherConfig(
                             max_batch=2, bucket_step=16, min_bucket=16))
    assert server.warmup_state() is None and not server.ready
    with pytest.raises(ValueError, match="127.0.0.1"):
        server.serve_obs(host="0.0.0.0")
    http = server.serve_obs()
    try:
        assert http.host == "127.0.0.1"
        code, body = _get(http.url + "/readyz")
        assert code == 503 and json.loads(body)["status"] == "unready"
        drive(server, clock, stream_of(stub_instances(6, 8), 1))
        code, body = _get(http.url + "/metrics")
        assert code == 200
        assert tobs.lint_exposition(body) == []
        served = sum(float(ln.rsplit(" ", 1)[1]) for ln in body.splitlines()
                     if ln.startswith("repro_service_requests_total{"))
        assert served == 6
        code, body = _get(http.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body = _get(http.url + "/readyz")
        assert code == 200 and json.loads(body)["status"] == "ready"
        assert _get(http.url + "/nope")[0] == 404
    finally:
        server.obs.close()
    assert server.obs.http is None
