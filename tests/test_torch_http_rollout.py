"""The torch port's HTTP front door and canary rollout controller
(`repro_torch.service.http`, `repro_torch.service.ShadowServer`) against
the JAX package's, on the CPU.

Both packages serve the same stream of small dense systems through a
duck-typed stub task whose outcome is a pure function of (system,
action), each server on a frozen clock with the same seed and policy
snapshot, every metrics registry private to the test:

  * over HTTP on 127.0.0.1 (port 0, every request with a timeout, every
    front door closed in `finally`): the status codes and bodies of
    validation errors, unknown routes and methods; sync solves; async
    fire-and-poll, exactly once; 429 with ``Retry-After`` when a bucket
    is full; ``/v1/policy``. Equal between the packages, body for body.
  * the port's drain deadline: a drain wedged by a flush that raises or
    by a drain call that blocks fails what is pending at
    ``drain_timeout_s``; the waiting sync caller gets 503 within
    ``drain_timeout_s`` + 5 s and the fire-and-poll ids hold ``failed``
    (the JAX package's front door answers that caller 504 after its own
    30 s timeout on CPython >= 3.12.1, ROADMAP.md Queue 3).
  * `ShadowServer`: routing per seed, the gate's decisions, the rollback
    of a degraded candidate and the promotion of a healthy one, the
    decision-trail JSONL modulo its time field, the rollout metrics, and
    the OPE gate's verdict and registry annotation, equal between the
    packages; the primary slice served over HTTP equal to an in-process
    `AutotuneServer` fed that slice.
"""
import json
import math
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.faults as rfaults
import repro.faults.injector as rinj
import repro.obs as robs
import repro.obs.metrics as rmetrics
import repro.service as rsvc
import repro.service.http as rhttp
import repro_torch.faults as tfaults
import repro_torch.obs as tobs
import repro_torch.obs.metrics as tmetrics
import repro_torch.service as tsvc
import repro_torch.service.http as thttp
from repro.core import bandit as rbandit
from repro.core import discretize as rdisc
from repro.core import policy as rpolicy
from repro.core import rewards as rrewards
from repro.core import task as rtask
from repro.core.action_space import reduced_action_space as r_space
from repro_torch.core import bandit as tbandit
from repro_torch.core import discretize as tdisc
from repro_torch.core import policy as tpolicy
from repro_torch.core import rewards as trewards
from repro_torch.core import task as ttask
from repro_torch.core.action_space import reduced_action_space as t_space
from repro_torch.data.matrices import generate_dense_set

REF = dict(svc=rsvc, http=rhttp, obs=robs, metrics=rmetrics,
           faults=rfaults, bandit=rbandit, disc=rdisc, policy=rpolicy,
           rewards=rrewards, task=rtask, space=r_space)
PORT = dict(svc=tsvc, http=thttp, obs=tobs, metrics=tmetrics,
            faults=tfaults, bandit=tbandit, disc=tdisc, policy=tpolicy,
            rewards=trewards, task=ttask, space=t_space)
TIMEOUT = 10.0
BCFG = dict(max_batch=1, max_wait_s=0.5, bucket_step=16, min_bucket=16)
RCFG = dict(canary_frac=0.3, shadow=True, decision_window=12,
            min_samples=10, promote_windows=2, reward_margin=3.0,
            pass_rate_floor=0.3, pass_rate_margin=0.9, p99_bound=50.0,
            min_bucket_samples=4, seed=0)
_OPEN = []


@pytest.fixture(autouse=True)
def private_default_registries(monkeypatch):
    """Fresh process-default metrics registries for this test only (the
    JAX engine and registry count there), the JAX injector's
    environment-plan flag restored, and every observability bundle and
    front door closed on teardown."""
    monkeypatch.setattr(rinj, "_ENV_PARSED", rinj._ENV_PARSED)
    monkeypatch.setattr(rmetrics, "_DEFAULT_REGISTRY",
                        rmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "_DEFAULT_REGISTRY",
                        tmetrics.MetricsRegistry())
    yield
    while _OPEN:
        _OPEN.pop().close()
    assert rinj._ACTIVE is None and tfaults.active() is None


class FrozenClock:
    """A clock that never moves: latencies read 0 and no batcher deadline
    passes, so only full buckets, a drain or a forced step flush."""

    def __call__(self):
        return 0.0


# ---------------------------------------------------------------------------
# The stub task over dense systems
# ---------------------------------------------------------------------------

class SystemStubTask:
    """Duck-typed `TunableTask` over `LinearSystem`s (any package's), with
    the package's own `Outcome`s. The lowest format of the action decides
    the error: all-bf16 steps never reach 1e-6 (status 1), tf32 and above
    do; buckets 16 / 32 / 48 by n."""

    name = "stub"
    bucket_step = min_bucket = 16      # the front door's admission buckets

    def __init__(self, pkg, space):
        self.Outcome, self.FAILED = pkg["task"].Outcome, pkg["task"].FAILED
        self.action_space = space
        self.instances = []

    @property
    def features(self):
        return np.zeros((0, 2))

    def feature_of(self, system):
        f = system.features
        return np.array([f["log_kappa"] / 6.0, f["log_norm"] / 3.0])

    def bucket_key(self, system):
        return 16 * ((system.n + 15) // 16)

    def prepare(self, system):
        return system

    def solve_rows(self, rows, action_rows, chunk):
        out = []
        for system, a in zip(rows, action_rows):
            a = np.asarray(a)
            lo, lvl = int(a.min()), int(a.sum())
            ferr = 10.0 ** (system.features["log_kappa"] / 3.0 - 2.0 * lo)
            out.append(self.Outcome(
                status=0 if ferr < 1e-6 else 1,
                cost=float(lvl + system.n % 5),
                metrics={"ferr": ferr, "nbe": ferr / 10.0,
                         "n_inner": float(lvl % 5 + 1)}))
        return out

    def reward(self, outcome, action_idx, instance, cfg):
        if int(outcome.status) == self.FAILED:
            return cfg.fail_reward
        m = outcome.metrics
        return float(-0.5 * math.log10(m["ferr"]) - 0.1 * m["n_inner"]
                     + 0.01 * action_idx - 2.0 * int(outcome.status))


def systems(k, seed, n_range=(6, 40)):
    return generate_dense_set(k, np.random.default_rng(seed), n_range,
                              log10_kappa_range=(1, 5))


def stub_policy(pkg, seed=0):
    """The same snapshot from each package's classes: a 4x4 discretizer on
    [0, 1]^2 and a seeded Q-table, a quarter of its states unvisited."""
    rng = np.random.default_rng(seed)
    disc = pkg["disc"].Discretizer.fit(rng.uniform(0.0, 1.0, (64, 2)),
                                       (4, 4))
    space = pkg["space"]()
    qt = pkg["bandit"].QTable(disc.n_states, space.n_actions, 0.5, seed)
    qt.Q = rng.normal(0.0, 1.0, qt.Q.shape)
    qt.N = rng.integers(0, 3, qt.N.shape).astype(np.int64)
    qt.N[::4] = 0
    qt.Q[::4] = 0.0
    return pkg["policy"].PrecisionPolicy(space, disc, qt)


def obs_for(pkg, log=None):
    obs = pkg["obs"].Observability(registry=pkg["metrics"].MetricsRegistry(),
                                   trajectory_path=log)
    _OPEN.append(obs)
    return obs


def server_for(pkg, root, **kw):
    reg = pkg["svc"].PolicyRegistry(str(root))
    kw.setdefault("batcher_cfg", pkg["svc"].BatcherConfig(**BCFG))
    kw.setdefault("obs", obs_for(pkg))
    return pkg["svc"].AutotuneServer(
        reg, SystemStubTask(pkg, reg.load().action_space),
        reward_cfg=pkg["rewards"].W1, clock=FrozenClock(), seed=0, **kw)


@pytest.fixture
def roots(tmp_path):
    """One registry per package: the same v0001 (a stub snapshot) written
    by the port and copied."""
    reg = tsvc.PolicyRegistry(str(tmp_path / "port"))
    reg.promote(reg.publish(stub_policy(PORT), note="start"))
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    return {"port": tmp_path / "port", "ref": tmp_path / "ref"}


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def http(method, url, payload=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = e.read().decode()
            return e.code, (json.loads(body) if body else {}), dict(e.headers)
        finally:
            e.close()


def payload(system, request_id=None, x_true=True):
    out = {"A": system.A.tolist(), "b": system.b.tolist()}
    if x_true:
        out["x_true"] = system.x_true.tolist()
    if request_id is not None:
        out["request_id"] = request_id
    return out


def await_result(url, rid):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        code, body, _ = http("GET", f"{url}/v1/result/{rid}")
        if code == 200:
            return body
        assert code == 202, body
        time.sleep(0.005)
    raise AssertionError(f"request {rid} never completed")


def exchange(pkg, root, script, **cfg):
    """Run `script(url)` against a front door over a stub server of
    `pkg`; returns what it returns and the front door (closed)."""
    fd = pkg["http"].serve_http(
        server_for(pkg, root),
        cfg=pkg["http"].HttpConfig(max_n=48, flush_interval_s=0.002, **cfg))
    try:
        out = script(fd.url)
    finally:
        fd.close()
    return out, fd


def _headers(h):
    keep = ("Content-Type", "Retry-After", "X-Request-Id", "Connection")
    return {k: v for k, v in h.items() if k in keep}


def test_validation_routes_and_methods_equal_to_reference(roots):
    sys0 = systems(1, 11)[0]
    bad = [
        {"A": sys0.A[:, :-1].tolist(), "b": sys0.b.tolist()},
        {"A": sys0.A.tolist(), "b": sys0.b[:-1].tolist()},
        {"A": (sys0.A * np.nan).tolist(), "b": sys0.b.tolist()},
        {"A": sys0.A.tolist(), "b": sys0.b.tolist(), "oops": 1},
        {"A": sys0.A.tolist(), "b": sys0.b.tolist(),
         "x_true": sys0.x_true[:-1].tolist()},
        {"A": sys0.A.tolist(), "b": sys0.b.tolist(), "request_id": 17},
        {"A": sys0.A.tolist(), "b": sys0.b.tolist(), "request_id": "x" * 300},
        {"A": [["a"]], "b": [1.0]},
        {"A": [], "b": []},
        {"b": sys0.b.tolist()},
        [1, 2, 3],
        {"A": np.eye(64).tolist(), "b": [1.0] * 64},
    ]

    def script(url):
        out = [http("POST", url + "/v1/solve", raw=b"not json")]
        out += [http("POST", url + "/v1/solve", p) for p in bad]
        out += [http("POST", url + "/v1/solve:sync", bad[0])]
        out += [http(m, url + p) for m, p in (
            ("GET", "/nope"), ("GET", "/v1/solve"), ("GET", "/v1/solve:sync"),
            ("POST", "/v1/policy"), ("POST", "/v1/result/3"),
            ("GET", "/v1/result/abc"), ("GET", "/v1/result/12345"))]
        return [(c, b, _headers(h)) for c, b, h in out]

    got, _ = exchange(PORT, roots["port"], script)
    want, _ = exchange(REF, roots["ref"], script)
    assert got == want
    codes = [c for c, _, _ in got]
    assert codes == [400] * 14 + [404, 405, 405, 405, 405, 400, 404]
    assert "exceeds" in got[12][1]["error"]


def test_solves_sync_async_and_policy_equal_to_reference(roots):
    reqs = systems(8, 12)

    def script(url):
        out = []
        for k, s in enumerate(reqs[:4]):
            out.append(http("POST", url + "/v1/solve:sync",
                            payload(s, request_id=f"s{k}",
                                    x_true=k != 2)))
        for k, s in enumerate(reqs[4:]):
            code, body, h = http("POST", url + "/v1/solve",
                                 payload(s, request_id=f"a{k}"))
            assert code == 202, body
            result = await_result(url, body["request_id"])
            again = http("GET", f"{url}/v1/result/{body['request_id']}")
            out.append((code, body, h))
            out.append((200, result, {}))
            out.append(again)
        out.append(http("GET", url + "/v1/policy"))
        return [(c, b, _headers(h)) for c, b, h in out]

    got, pfd = exchange(PORT, roots["port"], script)
    want, rfd = exchange(REF, roots["ref"], script)
    assert got == want
    sync = [b for c, b, _ in got[:4]]
    assert all(b["status"] == "done" and b["policy_version"] == "v0001"
               for b in sync)
    assert [b["has_x_true"] for b in sync] == [True, True, False, True]
    assert got[0][2]["X-Request-Id"] == "s0"
    assert {b["bucket"] for b in sync} <= {16, 32, 48}
    for k in range(4):
        accepted, result, again = got[4 + 3 * k: 7 + 3 * k]
        assert accepted[1]["status"] == "queued"
        assert result[1]["client_request_id"] == f"a{k}"
        assert again[0] == 404                  # claimed exactly once
    policy = got[-1][1]
    assert policy == {"policy_version": "v0001", "current": "v0001",
                      "versions": ["v0001"], "history": ["v0001"]}
    assert pfd.server.telemetry.responses == 8
    np.testing.assert_array_equal(pfd.server.live.qtable.Q,
                                  rfd.server.live.qtable.Q)


def test_backpressure_429_and_drain_equal_to_reference(roots):
    burst = systems(4, 15, n_range=(20, 30))   # one bucket, 32

    def script(url):
        return [http("POST", url + "/v1/solve", payload(s)) for s in burst]

    cfg = dict(max_queue_depth=2, retry_after_s=1.5, flush_interval_s=10.0)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        # Nothing flushes on its own: the bucket fills, then close() drains.
        fd = pkg["http"].serve_http(
            server_for(pkg, roots[name], batcher_cfg=pkg["svc"].BatcherConfig(
                max_batch=64, max_wait_s=100.0, bucket_step=16,
                min_bucket=16)),
            cfg=pkg["http"].HttpConfig(max_n=48, **cfg))
        try:
            res = script(fd.url)
            assert fd.queue_depth(32) == 2
        finally:
            fd.close()
        out[name] = ([(c, b, _headers(h)) for c, b, h in res],
                     dict(fd._done))
    assert out["port"] == out["ref"]
    res, done = out["port"]
    assert [c for c, _, _ in res] == [202, 202, 429, 429]
    assert all(h["Retry-After"] == "2" for _, _, h in res[2:])
    assert res[2][1] == {"error": "bucket queue full", "bucket": 32,
                         "retry_after_s": 1.5}
    assert sorted(done) == [0, 1]
    assert all(p["status"] == "done" for p in done.values())


@pytest.mark.parametrize("wedge", ["raise", "block"])
def test_drain_deadline_fails_pending_and_answers_sync_503(roots, wedge):
    """A wedged drain cannot hold shutdown hostage: at drain_timeout_s
    what is pending gets a terminal failure, the waiting sync caller its
    503 at once, and the fire-and-poll ids hold `failed`. The drain is
    wedged by a flush that raises, or by a drain call that blocks (still
    running on the worker when close() returns)."""
    stuck = tsvc.BatcherConfig(max_batch=64, max_wait_s=100.0,
                               bucket_step=16, min_bucket=16)
    drain_s = 0.3
    srv = server_for(PORT, roots["port"], batcher_cfg=stuck)
    fd = thttp.serve_http(
        srv, cfg=thttp.HttpConfig(max_n=48, flush_interval_s=10.0,
                                  drain_timeout_s=drain_s,
                                  sync_timeout_s=30.0))
    release, entered = threading.Event(), threading.Event()

    def blocking_drain():
        entered.set()
        release.wait(TIMEOUT)

    reqs = systems(3, 18)
    sync_out = {}
    t = None
    try:
        rids = []
        for s in reqs[:2]:
            code, body, _ = http("POST", fd.url + "/v1/solve", payload(s))
            assert code == 202
            rids.append(body["request_id"])

        def sync_call():
            code, body, _ = http("POST", fd.url + "/v1/solve:sync",
                                 payload(reqs[2]))
            sync_out["code"], sync_out["body"] = code, body
            sync_out["at"] = time.monotonic()

        t = threading.Thread(target=sync_call)
        t.start()
        deadline = time.monotonic() + TIMEOUT
        while len(fd._pending) < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert len(fd._pending) == 3
        t0 = time.monotonic()
        if wedge == "raise":
            with tfaults.injected(tfaults.FaultSpec("batcher.flush",
                                                    "raise")):
                fd.close()
        else:
            srv.drain = blocking_drain
            fd.close()
            assert entered.is_set() and not release.is_set()
        closed = time.monotonic() - t0
    finally:
        fd.close()
        release.set()
        if t is not None:
            t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert sync_out["code"] == 503, sync_out
    assert sync_out["body"]["status"] == "failed"
    assert sync_out["at"] - t0 < drain_s + 5.0
    assert closed < drain_s + 5.0
    assert not fd._pending
    for rid in rids:
        assert fd._done[rid]["status"] == "failed" and fd._done[rid]["error"]


def test_draining_refuses_new_work_and_flush_supervisor_restarts(roots):
    fd = thttp.serve_http(server_for(PORT, roots["port"]),
                          cfg=thttp.HttpConfig(max_n=48,
                                               flush_interval_s=0.002))
    try:
        s = systems(1, 17)[0]
        fd._draining = True
        code, body, _ = http("POST", fd.url + "/v1/solve", payload(s))
        assert code == 503 and body == {"error": "server is draining"}
        fd._draining = False
        fd.server.auto_step = False
        with tfaults.injected(tfaults.FaultSpec("batcher.flush", "raise",
                                                max_fires=2)):
            code, body, _ = http("POST", fd.url + "/v1/solve", payload(s))
            assert code == 202
            assert await_result(fd.url, body["request_id"])["status"] \
                == "done"
        assert fd.flush_restarts >= 1
    finally:
        fd.close()


def test_retry_delay_equal_to_reference():
    import random
    for attempt in range(6):
        for ra in (None, "3", 0.2, "junk"):
            got = thttp.retry_delay(attempt, ra, rng=random.Random(attempt))
            want = rhttp.retry_delay(attempt, ra, rng=random.Random(attempt))
            assert got == want
    assert thttp.parse_retry_after(" 4 ") == rhttp.parse_retry_after(" 4 ")


# ---------------------------------------------------------------------------
# ShadowServer
# ---------------------------------------------------------------------------

def baseline_roots(tmp_path):
    """v0001 the stub snapshot, v0002 the port server's snapshot after 40
    requests (its meta carries the telemetry the gates read), copied for
    the JAX package."""
    reg = tsvc.PolicyRegistry(str(tmp_path / "port"))
    reg.promote(reg.publish(stub_policy(PORT), note="start"))
    srv = server_for(PORT, tmp_path / "port", obs=False)
    for s in systems(40, 3):
        srv.submit(s)
    srv.drain()
    srv.snapshot(note="baseline with telemetry evidence")
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    return {"port": tmp_path / "port", "ref": tmp_path / "ref"}


def degraded(reg):
    """Pinned to action 0, all-bf16: every solve stagnates."""
    pol = reg.load()
    pol.qtable.Q[:] = 0.0
    pol.qtable.Q[:, 0] = 1.0
    return reg.publish(pol, note="degraded: pinned to all-bf16")


def healthy(reg):
    return reg.publish(reg.load(), note="healthy: copy of baseline")


def shadow_for(pkg, root, rollout_kw=RCFG, log=None, obs=None, **kw):
    reg = pkg["svc"].PolicyRegistry(str(root))
    return pkg["svc"].ShadowServer(
        reg, SystemStubTask(pkg, reg.load().action_space),
        pkg["rewards"].W1, pkg["svc"].BatcherConfig(**BCFG),
        rollout_cfg=pkg["svc"].RolloutConfig(**rollout_kw),
        clock=FrozenClock(), seed=0,
        obs=obs if obs is not None else obs_for(pkg),
        decision_log_path=log, **kw), reg


def drive_rollout(shadow, stream):
    rids = []
    for s in stream:
        rids.append(shadow.submit(s))
        shadow.step()
        if shadow.phase != "canary":
            break
    shadow.drain()
    return [shadow.poll(r) for r in rids]


def trail(path):
    return [{k: v for k, v in json.loads(ln).items() if k != "ts"}
            for ln in open(path) if ln.strip()]


def decisions(shadow):
    return [(d.outcome, d.responses, d.windows_passed, d.failures,
             json.loads(json.dumps(d.evidence)), d.candidate_version,
             d.baseline_version) for d in shadow.decisions]


def rollout_families(obs):
    if isinstance(obs.registry, tmetrics.MetricsRegistry):
        from repro_torch.obs.expo import render_prometheus
    else:
        from repro.obs.expo import render_prometheus
    return [ln for ln in render_prometheus(obs.registry).splitlines()
            if "repro_rollout_" in ln]


def test_canary_routing_per_seed_equal_to_reference(tmp_path):
    roots = baseline_roots(tmp_path)
    reqs = systems(14, 5)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        shadow, reg = shadow_for(pkg, roots[name], rollout_kw=dict(
            canary_frac=0.5, shadow=True, decision_window=10 ** 9,
            min_samples=10 ** 9))
        cand = healthy(reg)
        shadow.start_rollout(cand)
        assert reg.current_version() == cand
        rids = [shadow.submit(s) for s in reqs]
        shadow.drain()
        resps = [shadow.poll(r) for r in rids]
        assert all(shadow.poll(r) is None for r in rids)
        state = shadow.rollout_state()
        out[name] = ([(r.policy_version, r.action, r.state, r.reward)
                      for r in resps], shadow.candidate.telemetry.responses,
                     {k: v for k, v in state.items()})
    assert out["port"] == out["ref"]
    versions = [v for v, _, _, _ in out["port"][0]]
    assert {"v0002", "v0003"} == set(versions)     # both slices served
    assert out["port"][1] == len(reqs)             # shadow mirrored all
    assert out["port"][2]["phase"] == "canary"


@pytest.mark.parametrize("kind", ["degraded", "healthy"])
def test_rollout_decisions_and_trail_equal_to_reference(tmp_path, kind):
    roots = baseline_roots(tmp_path)
    stream = systems(90, 9)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        obs = obs_for(pkg)
        log = str(tmp_path / f"{name}-decisions.jsonl")
        shadow, reg = shadow_for(pkg, roots[name], log=log, obs=obs)
        baseline = reg.current_version()
        cand = degraded(reg) if kind == "degraded" else healthy(reg)
        shadow.start_rollout(cand)
        resps = drive_rollout(shadow, stream)
        post = [shadow.submit(s) for s in systems(4, 13)]
        shadow.drain()
        post = [shadow.poll(r).policy_version for r in post]
        shadow.close()
        out[name] = dict(
            phase=shadow.phase, current=reg.current_version(),
            baseline=baseline, decisions=decisions(shadow),
            trail=trail(log), families=rollout_families(obs),
            responses=[(r.request_id, r.policy_version, r.action, r.reward)
                       for r in resps], post=post,
            state=shadow.rollout_state(), cand=cand)
    assert out["port"] == out["ref"]
    o = out["port"]
    kinds = [e["event"] for e in o["trail"]]
    assert kinds[0] == "start"
    if kind == "degraded":
        assert o["phase"] == "rolled_back" and o["current"] == o["baseline"]
        assert o["decisions"][-1][0] == "rollback"
        assert "pass_rate" in o["decisions"][-1][3]
        assert "rollback" in kinds and set(o["post"]) == {o["baseline"]}
        assert any('outcome="rollback"' in ln for ln in o["families"])
    else:
        assert o["phase"] == "promoted" and o["current"] == o["cand"]
        assert [d[0] for d in o["decisions"]][-1] == "promote"
        assert "promote" in kinds and set(o["post"]) == {o["cand"]}
        assert any('outcome="promote"' in ln for ln in o["families"])
    assert all(r is not None for r in o["responses"])


def test_ope_gate_verdict_equal_to_reference(tmp_path):
    roots = baseline_roots(tmp_path)
    # The logged stream: the port's server with a trajectory log.
    log = str(tmp_path / "traj.jsonl")
    srv = server_for(PORT, roots["port"], obs=obs_for(PORT, log))
    for s in systems(48, 21):
        srv.submit(s)
    srv.drain()
    srv.obs.close()
    records = tobs.TrajectoryLog.read_complete(log, task="stub")
    assert len(records) == 48
    ope_kw = dict(RCFG, ope_gate=True, ope_min_records=32,
                  ope_bootstrap=50, ope_margin=0.5)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        verdicts = []
        for make in (degraded, healthy):
            shadow, reg = shadow_for(pkg, roots[name], rollout_kw=ope_kw)
            cand = make(reg)
            try:
                shadow.start_rollout(cand, trajectories=records)
                refused = False
            except pkg["svc"].OPEGateRejected as e:
                refused = True
                assert e.report.reason == "lcb_below_floor"
            verdicts.append((refused, decisions(shadow),
                             reg.meta(cand)["ope_gate"], shadow.phase))
        out[name] = verdicts
    assert out["port"] == out["ref"]
    (bad_refused, bad_dec, bad_meta, bad_phase), \
        (ok_refused, ok_dec, ok_meta, ok_phase) = out["port"]
    assert bad_refused and bad_phase == "idle"
    assert bad_dec[-1][0] == "ope_reject" and not bad_meta["accept"]
    assert not ok_refused and ok_phase == "canary"
    assert ok_dec[-1][0] == "ope_accept" and ok_meta["accept"]


def test_http_rollout_primary_slice_equal_to_in_process_server(tmp_path):
    roots = baseline_roots(tmp_path)
    shadow, reg = shadow_for(PORT, roots["port"])
    baseline = reg.current_version()
    vbad = degraded(reg)
    shadow.start_rollout(vbad)
    fd = thttp.serve_http(shadow, cfg=thttp.HttpConfig(
        max_n=48, flush_interval_s=0.002))
    reqs = systems(60, 21)
    results = []
    try:
        for s in reqs:
            code, body, _ = http("POST", fd.url + "/v1/solve:sync",
                                 payload(s))
            assert code == 200, body
            results.append(body)
            if shadow.phase != "canary":
                break
        assert shadow.phase == "rolled_back"
        code, pol, _ = http("GET", fd.url + "/v1/policy")
        assert code == 200 and pol["current"] == baseline
        assert pol["rollout"]["phase"] == "rolled_back"
        assert vbad in pol["versions"]
    finally:
        fd.close()
    primary = [i for i, r in enumerate(results)
               if r["policy_version"] == baseline]
    assert primary and len(primary) < len(results)
    ref = server_for(PORT, roots["port"], obs=False)
    assert ref.policy_version == baseline
    for i in primary:
        rid = ref.submit(reqs[i])
        ref.drain()
        want = ref.poll(rid)
        got = results[i]
        assert (got["action"], got["state"], got["eps"], got["reward"],
                got["outcome"]["status"], got["outcome"]["ferr"]) == \
            (want.action, want.state, want.eps, want.reward,
             want.record.status, want.record.metrics["ferr"])
