"""The torch port's off-policy evaluation, trajectory replay and crash
recovery (`repro_torch.eval`, `repro_torch.service.recover_server`)
against the JAX package's, on the CPU; and the two API pieces that ride
with them, `AutotuneEngine.summarize` and `PolicyRegistry.annotate`,
with the deprecated `GMRESIREnv` shim.

  * OPE: the IPS / DM / DR estimates, their bootstrap CIs, ESS, support
    and per-bucket values, and the gate's report, bit-equal to the
    reference's on the same logged records (a synthetic epsilon-greedy
    stream over a known reward table, and a log the port's server wrote,
    scored for both packages' `SnapshotCandidate`s).
  * Replay: a trajectory log the port's server wrote replays bit for bit
    through the port's engine; a tampered record is caught.
  * Recovery: a server that dies without a snapshot (a stream with
    quarantined rewards after the last snapshot) is rebuilt by
    `recover_server` with Q/N, epsilon and the WAL sequence bit-equal to
    the live ones, the tail verified through `eval.replay`; a corrupt
    newest snapshot is skipped and CURRENT healed; a tampered log is
    refused. Across packages: each package recovers from the registry
    and log the other wrote, with the writer's live tables.
  * `summarize` and `annotate` equal to the reference's.

Servers run the duck-typed stub task of `tests/test_torch_http_rollout.py`
(an outcome that is a pure function of (system, action)) on frozen
clocks, every metrics registry private to the test.
"""
import contextlib
import json
import os

import numpy as np
import pytest

import repro.eval as reval
import repro.service as rsvc
import repro_torch.eval as teval
import repro_torch.obs as tobs
import repro_torch.faults as tfaults
import repro_torch.service as tsvc
from repro.core.engine import AutotuneEngine as RefEngine
from repro_torch.core.engine import AutotuneEngine as PortEngine
from test_torch_http_rollout import (PORT, REF, SystemStubTask,  # noqa: F401
                                     obs_for, private_default_registries,
                                     server_for, stub_policy, systems)

K, S, EPS = 5, 6, 0.3
R_TABLE = np.array([[float((s * K + a) % 7) - 3.0 + 2.0 * (a == s % K)
                     for a in range(K)] for s in range(S)])


def synthetic_records(n, seed, noise=0.05):
    """n logged epsilon-greedy decisions over R_TABLE in two buckets."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        s = int(rng.integers(S))
        explore = bool(rng.random() < EPS)
        a = int(rng.integers(K)) if explore else (s + 1) % K
        r = float(R_TABLE[s, a] + noise * rng.standard_normal())
        recs.append({"features": [float(s)], "state": s, "action": a,
                     "eps": EPS, "explore": explore, "reward": r,
                     "bucket": 16 if s % 2 == 0 else 32,
                     "request_id": i, "task": "synthetic"})
    return recs


def as_dicts(ests):
    return {k: v.to_dict() for k, v in ests.items()}


@pytest.mark.parametrize("policy", ["optimal", "behavior", "constant"])
def test_ope_estimates_equal_to_reference(policy):
    fn = {"optimal": lambda s: int(np.argmax(R_TABLE[s])),
          "behavior": lambda s: (s + 1) % K,
          "constant": lambda s: 0}[policy]
    recs = synthetic_records(400, seed=3)
    recs += [{"event": "decision"}, {**recs[0], "action": K + 1},
             {**recs[1], "reward": float("nan")}]
    cfg_kw = dict(n_bootstrap=120, ci=0.9, seed=7, weight_clip=10.0)
    got = teval.evaluate_policy(
        recs, teval.CallableCandidate(lambda f, s: fn(int(s))), n_actions=K,
        cfg=teval.OPEConfig(**cfg_kw))
    want = reval.evaluate_policy(
        recs, reval.CallableCandidate(lambda f, s: fn(int(s))), n_actions=K,
        cfg=reval.OPEConfig(**cfg_kw))
    assert as_dicts(got) == as_dicts(want)
    assert got["dr"].n == 400
    inc = teval.CallableCandidate(lambda f, s: (s + 1) % K, name="inc")
    rinc = reval.CallableCandidate(lambda f, s: (s + 1) % K, name="inc")
    for margin, min_records in ((0.5, 64), (0.0, 64), (0.5, 1000)):
        g = teval.ope_gate(recs, inc, teval.CallableCandidate(
            lambda f, s: fn(int(s))), K, margin=margin,
            min_records=min_records, cfg=teval.OPEConfig(**cfg_kw))
        w = reval.ope_gate(recs, rinc, reval.CallableCandidate(
            lambda f, s: fn(int(s))), K, margin=margin,
            min_records=min_records, cfg=reval.OPEConfig(**cfg_kw))
        assert g.to_event() == w.to_event()
    assert [teval.behavior_propensity(e, x, K) for e in (0.0, 0.3, 1.0)
            for x in (False, True)] == \
        [reval.behavior_propensity(e, x, K) for e in (0.0, 0.3, 1.0)
         for x in (False, True)]


def serve_logged(pkg, root, log, stream, snapshot_after=None, plan=None):
    """Serve `stream` on a stub server of `pkg` with a trajectory log,
    snapshotting after `snapshot_after` requests, under each package's
    injector for `plan` (FaultSpec keyword dicts); returns the server,
    its observability closed, without a final snapshot (the crash)."""
    srv = server_for(pkg, root, obs=obs_for(pkg, log))
    specs = [pkg["faults"].FaultSpec(**s) for s in (plan or [])]
    with (pkg["faults"].injected(*specs, seed=4) if specs
          else contextlib.nullcontext()):
        for k, s in enumerate(stream):
            srv.submit(s)
            if snapshot_after is not None and k + 1 == snapshot_after:
                srv.drain()
                srv.snapshot(note="mid-stream")
        srv.drain()
    srv.obs.close()
    return srv


def test_ope_of_a_port_log_scores_snapshots_equal_to_reference(tmp_path):
    from test_torch_http_rollout import baseline_roots
    roots = baseline_roots(tmp_path)
    log = str(tmp_path / "traj.jsonl")
    serve_logged(PORT, roots["port"], log, systems(40, 8))
    recs = tobs.TrajectoryLog.read_complete(log, task="stub")
    assert len(recs) == 40
    cfg = dict(n_bootstrap=60, seed=1)
    got = teval.evaluate_policy(
        recs, teval.SnapshotCandidate.from_registry(
            tsvc.PolicyRegistry(str(roots["port"])), "v0001"),
        cfg=teval.OPEConfig(**cfg))
    want = reval.evaluate_policy(
        recs, reval.SnapshotCandidate.from_registry(
            rsvc.PolicyRegistry(str(roots["ref"])), "v0001"),
        cfg=reval.OPEConfig(**cfg))
    assert as_dicts(got) == as_dicts(want)


def test_replay_of_a_port_log(tmp_path):
    from test_torch_http_rollout import baseline_roots
    roots = baseline_roots(tmp_path)
    log = str(tmp_path / "traj.jsonl")
    stream = systems(24, 6)
    srv = serve_logged(PORT, roots["port"], log, stream)
    recs = tobs.TrajectoryLog.read(log, task="stub")
    engine = PortEngine(srv.task, srv.reward_cfg, policy=srv.live)
    report = teval.replay_records(engine, recs, dict(enumerate(stream)))
    assert report.n_replayed == 24 and report.ok, report.summary()
    teval.assert_replay_ok(report)
    bad = [dict(r) for r in recs]
    bad[5]["reward"] += 1e-12
    bad[7]["outcome"] = dict(bad[7]["outcome"], ferr=1.0)
    report = teval.replay_records(engine, bad, dict(enumerate(stream)))
    assert {(m.request_id, m.field) for m in report.mismatches} == \
        {(5, "reward"), (7, "outcome.ferr")}
    with pytest.raises(AssertionError, match="2 mismatches"):
        teval.assert_replay_ok(report)
    # Records without an instance are skipped, and nothing verified fails.
    report = teval.replay_records(engine, recs, {})
    assert report.n_skipped == 24 and not report.ok
    with pytest.raises(AssertionError, match="nothing was verified"):
        teval.assert_replay_ok(report)


NAN_PLAN = [dict(site="solver.outcome", kind="nan", p=0.5, after=18,
                 max_fires=4)]


def same_state(a, b):
    np.testing.assert_array_equal(a.live.qtable.Q, b.live.qtable.Q)
    np.testing.assert_array_equal(a.live.qtable.N, b.live.qtable.N)
    assert a.learner.epsilon._level == b.learner.epsilon._level
    assert a.learner.epsilon._t == b.learner.epsilon._t
    assert a.update_seq == b.update_seq


def fresh_root(tmp_path, pkg=PORT):
    """A registry whose only version, v0001, is the stub snapshot (no WAL
    watermark: recovery from it replays the whole log)."""
    reg = pkg["svc"].PolicyRegistry(str(tmp_path / "reg"))
    reg.promote(reg.publish(stub_policy(pkg), note="start"))
    return tmp_path / "reg"


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["verified", "quarantined-tail"])
def test_kill_and_recover_bit_exact(tmp_path, faulted):
    """The tail verified through `eval.replay`; or, with NaN outcomes
    injected after the snapshot (quarantined rewards, which a replay of
    the real solves cannot reproduce), replayed without verification."""
    root = fresh_root(tmp_path)
    log = str(tmp_path / "traj.jsonl")
    stream = systems(40, 7)
    live = serve_logged(PORT, root, log, stream, snapshot_after=16,
                        plan=NAN_PLAN if faulted else None)
    assert (live.quarantined_updates > 0) == faulted
    reg = tsvc.PolicyRegistry(str(root))
    assert reg.current_version() == "v0002"
    rec = tsvc.recover_server(
        reg, log, verify_with=None if faulted else dict(enumerate(stream)),
        task=SystemStubTask(PORT, reg.load().action_space),
        reward_cfg=PORT["rewards"].W1, obs=False)
    same_state(rec, live)
    r = rec.last_recovery
    assert (r["version"], r["healed_current"], r["snapshot_seq"]) == \
        ("v0002", False, 16)
    assert r["replayed"] + r["skipped_quarantined"] == 24
    assert (r["skipped_quarantined"] > 0) == faulted
    assert r["skipped_stale"] == 16
    assert rec.degradation_state()["last_recovery"] == r
    if faulted:
        return

    # A corrupt newest snapshot: the one before it loads, CURRENT heals,
    # and the longer tail replays to the same tables.
    with open(os.path.join(reg.root, "versions", "v0002", "qtable.npz"),
              "wb") as f:
        f.write(b"garbage")
    rec = tsvc.recover_server(
        reg, log, task=SystemStubTask(PORT, reg.load("v0001").action_space),
        reward_cfg=PORT["rewards"].W1, obs=False)
    same_state(rec, live)
    assert rec.last_recovery["healed_current"]
    assert rec.last_recovery["corrupt_versions"] == ["v0002"]
    assert rec.last_recovery["snapshot_seq"] == 0
    assert reg.current_version() == "v0001"

    # A tampered tail is refused when verified.
    lines = open(log).read().splitlines()
    tampered = json.loads(lines[-1])
    tampered["reward"] = float(tampered["reward"]) + 1.0
    lines[-1] = json.dumps(tampered)
    with open(log, "w") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(AssertionError, match="mismatch"):
        tsvc.recover_server(
            reg, log, verify_with=dict(enumerate(stream)),
            task=SystemStubTask(PORT, reg.load().action_space),
            reward_cfg=PORT["rewards"].W1, obs=False)


@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_recovery_across_packages(tmp_path, writer, reader):
    root = fresh_root(tmp_path, writer)
    log = str(tmp_path / "traj.jsonl")
    stream = systems(30, 9)
    live = serve_logged(writer, root, log, stream, snapshot_after=12)
    rreg = reader["svc"].PolicyRegistry(str(root))
    rec = reader["svc"].recover_server(
        rreg, log, verify_with=dict(enumerate(stream)),
        task=SystemStubTask(reader, rreg.load().action_space),
        reward_cfg=reader["rewards"].W1, obs=False)
    same_state(rec, live)
    assert rec.last_recovery["replayed"] == 18


def test_replay_wal_tail_equal_to_reference(tmp_path):
    root = fresh_root(tmp_path)
    log = str(tmp_path / "traj.jsonl")
    serve_logged(PORT, root, log, systems(20, 10), plan=NAN_PLAN)
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        srv = server_for(pkg, root, obs=False)
        report = pkg["svc"].replay_wal_tail(srv, log, snapshot_seq=5)
        out[name] = (report.as_meta(), srv.live.qtable.Q.tolist(),
                     srv.live.qtable.N.tolist(), srv.update_seq)
    assert out["port"] == out["ref"]
    assert out["port"][0]["skipped_stale"] == 5


def test_summarize_and_annotate_equal_to_reference(tmp_path):
    from test_torch_http_rollout import baseline_roots
    roots = baseline_roots(tmp_path)
    # Eight pairs in one bucket: full chunks of 4 in both packages.
    insts = systems(8, 2, n_range=(17, 32))
    out = {}
    for name, pkg, Engine in (("port", PORT, PortEngine),
                              ("ref", REF, RefEngine)):
        reg = pkg["svc"].PolicyRegistry(str(roots[name]))
        space = reg.load().action_space
        eng = Engine(SystemStubTask(pkg, space), pkg["rewards"].W1, chunk=4)
        outs = eng.solve_adhoc([(s, k % space.n_actions)
                                for k, s in enumerate(insts)])
        full = eng.summarize()
        eng.solve_adhoc([(insts[0], 34)])       # a chunk of one row
        ragged = eng.summarize()
        meta = reg.annotate("v0002", "ope_gate", {"accept": True, "n": 3})
        out[name] = (full, ragged, meta, reg.verify("v0002")["ope_gate"],
                     [o.metrics["ferr"] for o in outs])
    (pf, pr, pm, pv, po), (rf, rr, rm, rv, ro) = out["port"], out["ref"]
    assert pf == rf and pm == rm and pv == rv and po == ro
    assert pf["n_solves"] == 8 and pf["n_pad_solves"] == 0
    # The port's tasks solve only the rows they are given: the JAX engine
    # counts the three padding rows of the ragged chunk, the port none.
    assert {k: v for k, v in pr.items() if "pad" not in k
            and k != "rows_per_device"} == \
        {k: v for k, v in rr.items() if "pad" not in k
         and k != "rows_per_device"}
    assert (pr["n_pad_solves"], rr["n_pad_solves"]) == (0, 3)


def test_gmres_env_shim_is_the_engine_over_the_task():
    from repro_torch.core import GMRESIREnv, W1, reduced_action_space
    from repro_torch.solvers import IRConfig
    from repro_torch.tasks import GMRESIRTask
    sysl = systems(2, 4, n_range=(10, 14))
    space, cfg = reduced_action_space(), IRConfig(tau=1e-6)
    env = GMRESIREnv(sysl, space, cfg, chunk=2, bucket_step=16,
                     device="cpu")
    eng = PortEngine(GMRESIRTask(sysl, space, cfg, bucket_step=16,
                                 device="cpu"), chunk=2)
    assert env.systems is env.task.instances and env.ir_cfg is cfg
    assert env.task.device.type == "cpu"
    for i, a in ((0, 34), (1, 20)):
        got, want = env.record(i, a), eng.outcome(i, a)
        assert got.status == want.status
        assert got.metrics == want.metrics
        assert env.reward(i, a, W1) == eng.reward(i, a, W1)
    assert env.summarize()["n_solves"] == 2
