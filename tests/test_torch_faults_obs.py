"""The torch port's fault injection (`repro_torch.faults`) and
observability (`repro_torch.obs`) against the JAX package's, on the CPU.

  * For every fault kind, an injector of each package with the same
    specs and seed fires on the same hits over 200 of them (`p`,
    `after`, `max_fires` and `match` together); the injection-point
    helpers act alike (raise, I/O error, NaN and divergence outcomes,
    clock skew; `delay` with `time.sleep` replaced, so nothing sleeps);
    plan strings parse to the same specs.
  * The same metric operations (labeled counters, gauges, histograms,
    refused increments, a raising sink) give the same Prometheus text
    and the same JSON in both packages, and `lint_exposition` finds the
    same problems (none on the conventions' names).
  * The tracer's Chrome trace and the trajectory log's records,
    rotation and reading are equal; the log's records differ only in
    the wall-clock `ts`, which each package stamps itself.

Injectors are used directly or installed only through `injected`, and
each package's process-default metrics registry is a fresh one for each
test, and the JAX injector's environment-plan flag is restored after it,
so no global state outlives a test.
"""
import math

import numpy as np
import pytest

import repro.faults as rf
import repro.faults.injector as rinj
import repro.obs as robs
import repro.obs.metrics as rmetrics
import repro_torch.faults as tf
import repro_torch.faults.injector as tinj
import repro_torch.obs as tobs
import repro_torch.obs.metrics as tmetrics
from repro.core import task as rtask
from repro.obs import expo as rexpo
from repro_torch.core import task as ttask
from repro_torch.obs import expo as texpo

HITS = 200
PKGS = {"ref": (rf, rinj, robs, rmetrics, rexpo, rtask),
        "port": (tf, tinj, tobs, tmetrics, texpo, ttask)}


@pytest.fixture(autouse=True)
def private_default_registries(monkeypatch):
    monkeypatch.setattr(rinj, "_ENV_PARSED", rinj._ENV_PARSED)
    monkeypatch.setattr(rmetrics, "_DEFAULT_REGISTRY",
                        rmetrics.MetricsRegistry())
    monkeypatch.setattr(tmetrics, "_DEFAULT_REGISTRY",
                        tmetrics.MetricsRegistry())
    yield
    assert rinj._ACTIVE is None and tf.active() is None


def _plans(kind):
    """Spec lists for `kind`: alone with p < 1, with after/max_fires,
    and beside a second spec at the same site with a context match."""
    site = "clock" if kind == "clock_skew" else "solver.outcome"
    return [
        [dict(site=site, kind=kind, p=0.3)],
        [dict(site=site, kind=kind, p=0.6, after=7, max_fires=25)],
        [dict(site=site, kind=kind, p=0.5,
              match=lambda ctx: ctx.get("k", 0) % 3 != 0),
         dict(site=site, kind=kind, p=0.2, value=1.5)],
    ]


@pytest.mark.parametrize("kind", rf.KINDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_fire_schedule_equals_reference(kind, seed):
    for plan in _plans(kind):
        sched = {}
        for name, (faults, *_rest) in PKGS.items():
            inj = faults.FaultInjector([faults.FaultSpec(**s) for s in plan],
                                       seed=seed)
            site = plan[0]["site"]
            fired = []
            for k in range(HITS):
                spec = inj.fire(site, k=k)
                fired.append(None if spec is None
                             else inj.specs.index(spec))
            sched[name] = (fired, inj.counts())
        assert sched["port"] == sched["ref"]
        assert any(f is not None for f in sched["port"][0])
        assert any(f is None for f in sched["port"][0])


def test_injection_points_act_alike(monkeypatch):
    # Both injectors call the one `time.sleep`: record it instead.
    slept = []
    monkeypatch.setattr(tinj.time, "sleep", slept.append)
    seen = {}
    for name, (faults, _, _, _, _, task) in PKGS.items():
        out = []
        start = len(slept)
        base = task.Outcome(status=0, cost=4.0,
                            metrics={"ferr": 1e-9, "nbe": 1e-12})
        for kind in ("raise", "io_error", "delay"):
            with faults.injected(faults.FaultSpec("batcher.flush", kind,
                                                  p=0.5, value=0.25),
                                 seed=3):
                for _ in range(12):
                    try:
                        faults.maybe_raise("batcher.flush")
                        out.append("none")
                    except faults.FaultInjected:
                        out.append("raise")
                    except OSError:
                        out.append("oserror")
        for kind in ("nan", "divergence"):
            with faults.injected(faults.FaultSpec("solver.outcome", kind,
                                                  p=0.5), seed=4):
                for _ in range(8):
                    o = faults.corrupt_outcome("solver.outcome", base)
                    out.append((int(o.status), repr(o.cost),
                                sorted((k, repr(v))
                                       for k, v in o.metrics.items())))
        now = [100.0]
        clock = faults.wrap_clock(lambda: now[0])
        with faults.injected(faults.FaultSpec("clock", "clock_skew",
                                              value=2.0, max_fires=3)):
            out.append([clock() for _ in range(5)])
        out.append(clock())
        # A plan string in the JAX package's grammar.
        inj = faults.from_env("solver.outcome:divergence:p=0.15;"
                              "trajlog.write:io_error:max=3:after=2;"
                              "clock:clock_skew:value=0.5", seed=9)
        out.append([(s.site, s.kind, s.p, s.after, s.max_fires, s.value)
                    for s in inj.specs])
        seen[name] = (out, slept[start:])
    assert seen["port"] == seen["ref"]
    assert seen["port"][1] and set(seen["port"][1]) == {0.25}
    for bad in ("solver.outcome", "nowhere:raise", "clock:melt",
                "clock:clock_skew:speed=2"):
        with pytest.raises(ValueError):
            tf.from_env(bad)
    with pytest.raises(ValueError):
        tf.FaultSpec("nowhere", "raise")


def test_fires_count_on_the_ports_default_registry():
    with tf.injected(tf.FaultSpec("engine.solve", "delay", value=0.0)):
        tf.maybe_raise("engine.solve")
    text = texpo.render_prometheus(tmetrics.default_registry())
    assert ('repro_faults_injected_total{site="engine.solve",kind="delay"}'
            ' 1') in text
    assert rmetrics.default_registry().collect() == []


def _exercise(metrics_mod):
    """The same metric operations on a fresh registry of a package."""
    reg = metrics_mod.MetricsRegistry()
    seen = []
    reg.add_sink(lambda name, labels, v: seen.append((name, labels, v)))
    reg.add_sink(lambda *a: 1 / 0)                   # a raising sink
    c = reg.counter("repro_service_requests_total", "Requests.",
                    ("task", "bucket"))
    g = reg.gauge("repro_online_epsilon", "Epsilon.")
    h = reg.histogram("repro_service_request_latency_seconds",
                      "Latency.", ("task",))
    r = reg.histogram("repro_service_flush_pad_waste_ratio", "Waste.",
                      buckets=metrics_mod.RATIO_BUCKETS)
    rng = np.random.default_rng(0)
    for k in range(40):
        c.labels(task="gmres_ir", bucket=128 * (1 + k % 3)).inc()
        c.labels(task='we"ird\n\\', bucket=0).inc(2.5)
        g.set(float(rng.uniform()))
        g.inc(0.125)
        h.labels(task="gmres_ir").observe(float(rng.exponential(0.2)))
        r.observe(float(rng.uniform()))
    c.labels(task="gmres_ir", bucket=128).inc(-1)    # refused, counted
    c.labels(task="gmres_ir", bucket=128).inc(math.inf)
    h.labels(task="x").observe("not a number")
    reg.counter("repro_x_total", "", ("a",))
    with pytest.raises(ValueError):
        reg.counter("repro_x_total", "", ("b",))
    with pytest.raises(ValueError):
        c.labels(task="t")
    return reg, seen


def test_exposition_equals_reference():
    rreg, rseen = _exercise(rmetrics)
    treg, tseen = _exercise(tmetrics)
    assert tseen == rseen
    assert treg.errors == rreg.errors > 0
    ttext = texpo.render_prometheus(treg)
    assert ttext == rexpo.render_prometheus(rreg)
    assert texpo.render_json(treg) == rexpo.render_json(rreg)
    assert texpo.lint_exposition(ttext) == []
    bad = ("# TYPE myapp_requests counter\nmyapp_requests 1\n"
           "# TYPE repro_wait histogram\nrepro_wait_count{Bad=\"1\"} 2\n"
           "garbage line here\n")
    assert texpo.lint_exposition(bad) == rexpo.lint_exposition(bad)
    assert len(texpo.lint_exposition(bad)) >= 4


def test_fail_open_guard_equals_reference():
    out = {}
    for name, (_, _, obs, metrics, _, _) in PKGS.items():
        class Facade:
            def __init__(self):
                self.registry = metrics.MetricsRegistry()

            @metrics.fail_open
            def boom(self):
                raise RuntimeError("instrumentation fault")

        f = Facade()
        out[name] = (f.boom(), f.boom(), f.registry.errors)
    assert out["port"] == out["ref"] == (None, None, 2)


def test_tracer_and_trajectory_log_equal_reference(tmp_path):
    traces, records, segments = {}, {}, {}
    rng = np.random.default_rng(1)
    recs = [{"ts": 0.0, "request_id": k, "task": "gmres_ir",
             "bucket": 128, "features": rng.uniform(size=2).tolist(),
             "state": int(k % 5), "action": int(k % 7),
             "action_names": ["bf16", "fp32", "fp64", "fp64"],
             "eps": 0.1, "explore": bool(k % 2), "reward": float(k) / 3,
             "outcome": {"status": 0, "cost": 4.0,
                         "ferr": np.float64(1e-9)},
             "latency_s": 0.25, "policy_version": "v0001",
             "drift": False, "seq": k + 1, "quarantined": False}
            for k in range(30)]
    for name, (_, _, obs, _, _, _) in PKGS.items():
        tr = obs.Tracer(capacity=8)
        for k in range(12):
            tr.add_span("solve", k * 0.5, k * 0.5 + 0.25, tid=k,
                        bucket=128, n_rows=np.int64(4), note=object)
        traces[name] = tr.chrome_trace()
        path = tmp_path / f"{name}.jsonl"
        with obs.TrajectoryLog(str(path), max_bytes=2048,
                               max_segments=2) as log:
            for rec in recs:
                log.append(rec)
            rotations = log.rotations
        with open(path, "a") as f:
            f.write('{"torn": ')                     # a torn tail write
        records[name] = obs.TrajectoryLog.read(str(path))
        segments[name] = ([p.rsplit("/", 1)[1].split(".", 1)[1]
                           for p in obs.TrajectoryLog.segments(str(path))],
                          rotations,
                          obs.TrajectoryLog.read_complete(str(path)))
    assert traces["port"] == traces["ref"]
    assert len(traces["port"]["traceEvents"]) == 8
    assert records["port"] == records["ref"]
    assert segments["port"] == segments["ref"]
    assert segments["port"][1] > 0
