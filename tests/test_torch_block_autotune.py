"""The blocked-LU panel-width sweep of the torch port
(`repro_torch.solvers.block_autotune`) and the tasks' `solver_cfg_for`.

The timings vary, so only the deterministic parts are held: the timer
of each device type (on CUDA the replays of one CUDA graph of the
pipeline, on the CPU the host clock; held here with a stand-in timer,
and on the card in tests/test_torch_cuda.py), which candidates are
measured (none wider than n_pad), that `tuned_blocking` returns the
base policy below its threshold and swaps only `lu_block` above it
(for the fastest arm of given timings), the cache key (bucket, backend,
carrier, device, base policy, candidates), and
`solver_cfg_for` with and without `tune_blocking`. Each candidate
width's `_pipeline` (blocked LU + both blocked substitutions) on the
sweep's representative system is held bit for bit against the JAX
package's `_pipeline` at that width, in bf16 and fp16, formats narrower
than both carriers (every dot result is rounded then, so the reference
pins the bits).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.precision import JnpBackend
from repro.solvers import block_autotune as jba
from repro_torch.solvers import BlockingPolicy, CGConfig, IRConfig
from repro_torch.solvers import block_autotune as tba
from repro_torch.tasks import CGIRTask, GMRESIRTask

BASE = BlockingPolicy(min_n=32, lu_block=64, trisolve_block=16)


@pytest.fixture
def fresh_cache(monkeypatch):
    """Empty sweep caches, and a sweep stand-in that records its calls
    and returns fixed timings (width 32 fastest)."""
    monkeypatch.setattr(tba, "_CACHE", {})
    monkeypatch.setattr(tba, "_TIMINGS", {})
    calls = []

    def sweep(n_pad, device=None, candidates=tba.DEFAULT_CANDIDATES,
              trisolve_block=128, repeats=3, seed=0, carrier_dtype=None):
        calls.append((n_pad, str(device), tuple(candidates),
                      trisolve_block))
        return {int(c): 1.0 if c == 32 else 2.0 + c for c in candidates
                if c <= n_pad}
    monkeypatch.setattr(tba, "sweep_lu_block", sweep)
    return calls


def test_sweep_measures_no_candidate_wider_than_n_pad():
    times = tba.sweep_lu_block(48, device="cpu", candidates=(16, 32, 64),
                               trisolve_block=16, repeats=1)
    assert sorted(times) == [16, 32]
    assert all(np.isfinite(t) and t > 0 for t in times.values())
    assert tba.sweep_lu_block(16, device="cpu", candidates=(32, 64),
                              trisolve_block=16, repeats=1) == {}


def test_tuned_blocking_keeps_the_base_below_its_threshold(fresh_cache):
    assert tba.tuned_blocking(16, device="cpu", base=BASE) is BASE
    off = dataclasses.replace(BASE, enabled=False)
    assert tba.tuned_blocking(64, device="cpu", base=off) is off
    assert fresh_cache == []


def test_tuned_blocking_swaps_only_the_panel_width(fresh_cache):
    pol = tba.tuned_blocking(64, device="cpu", base=BASE,
                             candidates=(16, 32, 64, 128))
    assert pol == dataclasses.replace(BASE, lu_block=32)
    assert fresh_cache == [(64, "cpu", (16, 32, 64, 128), 16)]
    # No candidate fits: the base policy, measured once.
    assert tba.tuned_blocking(64, device="cpu", base=BASE,
                              candidates=(128,)) == BASE


def test_tuned_blocking_caches_by_bucket_backend_device_base_and_arms(
        fresh_cache):
    first = tba.tuned_blocking(64, device="cpu", base=BASE)
    assert tba.tuned_blocking(64, device="cpu", base=BASE) is first
    assert len(fresh_cache) == 1
    key = (64, "torch", None, "cpu", BASE, tba.DEFAULT_CANDIDATES)
    assert set(tba.sweep_timings()) == {key}
    assert tba.sweep_timings()[key] == {32: 1.0, 64: 66.0}
    tba.tuned_blocking(96, device="cpu", base=BASE)
    tba.tuned_blocking(64, device="cpu",
                       base=dataclasses.replace(BASE, trisolve_block=32))
    tba.tuned_blocking(64, device="cpu", base=BASE, candidates=(16, 32))
    tba.tuned_blocking(64, device="cpu", base=BASE,
                       carrier_dtype="float32")
    assert len(fresh_cache) == 5
    assert len(tba.sweep_timings()) == 5
    assert (64, "torch", torch.float32, "cpu", BASE,
            tba.DEFAULT_CANDIDATES) in tba.sweep_timings()


def test_tuned_blocking_on_the_host_picks_a_measured_arm(monkeypatch):
    monkeypatch.setattr(tba, "_CACHE", {})
    monkeypatch.setattr(tba, "_TIMINGS", {})
    pol = tba.tuned_blocking(48, device="cpu", base=BASE,
                             candidates=(16, 32, 64))
    assert pol.lu_block in (16, 32)
    assert dataclasses.replace(pol, lu_block=BASE.lu_block) == BASE


@pytest.mark.parametrize("task_cls, cfg", [
    (GMRESIRTask, IRConfig(blocking=BASE)),
    (CGIRTask, CGConfig(blocking=BASE))])
def test_solver_cfg_for_with_and_without_tune_blocking(task_cls, cfg,
                                                       fresh_cache):
    plain = task_cls(device="cpu")
    assert plain.solver_cfg_for(cfg, 64) is cfg
    tuned = task_cls(device="cpu", tune_blocking=True)
    got = tuned.solver_cfg_for(cfg, 64)
    assert got == dataclasses.replace(
        cfg, blocking=dataclasses.replace(BASE, lu_block=32))
    assert tuned.solver_cfg_for(cfg, 64) is got      # cached per bucket
    assert tuned.solver_cfg_for(cfg, 16) is cfg      # strict bucket
    # Cached per (config type, bucket): another config type sweeps
    # nothing new (the sweep's own cache), but gets its own config.
    other = (CGConfig if isinstance(cfg, IRConfig) else IRConfig)(
        blocking=BASE)
    assert type(tuned.solver_cfg_for(other, 64)) is type(other)
    assert len(fresh_cache) == 1


def test_each_device_type_has_its_timer():
    """The card's sweep times the device's work (replays of one CUDA
    graph of the pipeline), the CPU's the host's clock."""
    assert tba._TIMERS == {"cuda": tba._graph_seconds,
                           "cpu": tba._host_seconds}


def test_host_timer_warms_up_then_keeps_the_best_of_repeats(monkeypatch):
    ticks = iter([0.0, 5.0, 10.0, 12.0, 20.0, 29.0])
    monkeypatch.setattr(tba.time, "perf_counter", lambda: next(ticks))
    calls = []
    assert tba._host_seconds(lambda: calls.append(1), 3) == 2.0
    assert len(calls) == 4                    # one warm-up, three timed


def test_sweep_uses_the_device_types_timer_and_caches_its_winner(
        monkeypatch):
    """A stand-in timer in the CPU's slot: the sweep hands it one
    pipeline per width with the sweep's repeats, keeps what it returns,
    and `tuned_blocking` commits to its fastest width once per key."""
    monkeypatch.setattr(tba, "_CACHE", {})
    monkeypatch.setattr(tba, "_TIMINGS", {})
    seen = []

    def stand_in(run, repeats):
        out = run()
        seen.append((repeats, tuple(out.shape)))
        return {1: 3.0, 2: 1.0, 3: 2.0}[len(seen)]
    monkeypatch.setattr(tba, "_TIMERS", {"cpu": stand_in})
    times = tba.sweep_lu_block(48, device="cpu", candidates=(8, 16, 32),
                               trisolve_block=16, repeats=5)
    assert times == {8: 3.0, 16: 1.0, 32: 2.0}
    assert seen == [(5, (48,))] * 3
    seen.clear()
    pol = tba.tuned_blocking(48, device="cpu", base=BASE,
                             candidates=(8, 16, 32))
    assert pol == dataclasses.replace(BASE, lu_block=16)
    assert tba.tuned_blocking(48, device="cpu", base=BASE,
                              candidates=(8, 16, 32)) is pol
    assert len(seen) == 3                     # swept once


_REF_PIPELINE = {}


def _reference_pipeline(block, trisolve_block, carrier):
    key = (block, trisolve_block, carrier)
    if key not in _REF_PIPELINE:
        bk = JnpBackend(carrier_dtype="float32" if carrier == "float32"
                        else None)
        _REF_PIPELINE[key] = jax.jit(lambda A, b, f: jba._pipeline(
            A, b, f, block=block, trisolve_block=trisolve_block,
            backend=bk))
    return _REF_PIPELINE[key]


@pytest.mark.parametrize("carrier", ["float32", "float64"])
@pytest.mark.parametrize("block", tba.DEFAULT_CANDIDATES)
def test_pipeline_matches_reference_at_each_width(block, carrier):
    """The sweep's system (A = randn + n_pad I, seed 0) at n_pad 128,
    each candidate width, trisolve block 128 (the default policy's)."""
    from repro_torch.precision import TorchBackend
    n_pad = 128
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((n_pad, n_pad))
         + n_pad * np.eye(n_pad)).astype(carrier)
    b = rng.standard_normal(n_pad).astype(carrier)
    run = _reference_pipeline(block, 128, carrier)
    bk = TorchBackend()
    for fid in (2, 3):                        # bf16, fp16
        want = np.asarray(run(A, b, fid))
        got = tba._pipeline(torch.from_numpy(A), torch.from_numpy(b), fid,
                            block, 128, bk)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"fid {fid}")
