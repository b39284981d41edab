"""Startup sweep for the blocked-LU panel width (port of
`repro.solvers.block_autotune`; DESIGN.md §6.4).

`BlockingPolicy(lu_block=64)` is a fixed choice; the right width depends
on the size bucket and the device. This module applies the bandit's own
recipe to that knob: measure every arm once, commit to the greedy
winner, cache the decision. `tuned_blocking(n_pad, device=...)` times
the blocked factorization and both triangular substitutions of one
preconditioner application for each candidate panel width on a
representative bucket-sized system and returns the base policy with
`lu_block` swapped for the fastest candidate, on the carrier the solves
use (`carrier_dtype`, as `backend_for` takes it). Results are cached per
(bucket, backend, carrier, device, base policy, candidates), so the
sweep runs once per process.

What is timed is what the JAX package times, one compiled program per
width: on CUDA, the device's work of the width's pipeline. After one
warm-up call, the pipeline is captured once in a `torch.cuda.CUDAGraph`
(it reads nothing back to the host, and the kernel wrappers launch on
the current stream, which capture redirects), and each replay of the
graph is timed with CUDA events, so the host's launches are not in the
time. A pipeline that cannot be captured raises. On the CPU the call is
timed with `time.perf_counter`. Best of `repeats` either way. The timer
of each device type is `_TIMERS[device.type]`.

Panel width is a *semantic* config, not only a schedule: partial
pivoting is restricted to the panel, so different widths give
(legitimately) different factorizations. Tasks therefore opt in via
`tune_blocking=True` (`tasks.base.LinearSystemTask`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.precision import FORMAT_ID, backend_for, resolve_device

from .blocking import BlockingPolicy, resolve_blocking
from .lu import lu_factor_blocked
from .triangular import lu_solve

DEFAULT_CANDIDATES: Tuple[int, ...] = (32, 64, 128)

# (n_pad, backend name, carrier, device, base policy, candidates) -> tuned
# policy.
_CACHE: Dict[tuple, BlockingPolicy] = {}
# Raw sweep timings (seconds), kept for reporting.
_TIMINGS: Dict[tuple, Dict[int, float]] = {}


def _pipeline(A, b, fmt_id, block: int, trisolve_block: int, backend):
    """The factorization hot path a panel width governs: blocked LU +
    the two blocked triangular substitutions of one preconditioner
    application."""
    pol = BlockingPolicy(min_n=0, lu_block=block,
                         trisolve_block=trisolve_block)
    f = lu_factor_blocked(A, fmt_id, block=block, backend=backend)
    return lu_solve(f.lu, f.perm, b, fmt_id, backend=backend, blocking=pol)


def _graph_seconds(run, repeats: int) -> float:
    """Device seconds of `run`'s work: the best of `repeats` replays of
    one CUDA graph of it, each between two CUDA events. `run` is called
    once before the capture (the kernels' one-off set-up, which a
    capture cannot hold)."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del graph
    return best


def _host_seconds(run, repeats: int) -> float:
    """Seconds of one call of `run` on the host clock, best of
    `repeats`, after one warm-up call."""
    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


# The sweep's timer of each device type.
_TIMERS = {"cuda": _graph_seconds, "cpu": _host_seconds}


@torch.inference_mode()
def sweep_lu_block(n_pad: int, device=None,
                   candidates: Sequence[int] = DEFAULT_CANDIDATES,
                   trisolve_block: int = 128, repeats: int = 3,
                   seed: int = 0, carrier_dtype=None) -> Dict[int, float]:
    """Seconds per candidate panel width (best of `repeats`, after one
    warm-up call) for an `n_pad`-sized factorization + solve on
    `device` and `carrier_dtype` (`backend_for`'s): the device's work on
    CUDA, the host's on the CPU (`_TIMERS`). Candidates wider than
    `n_pad` are skipped."""
    dev = resolve_device(device)
    bk = backend_for(dev, carrier_dtype)
    rng = np.random.default_rng(seed)
    # Diagonally dominant representative system: pivoting stays busy but
    # the factorization never hits the failure path mid-measurement.
    A = rng.standard_normal((n_pad, n_pad)) + n_pad * np.eye(n_pad)
    b = rng.standard_normal(n_pad)
    A, b = bk.coerce(torch.as_tensor(A, device=dev),
                     torch.as_tensor(b, device=dev))
    fmt = FORMAT_ID["fp32"]
    timer = _TIMERS[dev.type]
    times: Dict[int, float] = {}
    for block in candidates:
        if block > n_pad:        # wider than the matrix: pure waste
            continue

        def run(block=int(block)):
            return _pipeline(A, b, fmt, block, int(trisolve_block), bk)
        times[int(block)] = timer(run, repeats)
    return times


def tuned_blocking(n_pad: int, device=None,
                   base: Optional[BlockingPolicy] = None,
                   candidates: Sequence[int] = DEFAULT_CANDIDATES,
                   carrier_dtype=None) -> BlockingPolicy:
    """`base` with `lu_block` replaced by the sweep winner for (`n_pad`,
    `device`, `carrier_dtype`). Below the base policy's threshold (or
    with blocking disabled) the sweep is skipped: the strict path runs
    and the panel width is irrelevant."""
    pol = resolve_blocking(base)
    if not pol.use_blocked(n_pad):
        return pol
    dev = resolve_device(device)
    bk = backend_for(dev, carrier_dtype)
    key = (int(n_pad), bk.name, bk.carrier_dtype, str(dev), pol,
           tuple(int(c) for c in candidates))
    if key not in _CACHE:
        times = sweep_lu_block(n_pad, device=dev, candidates=candidates,
                               trisolve_block=pol.trisolve_block,
                               carrier_dtype=carrier_dtype)
        _TIMINGS[key] = times
        if not times:
            _CACHE[key] = pol
        else:
            best = min(times, key=times.get)       # greedy over measured arms
            _CACHE[key] = dataclasses.replace(pol, lu_block=best)
    return _CACHE[key]


def sweep_timings() -> Dict[tuple, Dict[int, float]]:
    """Raw timings of every sweep this process ran (for reporting)."""
    return dict(_TIMINGS)
