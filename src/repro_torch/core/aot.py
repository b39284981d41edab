"""Ahead-of-time warmup of a server's buckets and the persistent build
cache (port of `repro.core.aot`; DESIGN.md §12).

What "compile" means on the card. Nothing here runs XLA: the kernels are
hand-written CUDA, built once into one shared library. A fresh process
pays, at its first request in a bucket, for the cold steps of
`kernels.library`: the nvcc build (20-45 s from nothing) unless a build
of the same sources and flags is found in the build directory, the
library's load, and each kernel instance's first launch (CUDA loads a
module lazily; the launchers set their shared-memory limits and look up
the SM count then), besides the first cuBLAS call of a shape and, with
`tune_blocking`, the panel-width sweep. This module moves those steps
ahead of traffic, three ways:

  * `plan()` + `precompile()` — enumerate the (task, bucket) grid and
    run each task's warm batches (`tasks.base.precompile_bucket`)
    through the very dispatcher and cells the live path dispatches
    from (`core.executor`), so a warmed server's first request launches
    no cold kernel instance. Warm and cold requests run the same code
    on the same kernels, so their outcomes are bit-equal.
  * `BackgroundWarmup` — the same sweep on a daemon thread, in priority
    order (most-traffic bucket first, smallest first among ties;
    traffic read from a trajectory log when one exists), so that the
    server's `/readyz` warm-bucket gate flips bucket by bucket.
  * `enable_persistent_cache()` — the library's build directory
    (``REPRO_COMPILE_CACHE_DIR``, `kernels.library.set_build_dir`): a
    restart over the same directory loads the build it finds and runs
    no nvcc. Its hits and misses (`cache_stats`) are mirrored into
    `obs` counters, so "the warm restart built nothing" is a counter
    assertion, not a timing guess.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

ENV_CACHE_DIR = "REPRO_COMPILE_CACHE_DIR"

_cache_dir: Optional[str] = None
_mirrored = {"hits": 0, "misses": 0}     # counts already in the counters


def _count(name: str, help: str, amount: float = 1.0, **labels) -> None:
    """Fail-open counter against the port's process-default metrics
    registry (DESIGN.md §8): warmup accounting must never take a server
    down."""
    try:
        from repro_torch.obs.metrics import default_registry
        fam = default_registry().counter(name, help,
                                         tuple(sorted(labels)))
        (fam.labels(**labels) if labels else fam).inc(amount)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Persistent build cache (cross-process reuse of the kernel library)
# ---------------------------------------------------------------------------


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Build and load the kernel library in `cache_dir` (or
    ``$REPRO_COMPILE_CACHE_DIR``); returns the directory in force, or
    None when neither is set and none was enabled before (no-op).
    Idempotent. The library is loaded at most once a process: after its
    first load the directory does not change, and the one in force is
    returned (`kernels.library.set_build_dir`)."""
    global _cache_dir
    d = cache_dir if cache_dir is not None else os.environ.get(ENV_CACHE_DIR)
    if not d:
        return _cache_dir
    d = os.path.abspath(d)
    if _cache_dir == d:
        return d
    os.makedirs(d, exist_ok=True)
    from repro_torch.kernels import library
    _cache_dir = str(library.set_build_dir(d))
    return _cache_dir


def cache_stats() -> dict:
    """Build-cache state: the directory enabled (None: not enabled; the
    library then builds in its default directory) and, since process
    start, hits (a build found and loaded without nvcc) and misses (an
    nvcc run). Mirrors new counts into ``repro_compile_cache_hits_total``
    and ``repro_compile_cache_misses_total``."""
    from repro_torch.kernels import library
    for key, name, help in (
            ("hits", "repro_compile_cache_hits_total",
             "Kernel library builds found in the build directory and "
             "loaded without nvcc."),
            ("misses", "repro_compile_cache_misses_total",
             "Kernel library builds made by nvcc (written to the build "
             "directory).")):
        new = library.CACHE[key] - _mirrored[key]
        if new > 0:
            _mirrored[key] += new
            _count(name, help, new)
    return {"dir": _cache_dir, "hits": int(library.CACHE["hits"]),
            "misses": int(library.CACHE["misses"])}


# ---------------------------------------------------------------------------
# Grid enumeration + priority order
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GridEntry:
    """One cell of the warmup grid: (task, bucket) at the serving chunk.
    The device, carrier and executor ride on the task; tasks running the
    same program share one dispatcher in `core.executor`
    (`computation_key`), so over-enumerating is safe."""
    task: object
    bucket: int
    chunk: int

    def labels(self) -> dict:
        return {"task": getattr(self.task, "name", "unknown"),
                "bucket": int(self.bucket),
                "backend": str(getattr(
                    getattr(self.task, "backend", None), "name",
                    "unknown")),
                "executor": str(getattr(
                    getattr(self.task, "executor", None), "name",
                    "unknown"))}


def bucket_traffic(trajectory_path: Optional[str]) -> Dict[int, int]:
    """Per-bucket request counts from a JSONL trajectory log
    (`obs.trajlog` format; fail-open: an unreadable path or row yields
    nothing). It makes warmup priority follow production traffic across
    restarts: the log survives the process, the warm cells do not."""
    counts: Dict[int, int] = {}
    if not trajectory_path:
        return counts
    try:
        with open(trajectory_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    b = json.loads(line).get("bucket")
                except Exception:
                    continue
                if b is not None:
                    counts[int(b)] = counts.get(int(b), 0) + 1
    except OSError:
        return counts
    return counts


def order_buckets(buckets: Sequence[int],
                  traffic: Optional[Dict[int, int]] = None,
                  trajectory_path: Optional[str] = None) -> List[int]:
    """Warmup priority: most-seen bucket first (explicit `traffic`
    counts plus trajectory-log counts), smallest first among ties:
    small buckets warm fastest, so the `/readyz` gate starts flipping
    early."""
    counts: Dict[int, int] = {int(b): int(c)
                              for b, c in (traffic or {}).items()}
    for b, c in bucket_traffic(trajectory_path).items():
        counts[b] = counts.get(b, 0) + c
    return sorted({int(b) for b in buckets},
                  key=lambda b: (-counts.get(b, 0), b))


def plan(tasks: Sequence, buckets: Sequence[int], chunk: int,
         traffic: Optional[Dict[int, int]] = None,
         trajectory_path: Optional[str] = None) -> List[GridEntry]:
    """The warmup grid in priority order: every task for the hottest
    bucket, then the next bucket, and so on."""
    ordered = order_buckets(buckets, traffic, trajectory_path)
    return [GridEntry(task, int(b), int(chunk))
            for b in ordered for task in tasks]


# ---------------------------------------------------------------------------
# Warmup sweeps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WarmupReport:
    """Outcome of one warmup sweep. `warmed`/`skipped` hold bucket keys
    in completion order (skipped: the task has no dispatchable form for
    the cell, or its warm batches raised; live traffic warms it)."""
    entries: int = 0
    warmed: List[int] = dataclasses.field(default_factory=list)
    skipped: List[int] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    seconds: float = 0.0
    done: bool = False


def _sweep(entries: Sequence[GridEntry], report: WarmupReport,
           on_entry: Optional[Callable], pace: Optional[Callable]
           ) -> WarmupReport:
    t0 = time.perf_counter()
    for e in entries:
        if pace is not None:
            pace(e)
        try:
            ok = bool(e.task.precompile_bucket(e.bucket, e.chunk))
        except Exception as err:
            # Fail-open by contract: warmup must never take a server
            # down. A live request on the bucket still launches its
            # kernels, or raises.
            ok = False
            report.errors.append(f"bucket {e.bucket}: {err!r}")
        (report.warmed if ok else report.skipped).append(int(e.bucket))
        _count("repro_warmup_buckets_total",
               "Grid cells processed by AOT warmup.",
               task=e.labels()["task"],
               status="warmed" if ok else "skipped")
        report.seconds = time.perf_counter() - t0
        if on_entry is not None:
            try:
                on_entry(e, ok)
            except Exception:
                pass
    cache_stats()
    report.done = True
    return report


def precompile(entries: Sequence[GridEntry],
               on_entry: Optional[Callable] = None) -> WarmupReport:
    """Run the grid now (the server's ``warmup="sync"``).
    `on_entry(entry, warmed)` fires after each cell: the server flips
    its per-bucket `/readyz` warm gate there."""
    return _sweep(entries, WarmupReport(entries=len(entries)),
                  on_entry, None)


class BackgroundWarmup:
    """`precompile()` on a daemon thread (``warmup="background"``): cells
    land one by one in priority order, flipping per-bucket state through
    `on_entry` while the server already accepts traffic.

    `pace` (optional) is called with each entry before it runs: a
    throttle. The warm batches and a live flush share the device and the
    interpreter lock (every launch goes through ctypes, which hands the
    lock over), so production can yield to serving between cells, and
    tests step the sweep deterministically. The per-cell locks in
    `core.executor` make a live solve racing the warmup of its cell wait
    for it, then run warm."""

    def __init__(self, entries: Sequence[GridEntry],
                 on_entry: Optional[Callable] = None,
                 pace: Optional[Callable] = None):
        self.entries = list(entries)
        self.report = WarmupReport(entries=len(self.entries))
        self._on_entry = on_entry
        self._pace = pace
        self._thread = threading.Thread(
            target=self._run, name="repro-aot-warmup", daemon=True)

    def start(self) -> "BackgroundWarmup":
        self._thread.start()
        return self

    def _run(self) -> None:
        _sweep(self.entries, self.report, self._on_entry, self._pace)

    @property
    def done(self) -> bool:
        return self.report.done

    def wait(self, timeout: Optional[float] = None) -> WarmupReport:
        self._thread.join(timeout)
        return self.report
