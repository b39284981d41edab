"""Solve executors: the dispatch of the engine's and the micro-batcher's
batched solves (port of `repro.core.executor`; DESIGN.md §7, §12).

Every solve the engine or the serving micro-batcher runs is one stacked
batch of a bucket's rows — `(B, n_pad, n_pad)` matrices, their `(B,
n_pad)` vectors and `(B, 4)` action rows — run as one batched program on
the task's device (`solvers.gmres_ir_batch` / `cg_ir_batch`). A
`SolveExecutor` says how many rows one call takes (`preferred_chunk`),
where the arrays go (`shard`) and how the program is dispatched over
them (`dispatch`):

  * `LocalExecutor` — one device, the task's.

Solver entry points arrive as `LowerableCall`s: the module-level batched
program plus its hashable statics (config, backend, device), with the
move to the device and the carrier cast split out (`prepare`). They key
the dispatcher memo by value (`computation_key`, `batch_callable`), so
every task and call site running the same program shares one dispatcher.

What is cold on the card is not an XLA compile but the first run of a
*cell*: each kernel instance's first launch (CUDA loads a module lazily
and the launchers make their one-time preparation then,
`kernels.library.COLD_LAUNCHES`), the first cuBLAS call of a shape and
the allocator's first blocks of a size. A dispatcher keeps the cells it
has run; `executor_compile_log` holds one record per cell's first run,
whether AOT warmup (`precompile`) or a live first hit ran it, with its
seconds. A cell is keyed by what selects kernel instances, not by the
reference's array shapes: the port runs only the live rows of a flush
(`core.batching`) and a row's bits do not depend on the batch size, so
the row count is not part of it, only whether the batch is one row (the
chop kernel's one-format launch path) or several; beside it the padded
size, the carrier and the device. The per-cell lock makes a live solve
racing the warmup of the same cell wait for it, then run warm.

The multi-GPU `ShardedExecutor` is not ported yet (ROADMAP.md Queue 1
item 7). The port has no executor chosen by an environment variable:
`resolve_executor` takes an instance, a registered name (``"local"``) or
None (`set_default_executor`'s, else the local executor).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch


@dataclasses.dataclass(frozen=True)
class LowerableCall:
    """A batched solver entry point in dispatchable form (DESIGN.md §12).

    `entry` is the module-level batched program and `statics` its
    hashable keyword arguments; together they are the computation's
    identity (`computation_key`): two tasks over the same solver config,
    device and carrier give equal `LowerableCall`s and share one
    dispatcher. `prepare` moves the arrays to the device and casts them
    to the carrier; it is fully determined by (entry, statics) and left
    out of equality, so a closure's identity cannot split the memo."""
    entry: Any
    statics: Tuple[Tuple[str, Any], ...] = ()
    prepare: Optional[Callable] = dataclasses.field(
        default=None, compare=False)

    def bind(self, arrays: Sequence) -> Tuple:
        """The arrays the program runs on: `prepare` applied."""
        if self.prepare is None:
            return tuple(arrays)
        return tuple(self.prepare(*arrays))

    def run(self, args: Sequence):
        """The program over already-bound arrays."""
        return self.entry(*args, **dict(self.statics))

    def __call__(self, *arrays):
        return self.run(self.bind(arrays))


def computation_key(solve_fn: Callable, key=None):
    """Memo key of a batched computation: an explicit `key`, else a
    `LowerableCall`'s (entry, statics), else the callable itself."""
    if key is not None:
        return key
    if isinstance(solve_fn, LowerableCall):
        return (solve_fn.entry, solve_fn.statics)
    return solve_fn


# Process-wide record of the cells' first runs (DESIGN.md §12), from AOT
# warmup and from live first hits alike.
_COMPILE_LOG: List[dict] = []
_COMPILE_LOCK = threading.Lock()

_COMPILE_SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                            30.0, 60.0, 120.0)


def executor_compile_count() -> int:
    """Cells run for the first time in this process (all executors)."""
    return len(_COMPILE_LOG)


def executor_compile_log() -> List[dict]:
    """Copies of the per-cell records: executor, bucket, rows (of the
    batch that ran the cell first), carrier, device, backend, seconds."""
    with _COMPILE_LOCK:
        return [dict(r) for r in _COMPILE_LOG]


def _backend_label(solve_fn) -> str:
    if isinstance(solve_fn, LowerableCall):
        for k, v in solve_fn.statics:
            if k == "backend":
                return str(getattr(v, "name", v))
    return "unknown"


def _record_compile(executor_name: str, solve_fn, cell: tuple, rows: int,
                    seconds: float) -> None:
    n_pad, carrier, device, _ = cell
    backend = _backend_label(solve_fn)
    with _COMPILE_LOCK:
        _COMPILE_LOG.append({"executor": executor_name,
                             "bucket": int(n_pad), "rows": int(rows),
                             "carrier": str(carrier).replace("torch.", ""),
                             "device": str(device), "backend": backend,
                             "seconds": float(seconds)})
    # Fail-open against the port's process-default metrics registry
    # (DESIGN.md §8): accounting must never break a solve.
    try:
        from repro_torch.obs.metrics import default_registry
        reg = default_registry()
        reg.histogram(
            "repro_compile_seconds",
            "Wall seconds of a cell's first run (kernel instances' first "
            "launches, first library calls) per size bucket and "
            "precision backend.",
            ("bucket", "backend"),
            buckets=_COMPILE_SECONDS_BUCKETS).labels(
                bucket=n_pad, backend=backend).observe(seconds)
        reg.counter(
            "repro_executor_compiles_total",
            "Cells run for the first time in-process by the dispatchers "
            "(AOT warmup and lazy first hits both count).",
            ("executor",)).labels(executor=executor_name).inc()
    except Exception:
        pass


class SolveExecutor:
    """Interface shared by all solve executors (duck-typed; this base
    class documents the contract and hosts the shared dispatch)."""

    name: str = "abstract"

    def preferred_chunk(self, chunk: int, bucket: int = 0) -> int:
        """Dispatch granularity: the smallest batch size >= `chunk` this
        executor can lay out. The engine sizes its chunks and the
        micro-batcher its flush target with this."""
        raise NotImplementedError

    def shard(self, arrays: Sequence, n_pad: int) -> Tuple:
        """Place stacked batch arrays on this executor's devices."""
        raise NotImplementedError

    def wrap(self, solve_fn: Callable) -> Callable:
        """`(arrays, n_pad) -> result` dispatcher for `solve_fn` on this
        executor, holding its cells (go through `batch_callable`, which
        memoizes it)."""
        return _DirectDispatch(self, solve_fn)

    def dispatch(self, solve_fn: Callable, arrays: Sequence, n_pad: int,
                 key=None):
        """Run a batched solver entry point over a batch's arrays through
        the memoized dispatcher of (executor, computation key). Callers
        passing plain fresh lambdas must give a stable `key`."""
        from repro_torch import faults
        faults.maybe_raise("executor.dispatch", executor=self.name,
                           n_pad=n_pad)
        return batch_callable(self, key, solve_fn)(arrays, n_pad)

    def precompile(self, solve_fn: Callable, batches: Sequence[Sequence],
                   n_pad: int, key=None) -> bool:
        """Run the cold cells of the warm batches `batches` (each a
        stacked `(A, b, x, actions)`) ahead of traffic, through the same
        dispatcher a live `dispatch` finds (DESIGN.md §12): each cell's
        batches run under its lock as its first run, and a cell that
        has run before runs nothing. The reference takes one batch (one
        XLA executable serves every action); on the card each batch
        launches only its rows' kernel instances, so a cell takes a list.
        Returns True when the dispatcher has these cells (False: no
        dispatchable form)."""
        pre = getattr(batch_callable(self, key, solve_fn), "precompile",
                      None)
        if pre is None:          # custom executor with a plain closure
            return False
        return bool(pre(batches, n_pad))

    def device_count(self) -> int:
        raise NotImplementedError

    def mesh_shape(self) -> Optional[Dict[str, int]]:
        """Axis-name -> size of the execution mesh (None when local)."""
        return None


@dataclasses.dataclass(frozen=True)
class LocalExecutor(SolveExecutor):
    """One device, the task's: the arrays go where the entry point's
    `prepare` puts them."""

    name: str = dataclasses.field(default="local", init=False)

    def preferred_chunk(self, chunk: int, bucket: int = 0) -> int:
        return int(chunk)

    def shard(self, arrays, n_pad: int):
        return tuple(arrays)

    def device_count(self) -> int:
        return 1


# ---------------------------------------------------------------------------
# The dispatcher: its cells and their first runs (DESIGN.md §12)
# ---------------------------------------------------------------------------


def _cell_of(args) -> tuple:
    """The cell of a bound batch (module docstring): padded size,
    carrier, device, and whether it holds more than one row."""
    A = args[0]
    return (A.shape[-1], A.dtype, A.device, A.dim() == 3 and A.shape[0] > 1)


class _DirectDispatch:
    """`(arrays, n_pad) -> result` for one (executor, computation key):
    placement, then the entry point. A `LowerableCall` runs through the
    cells: a cell not run before runs under its lock as its first run,
    recorded with its seconds; afterwards it costs one dict lookup.
    Plain callables are called directly."""

    def __init__(self, executor: "SolveExecutor", solve_fn: Callable):
        self.executor = executor
        self.solve_fn = solve_fn
        self.cells: Dict[tuple, float] = {}     # cell -> first run's s
        self._locks: Dict[tuple, threading.Lock] = {}
        self._lock = threading.Lock()

    def _args(self, arrays, n_pad: int):
        return self.solve_fn.bind(self.executor.shard(arrays, n_pad))

    def _first_run(self, cell, runs):
        """Run `runs` (bound batches of one cell) as the cell's first
        run, unless another thread has run the cell meanwhile; returns
        the last batch's result, or None when nothing ran."""
        with self._lock:
            lock = self._locks.setdefault(cell, threading.Lock())
        with lock:
            if cell in self.cells:
                return None
            t0 = time.perf_counter()
            out = None
            for args in runs:
                out = self.solve_fn.run(args)
            if cell[2].type == "cuda":
                torch.cuda.synchronize(cell[2])
            seconds = time.perf_counter() - t0
            _record_compile(self.executor.name, self.solve_fn, cell,
                            runs[0][0].shape[0] if runs[0][0].dim() == 3
                            else 1, seconds)
            self.cells[cell] = seconds
            return out

    def __call__(self, arrays, n_pad: int):
        if not isinstance(self.solve_fn, LowerableCall):
            return self.solve_fn(*self.executor.shard(arrays, n_pad))
        args = self._args(arrays, n_pad)
        cell = _cell_of(args)
        if cell not in self.cells:
            out = self._first_run(cell, [args])
            if out is not None:
                return out
        return self.solve_fn.run(args)

    def precompile(self, batches, n_pad: int) -> bool:
        if not isinstance(self.solve_fn, LowerableCall):
            return False
        by_cell: Dict[tuple, list] = {}
        for arrays in batches:
            args = self._args(arrays, n_pad)
            by_cell.setdefault(_cell_of(args), []).append(args)
        for cell, runs in by_cell.items():
            if cell not in self.cells:
                self._first_run(cell, runs)
        return True


# ---------------------------------------------------------------------------
# Wrapped-callable memo
# ---------------------------------------------------------------------------

# (executor, computation key) -> dispatcher. Executors are frozen
# value-hashed dataclasses, so equal executors share dispatchers (and
# their cells); `LowerableCall`s key by value.
_WRAPPED: Dict[tuple, Callable] = {}
_WRAPPED_LOCK = threading.RLock()


def batch_callable(executor: "SolveExecutor", key,
                   solve_fn: Callable) -> Callable:
    """Memoized `executor.wrap(solve_fn)`, keyed by `computation_key`.
    The first `solve_fn` registered for (executor, key) wins. A warm
    call is one dict lookup; a miss builds the dispatcher under a lock
    (a background warmup and a live solve may race to build it) and
    counts it."""
    k = (executor, computation_key(solve_fn, key))
    wrapped = _WRAPPED.get(k)
    if wrapped is not None:
        return wrapped
    with _WRAPPED_LOCK:
        if k not in _WRAPPED:
            _WRAPPED[k] = executor.wrap(solve_fn)
            try:
                from repro_torch.obs.metrics import default_registry
                default_registry().counter(
                    "repro_executor_wrap_builds_total",
                    "Wrapped batch dispatchers built — one per "
                    "(executor, computation key).",
                    ("executor",)).labels(executor=executor.name).inc()
            except Exception:
                pass
        return _WRAPPED[k]


# ---------------------------------------------------------------------------
# Registry + selection
# ---------------------------------------------------------------------------

ExecutorLike = Union[None, str, SolveExecutor]

_REGISTRY: Dict[str, Callable[[], SolveExecutor]] = {
    "local": LocalExecutor,
}
_DEFAULT: Optional[SolveExecutor] = None


def register_executor(name: str,
                      factory: Callable[[], SolveExecutor]) -> None:
    """Register an executor factory under `name` (overwrites allowed)."""
    _REGISTRY[name] = factory


def available_executors():
    return sorted(_REGISTRY)


def _from_name(name: str) -> SolveExecutor:
    if name in _REGISTRY:
        return _REGISTRY[name]()
    if name == "sharded":
        raise NotImplementedError(
            "the sharded executor is not ported yet (ROADMAP.md Queue 1 "
            "item 7); use 'local'")
    raise ValueError(f"unknown solve executor {name!r}; "
                     f"available: {available_executors()}")


def set_default_executor(executor: ExecutorLike) -> Optional[SolveExecutor]:
    """Set the process-wide default executor (None restores the local
    executor). Returns the previous override, for save/restore."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = (resolve_executor(executor)
                if executor is not None else None)
    return prev


def default_executor() -> SolveExecutor:
    if _DEFAULT is not None:
        return _DEFAULT
    return LocalExecutor()


def resolve_executor(executor: ExecutorLike = None) -> SolveExecutor:
    """Coerce an executor spec (instance | registered name | None) into
    an executor instance."""
    if executor is None:
        return default_executor()
    if isinstance(executor, str):
        return _from_name(executor)
    return executor
