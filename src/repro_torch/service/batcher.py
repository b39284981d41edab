"""Per-bucket micro-batcher for streaming solve requests, task-agnostic
(port of `repro.service.batcher`).

Requests are prepared (identity-padded to their size bucket) by the task
on submit and queued per bucket key. A bucket flushes when it holds a
full batch or when its oldest request has waited `max_wait_s` (a partial
batch). The flush target is the task executor's
`preferred_chunk(max_batch, bucket)` (DESIGN.md §7); the port's
`LocalExecutor` keeps `max_batch`. A flush reports the rows its
`solve_rows` call ran: the port's tasks solve only the live rows, where
the JAX package's pad each flush to the target.

The batcher knows nothing about any solver: all shape/batch semantics
flow through the `TunableTask` hooks (`bucket_key`, `prepare`,
`solve_rows`). Passing a solver config (`IRConfig` or `CGConfig`)
instead of a task still works — `core.task.coerce_task` wraps it,
honoring this batcher's `bucket_step`/`min_bucket`.

Single-threaded by design: `pump()` is driven by the server's event loop
(or a test), and the clock is injectable so flush-by-timeout is exactly
testable without sleeping.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.core.executor import resolve_executor
from repro_torch.core.task import Outcome, TunableTask, coerce_task


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 8          # rows per flush (flush when full;
                                # rounded up to the executor's granularity)
    max_wait_s: float = 0.05    # oldest-request deadline for partial flush
    bucket_step: int = 128      # used when adapting a solver config
    min_bucket: int = 128
    # Hard per-request deadline (None = no deadline): a request still
    # queued this long after submit is expired by `expire_overdue()`
    # instead of solved — the server answers it with a terminal FAILED
    # response (no Q-update), so a wedged or glacial bucket cannot hold
    # requests hostage (DESIGN.md §11.2).
    request_deadline_s: Optional[float] = None


@dataclasses.dataclass
class _Pending:
    req_id: int
    rows: object                # task-prepared (padded) row data
    action_row: np.ndarray
    enqueued_at: float
    bucket: int


@dataclasses.dataclass
class FlushResult:
    bucket: int
    req_ids: List[int]
    records: List[Outcome]
    n_rows: int                 # rows solved (the live rows)
    # Observability stamps (server clock): the tracer turns these into
    # per-request queue_wait / solve spans, and `solve_s` (real wall
    # seconds, independent of an injected test clock) feeds the
    # repro_service_solve_batch_seconds histogram.
    t_solve_start: float = 0.0
    t_solve_end: float = 0.0
    solve_s: float = 0.0


class MicroBatcher:
    def __init__(self, task: TunableTask,
                 cfg: BatcherConfig = BatcherConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.task = coerce_task(task, bucket_step=cfg.bucket_step,
                                min_bucket=cfg.min_bucket)
        # The task's executor sets the dispatch granularity; tasks
        # without one get the local executor.
        self.executor = resolve_executor(
            getattr(self.task, "executor", None))
        self.cfg = cfg
        self.clock = clock
        self._queues: Dict[int, List[_Pending]] = {}
        self._ids = itertools.count()

    def flush_target(self, bucket: int) -> int:
        """Rows per flush for `bucket`: `max_batch` rounded up to the
        executor's dispatch granularity."""
        return self.executor.preferred_chunk(self.cfg.max_batch, bucket)

    # -- enqueue -----------------------------------------------------------
    def submit(self, instance, action_row: np.ndarray,
               req_id: Optional[int] = None) -> Tuple[int, int]:
        """Queue one (instance, action) solve; returns (request id,
        bucket)."""
        if req_id is None:
            req_id = next(self._ids)
        bucket = self.task.bucket_key(instance)
        rows = self.task.prepare(instance)
        self._queues.setdefault(bucket, []).append(
            _Pending(req_id, rows, np.asarray(action_row, np.int32),
                     self.clock(), bucket))
        return req_id, bucket

    # -- flush -------------------------------------------------------------
    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _flush_bucket(self, bucket: int, entries: List[_Pending]
                      ) -> FlushResult:
        target = self.flush_target(bucket)
        t0, w0 = self.clock(), time.perf_counter()
        # Fault site: a raise here leaves the entries queued (pump()
        # only dequeues after a successful flush), so the flush is
        # retried by the next pump.
        faults.maybe_raise("batcher.flush", bucket=bucket,
                           n_entries=len(entries))
        records = self.task.solve_rows(
            [e.rows for e in entries], [e.action_row for e in entries],
            target)
        # Fault site: corrupt solved outcomes (NaN / divergence) after
        # the real solve — the poisoned-reward path the breaker and
        # Q-update quarantine defend against.
        records = [
            faults.corrupt_outcome("solver.outcome", rec, bucket=bucket,
                                   action_row=e.action_row)
            for e, rec in zip(entries, records)]
        return FlushResult(bucket, [e.req_id for e in entries], records,
                           len(entries), t_solve_start=t0,
                           t_solve_end=self.clock(),
                           solve_s=time.perf_counter() - w0)

    def expire_overdue(self, now: Optional[float] = None) -> List[_Pending]:
        """Remove and return every queued entry older than
        `request_deadline_s` (no-op when the deadline is unset). The
        server turns each into a terminal FAILED response."""
        if self.cfg.request_deadline_s is None:
            return []
        now = self.clock() if now is None else now
        expired: List[_Pending] = []
        for bucket in list(self._queues):
            q = self._queues[bucket]
            keep = []
            for e in q:
                if now - e.enqueued_at >= self.cfg.request_deadline_s:
                    expired.append(e)
                else:
                    keep.append(e)
            if keep:
                self._queues[bucket] = keep
            else:
                del self._queues[bucket]
        return expired

    def pump(self, force: bool = False) -> List[FlushResult]:
        """Flush every due bucket; with force=True, flush everything."""
        now = self.clock()
        out: List[FlushResult] = []
        for bucket in sorted(self._queues):
            q = self._queues[bucket]
            target = self.flush_target(bucket)
            # Full batches always go.
            while len(q) >= target:
                out.append(self._flush_bucket(bucket, q[:target]))
                del q[:target]
            # Partial batch goes on deadline (or force).
            if q and (force or
                      now - q[0].enqueued_at >= self.cfg.max_wait_s):
                out.append(self._flush_bucket(bucket, q))
                q.clear()
        self._queues = {b: q for b, q in self._queues.items() if q}
        return out

    def flush_all(self) -> List[FlushResult]:
        return self.pump(force=True)
