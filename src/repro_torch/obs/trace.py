"""Per-request spans in a bounded ring buffer, Chrome-trace dumpable
(a copy of `repro.obs.trace`).

One solve request's lifecycle crosses several pump iterations (submit →
queue wait → flush/solve → reward → Q-update), so spans are recorded
with *explicit* timestamps from the server's injectable clock rather
than wall-clock context managers: the server knows `submitted_at`, the
batcher stamps solve start/end on each `FlushResult`, and `_complete`
emits the whole request tree at once. A `span()` context manager exists
for inline convenience instrumentation.

The buffer is a `deque(maxlen=capacity)` — a long-running server keeps
the most recent spans and never grows without bound (same policy as the
telemetry latency reservoir). `chrome_trace()` renders the standard
Chrome trace-event JSON (``chrome://tracing`` / Perfetto): complete
("ph": "X") events, microsecond timestamps, one `tid` per request id so
the viewer lays concurrent requests on separate rows.

Recording is cheap (one dataclass + deque append under a lock) and the
callers wrap it in the fail-open guard (DESIGN.md §8.1), so a broken
tracer can never break `submit()`/`step()`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Span:
    name: str                 # phase: submit / queue_wait / solve / ...
    t0: float                 # [seconds] start, in the recording clock
    t1: float                 # [seconds] end
    tid: int = 0              # request id (Chrome row)
    cat: str = "request"
    args: Optional[Dict[str, object]] = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Tracer:
    def __init__(self, capacity: int = 4096,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)

    # -- recording ---------------------------------------------------------
    def add_span(self, name: str, t0: float, t1: float, tid: int = 0,
                 cat: str = "request", **args) -> Span:
        """Record a completed span with caller-supplied timestamps."""
        span = Span(str(name), float(t0), float(t1), int(tid), str(cat),
                    dict(args) or None)
        with self._lock:
            self._spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "request", **args):
        """Inline span over a code block, timed by the tracer's clock."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.add_span(name, t0, self.clock(), tid=tid, cat=cat,
                          **args)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- reading -----------------------------------------------------------
    def spans(self, tid: Optional[int] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if tid is not None:
            out = [s for s in out if s.tid == tid]
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object ({"traceEvents": [...]})."""
        events = []
        for s in self.spans():
            ev = {"name": s.name, "cat": s.cat, "ph": "X",
                  "ts": s.t0 * 1e6, "dur": max(s.duration, 0.0) * 1e6,
                  "pid": 0, "tid": s.tid}
            if s.args:
                ev["args"] = {k: _jsonable(v) for k, v in s.args.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        """Write `chrome_trace()` to `path` (open in chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def _jsonable(v):
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
