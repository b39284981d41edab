"""Append-only JSONL trajectory log of every served decision (a copy of
`repro.obs.trajlog`: the same record schema, so the JAX package's
`eval.replay` and `eval.ope` read a log the port wrote).

One line per completed request, carrying everything off-policy
evaluation of a candidate policy needs later (ROADMAP "Beyond
ε-greedy"; Khodak et al. amortize over exactly such logged sequences of
related instances): the context features and discretized state, the
action taken, the epsilon in force and whether the epsilon coin fired
(the behavior-policy propensity is reconstructible from ``eps``,
``explore`` and the action-space size), the observed reward and outcome
metrics, and the policy version that made the decision.

The writer is line-buffered append-only — a crashed server loses at
most the final partial line, and `read()` skips partial/corrupt lines
rather than failing, so a log being written is safely readable. All
server-side writes go through the fail-open guard (DESIGN.md §8.1): a
full disk or closed file never breaks the solve path.

With ``max_bytes`` set, the log rotates: when the active file crosses
the limit it is renamed to ``<path>.1`` (older segments shift to
``.2`` … ``.N``; the oldest past ``max_segments`` is deleted) and a
fresh active file is opened. Readers span all live segments oldest
first, so rotation is invisible to `read()`/`iter_records()`. Rotation
failures are swallowed (fail-open): appends keep going to the current
file.

The ``sync`` knob sets fsync durability (DESIGN.md §11.1) — the log is
the learner's write-ahead record, so what survives a *host* crash is
what recovery can replay:

  * ``"none"``   (default) line-buffered only; a process crash loses at
    most the final partial line, a host crash may lose page-cache tail.
  * ``"rotate"`` fsync when a segment is sealed (rotation/close):
    rotated history is durable, the active segment is best-effort.
  * ``"always"`` fsync after every append: zero-loss.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Iterator, List, Optional

from repro_torch import faults

_SYNC_LEVELS = ("none", "rotate", "always")


def _jsonable(v):
    """Best-effort JSON coercion (numpy scalars -> float, else str)."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class TrajectoryLog:
    """Append-only JSONL writer + reader for served trajectories."""

    # The stable schema off-policy evaluation depends on; extra keys are
    # allowed, these are required of server-written records.
    FIELDS = ("ts", "request_id", "task", "bucket", "features", "state",
              "action", "action_names", "eps", "explore", "reward",
              "outcome", "latency_s", "policy_version", "drift")

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 max_segments: int = 3, sync: str = "none"):
        if sync not in _SYNC_LEVELS:
            raise ValueError(f"sync must be one of {_SYNC_LEVELS}, "
                             f"got {sync!r}")
        self.path = str(path)
        self.max_bytes = max_bytes
        self.max_segments = int(max_segments)
        self.sync = sync
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", buffering=1)   # line-buffered
        self.written = 0
        self.rotations = 0

    def _fsync(self) -> None:
        """Flush+fsync the active file; OSError propagates to the
        caller's fail-open guard (a full disk surfaces as one counted
        obs error, not a wedged server)."""
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def append(self, record: dict) -> None:
        faults.maybe_raise("trajlog.write", path=self.path)
        line = json.dumps(record, default=_jsonable,
                          separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self.written += 1
            if self.sync == "always":
                self._fsync()
            if (self.max_bytes is not None
                    and self._fh.tell() >= self.max_bytes):
                self._rotate()

    def _rotate(self) -> None:
        """Shift segments ``.k`` -> ``.k+1``, active -> ``.1``; open a
        fresh active file. Caller holds the lock. Never raises — a
        failed rename leaves the log appending to the current file."""
        try:
            if self.sync != "none":
                try:
                    self._fsync()       # seal the segment durably
                except OSError:
                    pass
            self._fh.close()
            for k in range(self.max_segments, 0, -1):
                src = f"{self.path}.{k}"
                if not os.path.exists(src):
                    continue
                if k == self.max_segments:
                    os.unlink(src)
                else:
                    os.replace(src, f"{self.path}.{k + 1}")
            if self.max_segments > 0:
                os.replace(self.path, f"{self.path}.1")
            self.rotations += 1
        except OSError:
            pass
        finally:
            self._fh = open(self.path, "a", buffering=1)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                if self.sync != "none":
                    try:
                        self._fsync()
                    except OSError:
                        pass
                self._fh.close()

    def __enter__(self) -> "TrajectoryLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading -----------------------------------------------------------
    @staticmethod
    def segments(path: str) -> List[str]:
        """Live segment files for `path`, oldest first (rotated ``.N`` …
        ``.1`` then the active file)."""
        out: List[str] = []
        k = 1
        while os.path.exists(f"{path}.{k}"):
            out.append(f"{path}.{k}")
            k += 1
        out.reverse()
        if os.path.exists(path):
            out.append(path)
        return out

    @staticmethod
    def iter_records(path: str) -> Iterator[dict]:
        """Yield records across all live segments (oldest first),
        skipping blank/partial trailing lines."""
        for seg in TrajectoryLog.segments(path):
            with open(seg) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue      # torn tail write of a live log

    @classmethod
    def read(cls, path: str,
             task: Optional[str] = None) -> List[dict]:
        """All records (optionally filtered to one task name)."""
        recs = list(cls.iter_records(path))
        if task is not None:
            recs = [r for r in recs if r.get("task") == task]
        return recs

    @classmethod
    def read_complete(cls, path: str, task: Optional[str] = None,
                      fields: Optional[tuple] = None) -> List[dict]:
        """Records carrying every required field (default: `FIELDS`,
        the OPE schema). Foreign rows sharing a log file — decision-
        trail events, hand-written annotations — are skipped, so the
        off-policy evaluator can consume a mixed log safely."""
        need = cls.FIELDS if fields is None else tuple(fields)
        return [r for r in cls.read(path, task=task)
                if all(f in r for f in need)]
