"""Crash recovery: rebuild a server's learner state from the registry
plus the trajectory-log tail (DESIGN.md §11.1; port of
`repro.service.recovery`, on the same registry and log formats, so
either package recovers from what the other wrote).

The trajectory log is the learner's write-ahead record: every completed
request appends one JSONL line carrying the WAL keys ``seq`` (the
server's completion sequence number) and ``quarantined`` (True when the
reward did NOT train the Q-table — breaker open, pinned traffic,
non-finite reward, or deadline expiry). Every registry snapshot embeds
the watermark ``meta["wal"]["seq"]`` it covers, plus the epsilon
controller's anneal state at that point.

Recovery is therefore::

    policy, version <- registry.load_last_good()   # skip corrupt snaps
    heal CURRENT if it pointed at a corrupt/torn version
    server <- AutotuneServer(registry, ...)        # loads the snapshot
    restore epsilon from meta["wal"]
    for rec in log where rec.seq > wal.seq and not rec.quarantined:
        server.learner.update(rec.state, rec.action, rec.reward,
                              explore=rec.explore)

The replayed tail goes through the *same* Q-update path the live
server used (`OnlineLearner.update` -> `QTable.update`), with the same
fixed alpha, in the same order, on the same float64 values (JSON
round-trips finite doubles exactly) — so the recovered Q/N tables are
bit-identical to what a server that never crashed would hold, which is
exactly what tests/test_torch_recovery_ope.py's kill-and-recover test
asserts.
Quarantined records are skipped because they never touched the live
table either; the epsilon controller steps only on applied updates, so
its trajectory matches too.

Optionally the tail is first *verified* through `eval.replay` — the
logged outcomes re-solved and diffed bit-identically — turning
recovery into a checked restore rather than a trusting one (callers
supply the ``request_id -> instance`` mapping replay needs).

Durability contract (what can be lost): with ``trajectory_sync="none"``
a host crash may lose the page-cache tail of the log — recovery then
restores the newest durable prefix, which is still a valid (slightly
older) learner state. ``"always"`` closes that window at the price of
an fsync per record.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from repro_torch.obs.trajlog import TrajectoryLog
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.server import AutotuneServer


@dataclasses.dataclass
class RecoveryReport:
    """What one `recover_server` call did (also mirrored, JSON-ready,
    into ``server.last_recovery`` for /healthz)."""
    version: Optional[str]        # snapshot the server restarted from
    healed_current: bool          # CURRENT re-pointed off a corrupt snap
    corrupt_versions: List[str]   # snapshots skipped as corrupt/torn
    snapshot_seq: int             # WAL watermark the snapshot covered
    log_records: int              # records seen in the trajectory log
    replayed: int                 # Q-updates re-applied from the tail
    skipped_stale: int            # seq <= snapshot watermark
    skipped_quarantined: int      # never trained the live table
    skipped_unsequenced: int      # pre-WAL records (no seq key)
    final_seq: int                # server.update_seq after recovery

    def as_meta(self) -> dict:
        return dataclasses.asdict(self)


def _count_recovery(server: AutotuneServer, outcome: str) -> None:
    """Fail-open repro_recovery_total{outcome} on the server's metrics
    registry (falling back to the process default when obs is off)."""
    try:
        if server is not None and server.obs is not None:
            reg = server.obs.registry
        else:
            from repro_torch.obs.metrics import default_registry
            reg = default_registry()
        reg.counter("repro_recovery_total",
                    "Crash-recovery attempts, by outcome.",
                    ("outcome",)).labels(outcome=outcome).inc()
    except Exception:
        pass


def replay_wal_tail(server: AutotuneServer, trajlog_path: str,
                    snapshot_seq: int,
                    task: Optional[str] = None) -> RecoveryReport:
    """Replay trajectory-log records with ``seq > snapshot_seq`` through
    the server's live learner; returns the (not yet version-stamped)
    tally. Exposed separately so tests can drive replay against a
    hand-built server."""
    replayed = stale = quarantined = unsequenced = 0
    n = 0
    max_seq = int(snapshot_seq)
    task = task if task is not None else getattr(server.task, "name", None)
    for rec in TrajectoryLog.read(trajlog_path, task=task):
        n += 1
        seq = rec.get("seq")
        if seq is None:
            # Pre-WAL record: no way to order it against the snapshot
            # watermark, so it cannot be safely re-applied.
            unsequenced += 1
            continue
        seq = int(seq)
        max_seq = max(max_seq, seq)
        if seq <= snapshot_seq:
            stale += 1
            continue
        if rec.get("quarantined", False):
            quarantined += 1
            continue
        r = float(rec["reward"])
        if not math.isfinite(r):        # belt over the quarantine flag
            quarantined += 1
            continue
        server.learner.update(int(rec["state"]), int(rec["action"]), r,
                              explore=bool(rec.get("explore", False)))
        replayed += 1
    server.update_seq = max(server.update_seq, max_seq)
    return RecoveryReport(
        version=None, healed_current=False, corrupt_versions=[],
        snapshot_seq=int(snapshot_seq), log_records=n, replayed=replayed,
        skipped_stale=stale, skipped_quarantined=quarantined,
        skipped_unsequenced=unsequenced, final_seq=server.update_seq)


def recover_server(registry: PolicyRegistry, trajlog_path: str,
                   verify_with=None, **server_kwargs) -> AutotuneServer:
    """Restart an `AutotuneServer` from what survived a crash.

    Loads the newest intact snapshot (healing CURRENT if it pointed at
    a corrupt or torn publish), builds the server on it, restores the
    epsilon controller from the snapshot's WAL meta, and replays the
    trajectory-log tail through the live Q-update path. The report
    lands in ``server.last_recovery`` (surfaced by /healthz) and
    ``repro_recovery_total{outcome}``.

    ``verify_with``: optional ``request_id -> instance`` mapping (or
    callable); when given, the tail is first re-solved through
    `eval.replay.replay_records` and recovery raises on any bit-level
    mismatch between the log and the recomputed outcomes/rewards.

    Remaining kwargs go to the `AutotuneServer` constructor.
    """
    policy, version, corrupt = registry.load_last_good()
    healed = False
    if registry.current_version() != version:
        # CURRENT pointed at a corrupt/missing snapshot (or at nothing):
        # re-promote the newest good version so this server — and any
        # naive restart after it — loads cleanly.
        registry.promote(version)
        healed = True
    try:
        meta = registry.meta(version)
    except Exception:
        meta = {}
    wal = meta.get("wal") or {}
    snapshot_seq = int(wal.get("seq", 0))

    server = AutotuneServer(registry, **server_kwargs)
    if "eps_level" in wal:
        server.learner.epsilon._level = float(wal["eps_level"])
        server.learner.epsilon._t = int(wal.get("eps_t", 0))
    server.update_seq = snapshot_seq

    try:
        if verify_with is not None:
            from repro_torch.eval.replay import assert_replay_ok, replay_records
            tail = [rec for rec in TrajectoryLog.read(
                        trajlog_path,
                        task=getattr(server.task, "name", None))
                    if rec.get("seq") is not None
                    and int(rec["seq"]) > snapshot_seq]
            if tail:
                assert_replay_ok(replay_records(server.engine, tail,
                                                verify_with))
        report = replay_wal_tail(server, trajlog_path, snapshot_seq)
    except Exception:
        _count_recovery(server, "failed")
        raise
    report.version = version
    report.healed_current = healed
    report.corrupt_versions = list(corrupt)
    server.last_recovery = report.as_meta()
    _count_recovery(server, "ok")
    return server
