"""Versioned policy snapshots with atomic promote / rollback (port of
`repro.service.registry`, with its on-disk format: a snapshot published
by either package loads and verifies in the other).

Layout (one directory per registry):

    <root>/versions/v0001/{qtable.npz, policy.json, meta.json}
    <root>/CURRENT        — name of the promoted version (atomic os.replace)
    <root>/HISTORY        — one promoted version name per line, append-only

`publish` writes a snapshot (QTable + Discretizer + ActionSpace via
`PrecisionPolicy.save`) without making it live; `promote` flips the CURRENT
pointer atomically so a concurrently-restarting server can never observe a
half-written policy; `rollback` re-promotes the previously live version.
`warm_start` bootstraps version 1 from an offline `train_policy` run.

Durability contract (DESIGN.md §11.1): every snapshot file is fsync'd,
`meta.json` is written *last* through an atomic tmp+rename (so a version
directory without a valid meta is an incomplete publish, never a
half-written one), and meta carries sha256 checksums of the data files.
`load` verifies checksums and raises `SnapshotCorrupted` on damage;
`load_last_good` walks CURRENT → HISTORY (newest first) past corrupt or
incomplete versions, so recovery after a crash-during-publish or disk
corruption always lands on the newest verifiable snapshot.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import List, Optional, Tuple

from repro_torch import faults
from repro_torch.core.autotune import TrainConfig, train_policy
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.rewards import RewardConfig


class SnapshotCorrupted(RuntimeError):
    """A version's files are missing, unreadable, or fail checksum."""

    def __init__(self, version: str, reason: str):
        super().__init__(f"snapshot {version}: {reason}")
        self.version = version
        self.reason = reason


#: Snapshot data files covered by the meta.json checksum manifest.
_DATA_FILES = ("qtable.npz", "policy.json")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    """Fsync a directory so a rename inside it is durable. Swallowed on
    platforms/filesystems that refuse directory fds — the rename is
    still atomic, only crash-durability of the *name* is best-effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, text: str) -> None:
    """Durable atomic file write: tmp in the target dir, flush+fsync,
    rename over, fsync the dir."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix="." + os.path.basename(path)
                               + "-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(d)


def _count(name: str, help: str) -> None:
    """Fail-open lifecycle counter against the port's process-default
    metrics registry (a PolicyRegistry predates any server's obs bundle, and
    promote/rollback are exactly the events a canary dashboard needs)."""
    try:
        from repro_torch.obs.metrics import default_registry
        default_registry().counter(name, help).inc()
    except Exception:
        pass


class PolicyRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "versions"), exist_ok=True)
        # Serializes CURRENT/HISTORY writes from one process; cross-process
        # publish races are handled by the atomic mkdir claim in publish().
        self._lock = threading.RLock()

    # -- paths -------------------------------------------------------------
    def _vdir(self, version: str) -> str:
        return os.path.join(self.root, "versions", version)

    @property
    def _current_path(self) -> str:
        return os.path.join(self.root, "CURRENT")

    @property
    def _history_path(self) -> str:
        return os.path.join(self.root, "HISTORY")

    # -- queries -----------------------------------------------------------
    def versions(self) -> List[str]:
        vdir = os.path.join(self.root, "versions")
        return sorted(v for v in os.listdir(vdir)
                      if os.path.isdir(os.path.join(vdir, v)))

    def current_version(self) -> Optional[str]:
        try:
            with open(self._current_path) as f:
                return f.read().strip() or None
        except FileNotFoundError:
            return None

    def history(self) -> List[str]:
        try:
            with open(self._history_path) as f:
                return [ln.strip() for ln in f if ln.strip()]
        except FileNotFoundError:
            return []

    def meta(self, version: str) -> dict:
        with open(os.path.join(self._vdir(version), "meta.json")) as f:
            return json.load(f)

    # -- integrity ---------------------------------------------------------
    def verify(self, version: str) -> dict:
        """Checksum-verify a version; returns its meta. Raises
        `SnapshotCorrupted` when meta is missing/unreadable (an
        incomplete publish — meta is written last) or a data file is
        missing or fails its sha256. Pre-checksum snapshots (no
        ``checksums`` key) pass on file existence alone."""
        try:
            meta = self.meta(version)
        except (FileNotFoundError, json.JSONDecodeError) as e:
            raise SnapshotCorrupted(version,
                                    f"meta.json unreadable ({e})") from e
        sums = meta.get("checksums")
        vdir = self._vdir(version)
        for fname in _DATA_FILES:
            path = os.path.join(vdir, fname)
            if not os.path.exists(path):
                raise SnapshotCorrupted(version, f"{fname} missing")
            if sums and fname in sums and _sha256(path) != sums[fname]:
                raise SnapshotCorrupted(version,
                                        f"{fname} fails sha256 checksum")
        return meta

    # -- writes ------------------------------------------------------------
    def publish(self, policy: PrecisionPolicy, note: str = "",
                extra_meta: Optional[dict] = None) -> str:
        """Write a new snapshot; returns its version name (not yet live)."""
        # Numeric max, not existing[-1]: lexicographic order breaks at
        # v10000 and would silently re-allocate (and overwrite) it forever.
        # The version directory is claimed with an atomic exclusive mkdir
        # so two publishers (threads or processes) can never allocate the
        # same name — the loser just re-reads and takes the next number.
        while True:
            existing = self.versions()
            n = 1 + max((int(v[1:]) for v in existing), default=0)
            version = f"v{n:04d}"
            vdir = self._vdir(version)
            try:
                os.makedirs(vdir)
            except FileExistsError:
                continue
            break
        faults.maybe_raise("registry.io", op="publish", version=version)
        policy.save(vdir)
        # Durability order (DESIGN.md §11.1): data files synced first,
        # then meta.json — carrying their checksums — lands atomically
        # as the commit record. A crash anywhere before the meta rename
        # leaves a version that verify()/load_last_good() skip.
        checksums = {}
        for fname in _DATA_FILES:
            fpath = os.path.join(vdir, fname)
            _fsync_file(fpath)
            checksums[fname] = _sha256(fpath)
        meta = {"version": version, "note": note, "created_at": time.time(),
                "n_states": policy.qtable.n_states,
                "n_actions": policy.qtable.n_actions,
                "visited_states": int((policy.qtable.N.sum(axis=1) > 0)
                                      .sum()),
                "checksums": checksums}
        meta.update(extra_meta or {})
        _write_atomic(os.path.join(vdir, "meta.json"),
                      json.dumps(meta, indent=1))
        _count("repro_registry_publishes_total",
               "Policy snapshots published (not yet live).")
        return version

    def promote(self, version: str) -> None:
        """Atomically flip CURRENT to `version`."""
        with self._lock:
            if version not in self.versions():
                raise ValueError(f"unknown version {version!r}")
            faults.maybe_raise("registry.io", op="promote", version=version)
            _write_atomic(self._current_path, version + "\n")
            with open(self._history_path, "a") as f:
                f.write(version + "\n")
                f.flush()
                try:
                    os.fsync(f.fileno())
                except OSError:
                    pass
        _count("repro_registry_promotes_total",
               "CURRENT-pointer flips (snapshot promotions).")

    def annotate(self, version: str, key: str, value) -> dict:
        """Atomically merge ``{key: value}`` into a version's meta.json.

        The audit hook for post-publish evidence: the OPE gate writes
        its verdict (estimates, CIs, accept/reject) into the candidate
        version here, so the registry carries the numbers every
        candidate was admitted to — or refused — a canary slice on,
        alongside the telemetry evidence `snapshot()` embeds."""
        with self._lock:
            meta = self.meta(version)
            meta[str(key)] = value
            _write_atomic(os.path.join(self._vdir(version), "meta.json"),
                          json.dumps(meta, indent=1))
        return meta

    def rollback(self) -> str:
        """Re-promote the version that was live before the current one.

        Walks back to before the current version's *first* promotion, so
        consecutive rollbacks step v3 -> v2 -> v1 instead of ping-ponging
        between the last two entries (a rollback itself appends to HISTORY).
        """
        with self._lock:
            hist = self.history()
            cur = self.current_version()
            if cur is None or cur not in hist:
                raise RuntimeError("no earlier version to roll back to")
            prior = [v for v in hist[:hist.index(cur)] if v != cur]
            if not prior:
                raise RuntimeError("no earlier version to roll back to")
            self.promote(prior[-1])
        _count("repro_registry_rollbacks_total",
               "Rollbacks to an earlier promoted version.")
        return prior[-1]

    # -- loading -----------------------------------------------------------
    def load(self, version: Optional[str] = None,
             verify: bool = True) -> PrecisionPolicy:
        version = version or self.current_version()
        if version is None:
            raise RuntimeError("registry has no promoted version")
        faults.maybe_raise("registry.io", op="load", version=version)
        if verify:
            self.verify(version)
        try:
            return PrecisionPolicy.load(self._vdir(version))
        except Exception as e:
            # Structurally unreadable despite passing (or skipping) the
            # checksum gate — e.g. a pre-checksum snapshot with a
            # truncated npz. Normalize so fallback logic has one type.
            raise SnapshotCorrupted(version, f"unreadable ({e})") from e

    def load_last_good(self) -> Tuple[PrecisionPolicy, str, List[str]]:
        """Newest loadable snapshot: CURRENT first, then promoted
        history newest-first, then any published-but-never-promoted
        versions newest-first. Returns (policy, version,
        corrupt_versions_skipped); raises RuntimeError only when no
        snapshot in the registry is loadable at all.

        The crash-recovery entry point (service.recovery): a torn
        publish or corrupted CURRENT target must fall back, not take
        the server down."""
        candidates: List[str] = []
        cur = self.current_version()
        if cur is not None:
            candidates.append(cur)
        candidates.extend(reversed(self.history()))
        candidates.extend(reversed(self.versions()))
        seen, ordered = set(), []
        for v in candidates:
            if v not in seen:
                seen.add(v)
                ordered.append(v)
        skipped: List[str] = []
        for v in ordered:
            try:
                policy = self.load(v)
            except SnapshotCorrupted:
                skipped.append(v)
                continue
            except FileNotFoundError:
                skipped.append(v)
                continue
            return policy, v, skipped
        raise RuntimeError(
            f"no loadable snapshot in registry {self.root!r} "
            f"(skipped corrupt: {skipped})")

    # -- bootstrap ---------------------------------------------------------
    @classmethod
    def warm_start(cls, root: str, task,
                   reward_cfg: RewardConfig,
                   train_cfg: TrainConfig = TrainConfig()
                   ) -> Tuple["PolicyRegistry", str, PrecisionPolicy]:
        """Offline `train_policy` run -> published + promoted version 1.

        `task` is any `TunableTask` (or an engine)."""
        reg = cls(root)
        policy, hist = train_policy(task, reward_cfg, train_cfg)
        version = reg.publish(
            policy, note="warm start (offline train_policy)",
            extra_meta={"episodes": train_cfg.episodes,
                        "final_reward": (hist.episode_reward[-1]
                                         if hist.episode_reward else None)})
        reg.promote(version)
        return reg, version, policy
