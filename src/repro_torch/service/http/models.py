"""Request/response models for the async HTTP front door (a copy of
`repro.service.http.models`, stdlib plus numpy, on the port's features,
systems and responses).

Wire format (JSON over HTTP/1.1):

  POST /v1/solve, /v1/solve:sync  —  body::

      {"A": [[...], ...],        # (n, n) matrix, finite floats
       "b": [...],               # length-n right-hand side
       "x_true": [...],          # optional reference solution: without it
                                 # the solve still runs, but ferr-based
                                 # reward/convergence is meaningless and
                                 # the response carries has_x_true=false
       "request_id": "..."}      # optional client id, echoed back

Validation is strict and cheap (shape, finiteness, size cap) and runs
before admission control; the expensive part — the Hager–Higham
condition estimate inside `system_features` — runs on the worker thread
after the request is admitted, so an overload burst is shed before any
O(n^3) work.

Responses carry the full `SolveResponse` surface: the action (per-step
precision formats), reward, outcome metrics, the policy version that
decided, and the server-measured submit-to-response latency.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from repro_torch.core.features import system_features
from repro_torch.data.matrices import LinearSystem
from repro_torch.service.server import SolveResponse


class ValidationError(ValueError):
    """Bad request payload; maps to HTTP 400."""

    def __init__(self, message: str):
        super().__init__(message)
        self.status = 400


def _as_float_array(obj, name: str, ndim: int) -> np.ndarray:
    try:
        arr = np.asarray(obj, dtype=np.float64)
    except (TypeError, ValueError):
        raise ValidationError(f"{name!r} must be a numeric array")
    if arr.ndim != ndim:
        raise ValidationError(f"{name!r} must be {ndim}-dimensional, "
                              f"got shape {arr.shape}")
    if arr.size == 0:
        raise ValidationError(f"{name!r} must be non-empty")
    if not np.all(np.isfinite(arr)):
        raise ValidationError(f"{name!r} must contain only finite values")
    return arr


@dataclasses.dataclass
class SolveRequest:
    """Validated solve request; `to_instance()` builds the task instance
    (features computed there — keep it off the event loop)."""

    A: np.ndarray
    b: np.ndarray
    x_true: Optional[np.ndarray]
    client_request_id: Optional[str]

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @classmethod
    def from_payload(cls, payload, max_n: int) -> "SolveRequest":
        if not isinstance(payload, dict):
            raise ValidationError("request body must be a JSON object")
        unknown = set(payload) - {"A", "b", "x_true", "request_id"}
        if unknown:
            raise ValidationError(
                f"unknown fields: {sorted(unknown)}")
        if "A" not in payload or "b" not in payload:
            raise ValidationError("fields 'A' and 'b' are required")
        A = _as_float_array(payload["A"], "A", ndim=2)
        if A.shape[0] != A.shape[1]:
            raise ValidationError(f"'A' must be square, got {A.shape}")
        n = A.shape[0]
        if n > max_n:
            raise ValidationError(f"system size {n} exceeds the "
                                  f"server limit of {max_n}")
        b = _as_float_array(payload["b"], "b", ndim=1)
        if b.shape[0] != n:
            raise ValidationError(
                f"'b' length {b.shape[0]} does not match A ({n}x{n})")
        x_true = None
        if payload.get("x_true") is not None:
            x_true = _as_float_array(payload["x_true"], "x_true", ndim=1)
            if x_true.shape[0] != n:
                raise ValidationError(
                    f"'x_true' length {x_true.shape[0]} does not match "
                    f"A ({n}x{n})")
        cid = payload.get("request_id")
        if cid is not None and not isinstance(cid, str):
            raise ValidationError("'request_id' must be a string")
        if cid is not None and len(cid) > 256:
            raise ValidationError("'request_id' exceeds 256 characters")
        return cls(A=A, b=b, x_true=x_true, client_request_id=cid)

    def to_instance(self) -> LinearSystem:
        """Build the `LinearSystem` the task consumes. O(n^3): the
        Hager–Higham condest LU-factorizes A."""
        feats = system_features(self.A)
        x = self.x_true if self.x_true is not None \
            else np.zeros(self.n, dtype=np.float64)
        return LinearSystem(self.A, self.b, x, feats["kappa_est"],
                            feats, "dense")


def accepted_payload(req_id: int, bucket: int,
                     client_id: Optional[str]) -> dict:
    out = {"request_id": req_id, "bucket": bucket, "status": "queued"}
    if client_id is not None:
        out["client_request_id"] = client_id
    return out


def result_payload(resp: SolveResponse, client_id: Optional[str] = None,
                   has_x_true: bool = True) -> dict:
    """JSON-ready view of a completed `SolveResponse`."""
    rec = resp.record
    out = {
        "request_id": resp.request_id,
        # "expired" marks a request whose batcher deadline passed before
        # a solve ran (terminal: the outcome is a synthetic FAILED).
        "status": "expired" if resp.expired else "done",
        "bucket": int(resp.bucket),
        "action": int(resp.action),
        "action_names": list(resp.action_names),
        "reward": float(resp.reward),
        "state": int(resp.state),
        "eps": float(resp.eps),
        "policy_version": resp.policy_version,
        "latency_s": float(resp.latency_s),
        "drift": bool(resp.drift),
        "has_x_true": bool(has_x_true),
        "outcome": {"status": int(rec.status),
                    "cost": float(rec.cost),
                    **{k: (float(v) if np.isscalar(v) else v)
                       for k, v in rec.metrics.items()}},
    }
    if client_id is not None:
        out["client_request_id"] = client_id
    return out


# ---------------------------------------------------------------------------
# Client-side backoff (the polite half of the 429 + Retry-After contract)
# ---------------------------------------------------------------------------

def parse_retry_after(value) -> Optional[float]:
    """Seconds from a ``Retry-After`` header value (delta-seconds form
    only — the HTTP-date form is not worth a date parser here); None
    when absent/unparseable."""
    if value is None:
        return None
    try:
        return max(float(str(value).strip()), 0.0)
    except ValueError:
        return None


def retry_delay(attempt: int, retry_after=None, *, base_s: float = 0.1,
                cap_s: float = 30.0, jitter: float = 0.5,
                rng=None) -> float:
    """Jittered exponential backoff honoring ``Retry-After`` as a floor.

    ``base_s * 2**attempt`` capped at ``cap_s``, stretched by a uniform
    factor in ``[1, 1 + jitter]`` (simultaneous client retries are the
    thundering herd the jitter breaks), and never below what the server
    asked for via ``Retry-After`` (raw header values are accepted —
    `parse_retry_after` is applied). ``rng`` is any object with
    ``random()`` (e.g. ``random.Random(seed)``) for deterministic
    tests; default is the module-level `random`.
    """
    if rng is None:
        rng = random
    delay = min(float(base_s) * (2.0 ** max(int(attempt), 0)),
                float(cap_s))
    delay *= 1.0 + max(float(jitter), 0.0) * rng.random()
    floor = retry_after if isinstance(retry_after, (int, float)) \
        else parse_retry_after(retry_after)
    if floor is not None:
        delay = max(delay, float(floor))
    return delay
