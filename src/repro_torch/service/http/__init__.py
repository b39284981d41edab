"""Async HTTP front door for the autotuning service (DESIGN.md §9; port
of `repro.service.http`).

Stdlib-only asyncio subsystem: request/response models with validation
(`models`), and the front door itself (`app`) — bounded per-bucket
admission with 429 backpressure, a background flush loop replacing
caller-driven `step()`, graceful drain on shutdown, and a sync facade
(`serve_http`) that runs the event loop on a daemon thread.
"""
from repro_torch.service.http.app import HttpConfig, HttpFrontDoor, serve_http
from repro_torch.service.http.models import (SolveRequest, ValidationError,
                                             parse_retry_after,
                                             result_payload, retry_delay)

__all__ = [
    "HttpConfig", "HttpFrontDoor", "SolveRequest", "ValidationError",
    "parse_retry_after", "result_payload", "retry_delay", "serve_http",
]
