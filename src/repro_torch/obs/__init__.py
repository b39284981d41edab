"""Fail-open observability for the serving stack (port of `repro.obs`;
DESIGN.md §8).

Four pieces, all stdlib-only:

  * `obs.metrics`  — labeled Counter/Gauge/Histogram registry where
    every instrumentation call is fail-open: exceptions in metric/sink
    code are swallowed and counted in ``repro_obs_errors_total``, never
    propagated into the solve path;
  * `obs.expo`     — Prometheus text + JSON exposition and the HTTP
    front door (``/metrics``, ``/healthz``, ``/readyz``) on a stdlib
    background thread;
  * `obs.trace`    — per-request spans (submit → queue wait → solve →
    reward → Q-update) in a bounded ring buffer, dumpable as Chrome
    trace-event JSON;
  * `obs.trajlog`  — append-only JSONL trajectory log (features, state,
    action, eps, explore, reward, outcome, policy version) that makes
    off-policy evaluation from logged service streams possible.

`Observability` bundles one of each for a server:
`AutotuneServer(..., obs=Observability(trajectory_path=...))`, then
``server.serve_obs()`` to open the HTTP surface. The `Telemetry` module
stays the computation layer; exporters here only *expose* it.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.expo import (ObsHTTPServer, lint_exposition,
                                  render_json, render_prometheus)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, RATIO_BUCKETS,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry,
                                     fail_open)
from repro_torch.obs.trace import Span, Tracer
from repro_torch.obs.trajlog import TrajectoryLog


class Observability:
    """One server's observability bundle: metrics registry + tracer +
    optional trajectory log + the HTTP front door.

    ``registry=None`` joins the port's process-default registry (several
    servers share metric families, like prometheus-client's global
    REGISTRY); pass a fresh `MetricsRegistry` for isolation (tests,
    benchmarks). The HTTP front door binds 127.0.0.1 only."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 trajectory_path: Optional[str] = None,
                 trace_capacity: int = 4096,
                 trajectory_max_bytes: Optional[int] = None,
                 trajectory_max_segments: int = 3,
                 trajectory_sync: str = "none"):
        self.registry = registry if registry is not None \
            else default_registry()
        self.tracer = tracer if tracer is not None \
            else Tracer(capacity=trace_capacity)
        self.trajlog = (TrajectoryLog(
            trajectory_path, max_bytes=trajectory_max_bytes,
            max_segments=trajectory_max_segments, sync=trajectory_sync)
            if trajectory_path else None)
        self.http: Optional[ObsHTTPServer] = None

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              ready_fn=None, telemetry_fn=None,
              health_fn=None) -> ObsHTTPServer:
        """Start (or return the running) HTTP front door. ``health_fn``
        (when wired) contributes degradation state — open breakers,
        recovery metadata — to ``/healthz`` and ``/readyz``."""
        if self.http is None:
            self.http = ObsHTTPServer(
                self.registry, host=host, port=port, ready_fn=ready_fn,
                telemetry_fn=telemetry_fn,
                trace_fn=self.tracer.chrome_trace,
                health_fn=health_fn)
        return self.http

    def close(self) -> None:
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.trajlog is not None:
            self.trajlog.close()


__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "ObsHTTPServer", "Observability", "RATIO_BUCKETS", "Span",
    "Tracer", "TrajectoryLog", "default_registry", "fail_open",
    "lint_exposition", "render_json", "render_prometheus",
]
