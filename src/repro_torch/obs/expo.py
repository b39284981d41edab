"""Metric exposition: Prometheus text format, JSON, and the HTTP front
door (`/metrics`, `/healthz`, `/readyz`) on a stdlib background thread
(a copy of `repro.obs.expo`).

This is the first externally visible surface of the serving stack
(DESIGN.md §8.3): a `ThreadingHTTPServer` bound to 127.0.0.1 only (an
ephemeral port by default), reading registry/telemetry/trace state that
the single-threaded serving loop writes (all reads go through the
registry lock). Handler exceptions answer 500 and never take the
server thread down; nothing here can propagate into the solve path.

Endpoints:

  * ``/metrics``       Prometheus text exposition 0.0.4
  * ``/metrics.json``  the same samples as JSON
  * ``/healthz``       liveness — 200 as long as the process serves HTTP;
    with a wired ``health_fn`` the body reports degradation state
    (``status: degraded``, open breakers per bucket) while staying 200 — degraded-but-serving is by design
  * ``/readyz``        readiness — 200 iff the wired `ready_fn()` is
    truthy (for `AutotuneServer`: policy snapshot loaded + bucket grid
    warm), else 503 with a JSON reason; degradation state attached the
    same way
  * ``/telemetry``     the wired telemetry snapshot as JSON (optional)
  * ``/trace``         Chrome trace-event JSON of recent spans (optional)

`lint_exposition` enforces the repo's metric name/label conventions
(``repro_`` prefix, snake_case, ``_total`` counters, ``_seconds`` time
histograms).
"""
from __future__ import annotations

import json
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from repro_torch.obs.metrics import Histogram, MetricsRegistry

SELF_METRIC = "repro_obs_errors_total"
#: Host names the front door accepts; it always binds 127.0.0.1.
LOOPBACK = ("127.0.0.1", "localhost")
SELF_HELP = "Instrumentation exceptions swallowed by the fail-open guard."


def _fmt(v: float) -> str:
    """Prometheus sample value: integers bare, floats via repr."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labelstr(labelnames, key, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(labelnames, key)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: MetricsRegistry) -> str:
    """Text exposition format 0.0.4 of every family + the self-metric."""
    lines: List[str] = []
    for fam in registry.collect():
        lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for key, child in fam.samples():
            if isinstance(fam, Histogram):
                for bound, cum in zip(
                        list(fam.bounds) + [float("inf")],
                        child.cumulative()):
                    le = _labelstr(fam.labelnames, key,
                                   extra=(("le", _fmt(bound)),))
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                ls = _labelstr(fam.labelnames, key)
                lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{ls} {child.count}")
            else:
                ls = _labelstr(fam.labelnames, key)
                lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
    lines.append(f"# HELP {SELF_METRIC} {SELF_HELP}")
    lines.append(f"# TYPE {SELF_METRIC} counter")
    lines.append(f"{SELF_METRIC} {registry.errors}")
    return "\n".join(lines) + "\n"


def render_json(registry: MetricsRegistry) -> dict:
    """The same samples as a JSON-ready dict (one entry per family)."""
    out = {}
    for fam in registry.collect():
        samples = []
        for key, child in fam.samples():
            labels = dict(zip(fam.labelnames, key))
            if isinstance(fam, Histogram):
                samples.append({"labels": labels, "sum": child.sum,
                                "count": child.count,
                                "buckets": dict(zip(
                                    (_fmt(b) for b in fam.bounds),
                                    child.cumulative()))})
            else:
                samples.append({"labels": labels, "value": child.value})
        out[fam.name] = {"type": fam.type, "help": fam.help,
                         "samples": samples}
    out[SELF_METRIC] = {"type": "counter", "help": SELF_HELP,
                        "samples": [{"labels": {},
                                     "value": registry.errors}]}
    return out


# ---------------------------------------------------------------------------
# Name/label convention lint (CI scrapes a live /metrics through this)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^repro(_[a-z0-9]+)+$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_PAIR_RE = re.compile(r'\s*(?P<k>[A-Za-z_][A-Za-z0-9_]*)='
                      r'"(?P<v>(?:[^"\\]|\\.)*)"\s*(?:,|$)')


def lint_exposition(text: str) -> List[str]:
    """Check a Prometheus exposition against the repo conventions;
    returns a list of violations (empty = clean)."""
    problems: List[str] = []
    types = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(None, 3)
            types[name] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"unparseable sample line: {line!r}")
            continue
        name = m.group("name")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        family = base if base in types else name
        if not _NAME_RE.match(family):
            problems.append(
                f"{family}: name must be snake_case with 'repro_' prefix")
        mtype = types.get(family)
        if mtype == "counter" and not family.endswith("_total"):
            problems.append(f"{family}: counters must end in '_total'")
        if (mtype == "histogram"
                and ("second" in family or "latency" in family
                     or "duration" in family or "wait" in family)
                and not family.endswith("_seconds")):
            problems.append(
                f"{family}: time histograms must end in '_seconds'")
        for pm in _PAIR_RE.finditer(m.group("labels") or ""):
            label = pm.group("k")
            if label == "le":
                continue
            if not _LABEL_RE.match(label) or label != label.lower():
                problems.append(
                    f"{family}: label {label!r} must be snake_case")
    return problems


# ---------------------------------------------------------------------------
# HTTP front door
# ---------------------------------------------------------------------------

class ObsHTTPServer:
    """Background-thread HTTP server exposing observability state.

    Read-only and fail-open by construction: handlers only read, a
    raising handler answers 500 (and counts in the self-metric), and
    the daemon thread dies with the process. It binds 127.0.0.1 only
    (another `host` raises `ValueError`); `port=0` binds an ephemeral
    port — read `.port`/`.url` after construction.
    """

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0,
                 ready_fn: Optional[Callable[[], object]] = None,
                 telemetry_fn: Optional[Callable[[], dict]] = None,
                 trace_fn: Optional[Callable[[], dict]] = None,
                 health_fn: Optional[Callable[[], dict]] = None):
        if host not in LOOPBACK:
            raise ValueError(f"the observability server binds 127.0.0.1 "
                             f"only, not {host!r}")
        self.registry = registry
        self.ready_fn = ready_fn
        self.telemetry_fn = telemetry_fn
        self.trace_fn = trace_fn
        self.health_fn = health_fn
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # no stderr spam per scrape
                pass

            def do_GET(self):
                try:
                    obs._route(self)
                except BrokenPipeError:
                    pass
                except Exception:
                    obs.registry.count_error()
                    try:
                        self.send_error(500)
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-obs-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # -- routing -----------------------------------------------------------
    def _route(self, handler: BaseHTTPRequestHandler) -> None:
        path = handler.path.split("?", 1)[0]
        scrapes = self.registry.counter(
            "repro_obs_scrapes_total",
            "HTTP requests served by the observability front door.",
            ("path",))
        if path == "/metrics":
            scrapes.labels(path=path).inc()
            self._respond(handler, 200, render_prometheus(self.registry),
                          "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/metrics.json":
            scrapes.labels(path=path).inc()
            self._respond_json(handler, 200, render_json(self.registry))
        elif path == "/healthz":
            scrapes.labels(path=path).inc()
            # Liveness stays 200 while degraded — a breaker pinning to
            # the safe arm is the process *working as designed*, and
            # restarting it would only lose learner state. The payload
            # carries the degradation detail for operators/alerting.
            payload = {"status": "ok"}
            if self.health_fn is not None:
                state = dict(self.health_fn())
                if state.pop("degraded", False):
                    payload["status"] = "degraded"
                payload.update(state)
            self._respond_json(handler, 200, payload)
        elif path == "/readyz":
            scrapes.labels(path=path).inc()
            ready = bool(self.ready_fn()) if self.ready_fn else True
            payload = {"status": "ready" if ready else "unready"}
            if self.health_fn is not None:
                state = dict(self.health_fn())
                if state.pop("degraded", False):
                    payload["status"] = "degraded"
                payload.update(state)
            self._respond_json(handler, 200 if ready else 503, payload)
        elif path == "/telemetry" and self.telemetry_fn is not None:
            scrapes.labels(path=path).inc()
            self._respond_json(handler, 200, self.telemetry_fn())
        elif path == "/trace" and self.trace_fn is not None:
            scrapes.labels(path=path).inc()
            self._respond_json(handler, 200, self.trace_fn())
        else:
            self._respond_json(handler, 404, {"error": "not found",
                                              "path": path})

    @staticmethod
    def _respond(handler, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    @classmethod
    def _respond_json(cls, handler, code: int, obj) -> None:
        cls._respond(handler, code, json.dumps(obj, default=float),
                     "application/json")
