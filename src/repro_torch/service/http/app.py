"""Async HTTP front door over `AutotuneServer` / `ShadowServer` (port of
`repro.service.http.app`).

Stdlib-only (asyncio + a hand-rolled HTTP/1.1 exchange, like `obs/`
uses http.server): the request path of the production front door
(DESIGN.md §9). Endpoints:

  * ``POST /v1/solve``       validate → admit → 202 with the request id
    (fire-and-poll); the client's optional ``request_id`` is echoed.
  * ``GET  /v1/result/<id>`` 200 + full result exactly once (retrieval
    evicts), 202 while pending, 404 for unknown/already-claimed ids.
  * ``POST /v1/solve:sync``  admit, then await completion inline; 504
    on timeout (the result stays retrievable via ``/v1/result``).
  * ``GET  /v1/policy``      registry versions/current/history, the live
    policy version, and rollout-controller state when fronting a
    `ShadowServer`.

Concurrency model — three rules, no locks:

  1. The serving stack stays single-threaded by design: every
     `submit()`/`step()`/`drain()` call runs on ONE worker thread (a
     single-slot ThreadPoolExecutor). The front door forces
     ``server.auto_step = False`` and replaces caller-driven stepping
     with a background flush loop that pumps the micro-batcher on that
     worker.
  2. All admission/bookkeeping state (per-bucket depth, pending map,
     done store) lives on the event loop thread; completions cross back
     via ``loop.call_soon_threadsafe``.
  3. Backpressure is explicit: a request whose size bucket already has
     ``max_queue_depth`` admitted-but-unanswered requests is refused
     with 429 + ``Retry-After`` *before* any O(n^3) feature work, so an
     overload burst costs validation only. Shutdown drains: the
     listener closes first, admitted requests are force-flushed and
     answered, then the loop stops.

Every solve therefore runs on the worker thread, on the task's device
(CUDA unless the task was built with ``device="cpu"``).

One deviation from the JAX package's drain order (ROADMAP.md Queue 3):
since CPython 3.12.1 ``asyncio.Server.wait_closed()`` waits until every
open connection has dropped, so awaiting it before the drain loop, as
the reference does, holds shutdown until a waiting sync caller's own
``sync_timeout_s`` runs out, and that caller sees 504 instead of the
terminal failure. Here the listener closes first, the drain deadline
runs and fails what is still pending (the sync caller gets its 503 at
once), idle keep-alive connections are closed, and only then are the
connections waited for, at most ``drain_timeout_s`` more.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from repro_torch import faults
from repro_torch.core.task import bucket_of
from repro_torch.service.http.models import (SolveRequest, ValidationError,
                                             accepted_payload,
                                             result_payload)

_SERVER_NAME = "repro-autotune"


@dataclasses.dataclass(frozen=True)
class HttpConfig:
    max_queue_depth: int = 64     # per-bucket admitted-but-unanswered cap
    retry_after_s: float = 1.0    # advertised backoff on 429
    flush_interval_s: float = 0.005   # background flush-loop tick
    sync_timeout_s: float = 30.0  # /v1/solve:sync wait bound
    max_body_bytes: int = 64 << 20
    max_n: int = 2048             # request validation size cap
    drain_timeout_s: float = 10.0
    conn_idle_s: float = 30.0     # keep-alive idle timeout
    max_done: int = 4096          # unclaimed-result retention (front door)


@dataclasses.dataclass
class _PendingEntry:
    bucket: int
    client_id: Optional[str]
    has_x_true: bool
    future: Optional[asyncio.Future] = None   # set for /v1/solve:sync


def _json_default(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class HttpFrontDoor:
    """Async HTTP API over one server (AutotuneServer or ShadowServer)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 cfg: HttpConfig = HttpConfig()):
        self.server = server
        self.cfg = cfg
        self._req_host, self._req_port = host, port
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        # Rule 1: one worker thread owns every server call.
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-http-worker")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._asyncio_server: Optional[asyncio.AbstractServer] = None
        self._flush_task: Optional[asyncio.Task] = None
        self._draining = False
        self._depth: Dict[int, int] = {}
        self._pending: Dict[int, _PendingEntry] = {}
        self._early: Dict[int, object] = {}       # completed pre-register
        self._done: "OrderedDict[int, dict]" = OrderedDict()
        # Open connections, each True while it handles a request.
        self._conns: Dict[asyncio.StreamWriter, bool] = {}
        self.results_evicted = 0
        self.flush_restarts = 0
        server.auto_step = False    # the flush loop is the only pump
        server.on_response = self._on_response_worker

    # -- lifecycle (async API) ----------------------------------------------
    async def astart(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._asyncio_server = await asyncio.start_server(
            self._handle_conn, self._req_host, self._req_port)
        sock = self._asyncio_server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        self._flush_task = asyncio.ensure_future(self._flush_loop())

    async def aclose(self) -> None:
        """Graceful drain: stop accepting, flush and answer everything
        admitted; whatever is still unanswered at ``drain_timeout_s``
        gets a *terminal failure* response (sync callers see it
        immediately, fire-and-poll callers via GET /v1/result) — no
        request is left hanging forever, even when a drain call blocks
        rather than fails. Open connections are waited for
        only after that (module docstring), at most ``drain_timeout_s``;
        idle ones are closed first, and any left then are aborted."""
        self._draining = True
        if self._asyncio_server is not None:
            self._asyncio_server.close()        # stop accepting
        deadline = self._loop.time() + self.cfg.drain_timeout_s
        while self._pending:
            left = deadline - self._loop.time()
            if left <= 0:
                break
            # The deadline bounds each drain call too: a drain that
            # blocks is left running on the worker, and what it has not
            # answered by then fails below.
            call = self._loop.run_in_executor(self._exec, self.server.drain)
            try:
                await asyncio.wait_for(call, left)
            except asyncio.TimeoutError:
                break
            except Exception:
                self._count_error()
            await asyncio.sleep(0.005)
        if self._flush_task is not None:
            self._flush_task.cancel()
            try:
                await self._flush_task
            except asyncio.CancelledError:
                pass
        for rid, entry in list(self._pending.items()):
            self._fail_pending(rid, entry,
                               "server shut down before this request "
                               "was solved")
        await self._close_connections()
        self._exec.shutdown(wait=False)

    async def _close_connections(self) -> None:
        """Close the idle connections, let the busy ones send their
        answer (each closes after it while draining), and wait for all
        of them to drop, at most ``drain_timeout_s``; abort the rest."""
        if self._asyncio_server is None:
            return
        for writer, busy in list(self._conns.items()):
            if not busy:
                writer.close()
        try:
            await asyncio.wait_for(self._asyncio_server.wait_closed(),
                                   self.cfg.drain_timeout_s)
        except asyncio.TimeoutError:
            for writer in list(self._conns):
                writer.transport.abort()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- lifecycle (sync facade, mirrors ObsHTTPServer ergonomics) ----------
    def start(self) -> "HttpFrontDoor":
        loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=loop.run_forever,
                                        name="repro-http", daemon=True)
        self._loop = loop
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self.astart(), loop).result(30)
        return self

    def close(self) -> None:
        if self._loop is None or self._thread is None:
            return
        asyncio.run_coroutine_threadsafe(self.aclose(), self._loop).result(
            2 * self.cfg.drain_timeout_s + 30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._loop.close()
        self._loop = self._thread = None

    # -- completion path -----------------------------------------------------
    def _on_response_worker(self, resp) -> None:
        """Runs on the worker thread inside step(); claims the response
        off the server's retention store and hands it to the loop."""
        if resp.request_id < 0:
            return                   # shadow arm, never client-visible
        self.server.poll(resp.request_id)
        try:
            self._loop.call_soon_threadsafe(self._deliver, resp)
        except RuntimeError:
            pass                     # loop already closed (shutdown race)

    def _deliver(self, resp) -> None:
        rid = resp.request_id
        entry = self._pending.get(rid)
        if entry is None:
            # Completed before the submitting coroutine registered it;
            # finish when registration happens.
            self._early[rid] = resp
            return
        self._finish(rid, entry, resp)

    def _finish(self, rid: int, entry: _PendingEntry, resp) -> None:
        del self._pending[rid]
        self._depth[entry.bucket] = \
            max(self._depth.get(entry.bucket, 1) - 1, 0)
        payload = result_payload(resp, client_id=entry.client_id,
                                 has_x_true=entry.has_x_true)
        if entry.future is not None and not entry.future.done():
            entry.future.set_result(payload)
            return
        self._done[rid] = payload
        while len(self._done) > self.cfg.max_done:
            self._done.popitem(last=False)
            self.results_evicted += 1

    def _fail_pending(self, rid: int, entry: _PendingEntry,
                      reason: str) -> None:
        """Answer one admitted-but-unsolved request with a terminal
        failure payload (drain deadline expiry)."""
        del self._pending[rid]
        self._depth[entry.bucket] = \
            max(self._depth.get(entry.bucket, 1) - 1, 0)
        payload = {"request_id": rid, "status": "failed", "error": reason}
        if entry.client_id is not None:
            payload["client_request_id"] = entry.client_id
        if entry.future is not None and not entry.future.done():
            entry.future.set_result(payload)
            return
        self._done[rid] = payload
        while len(self._done) > self.cfg.max_done:
            self._done.popitem(last=False)
            self.results_evicted += 1

    def _register(self, rid: int, entry: _PendingEntry) -> None:
        self._pending[rid] = entry
        resp = self._early.pop(rid, None)
        if resp is not None:
            self._finish(rid, entry, resp)

    # -- flush loop ----------------------------------------------------------
    async def _flush_loop(self) -> None:
        """Supervisor: restart the pump whenever it crashes
        (DESIGN.md §11). A fault inside step() — an injected
        ``batcher.flush`` raise, a transient solver error — kills one
        pump iteration, not the front door: the batcher only dequeues
        entries after a successful flush, so the restarted pump retries
        them. Restarts are counted in
        ``repro_http_flush_restarts_total``."""
        while True:
            try:
                await self._flush_loop_inner()
            except asyncio.CancelledError:
                raise
            except Exception:
                self._count_error()
                self._count_flush_restart()
                if self._draining:
                    return
                await asyncio.sleep(self.cfg.flush_interval_s)

    async def _flush_loop_inner(self) -> None:
        while True:
            if self.server.pending:
                await self._loop.run_in_executor(
                    self._exec, self.server.step)
            await asyncio.sleep(self.cfg.flush_interval_s)

    # -- HTTP plumbing ---------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._conns[writer] = False
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        timeout=self.cfg.conn_idle_s)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                        ConnectionResetError):
                    return
                except asyncio.LimitOverrunError:
                    await self._send(writer, 431,
                                     {"error": "headers too large"})
                    return
                self._conns[writer] = True
                try:
                    method, path, headers = self._parse_head(head)
                except ValueError:
                    await self._send(writer, 400,
                                     {"error": "malformed request"})
                    return
                clen = int(headers.get("content-length", "0") or "0")
                if clen > self.cfg.max_body_bytes:
                    await self._send(writer, 413,
                                     {"error": "body too large"})
                    return
                body = await reader.readexactly(clen) if clen else b""
                code, payload, extra = await self._dispatch(method, path,
                                                            body)
                keep = (headers.get("connection", "keep-alive").lower()
                        != "close" and not self._draining)
                await self._send(writer, code, payload, extra,
                                 keep_alive=keep)
                if not keep:
                    return
                self._conns[writer] = False
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:
            self._count_error()
        finally:
            self._conns.pop(writer, None)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    @staticmethod
    def _parse_head(head: bytes):
        lines = head.decode("latin-1").split("\r\n")
        method, path, proto = lines[0].split(" ", 2)
        if not proto.startswith("HTTP/1."):
            raise ValueError(proto)
        headers = {}
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        return method.upper(), path.split("?", 1)[0], headers

    async def _send(self, writer, code: int, payload: dict,
                    extra_headers=(), keep_alive: bool = False) -> None:
        reasons = {200: "OK", 202: "Accepted", 400: "Bad Request",
                   404: "Not Found", 405: "Method Not Allowed",
                   413: "Payload Too Large", 429: "Too Many Requests",
                   431: "Request Header Fields Too Large",
                   500: "Internal Server Error",
                   503: "Service Unavailable", 504: "Gateway Timeout"}
        body = json.dumps(payload, default=_json_default).encode("utf-8")
        lines = [f"HTTP/1.1 {code} {reasons.get(code, 'Unknown')}",
                 f"Server: {_SERVER_NAME}",
                 "Content-Type: application/json",
                 f"Content-Length: {len(body)}",
                 "Connection: " + ("keep-alive" if keep_alive
                                   else "close")]
        lines += [f"{k}: {v}" for k, v in extra_headers]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                     + body)
        await writer.drain()

    # -- routing ---------------------------------------------------------------
    async def _dispatch(self, method: str, path: str, body: bytes):
        try:
            # Fault site: an injected raise here surfaces as a clean
            # 500 (below) and an injected delay as a slow response —
            # the chaos suite drives client-visible failure modes
            # through the same handler the real ones would take.
            faults.maybe_raise("http.request", method=method, path=path)
            if path in ("/v1/solve", "/v1/solve:sync"):
                if method != "POST":
                    return 405, {"error": "POST required"}, ()
                return await self._solve(body, sync=path.endswith(":sync"))
            if path.startswith("/v1/result/"):
                if method != "GET":
                    return 405, {"error": "GET required"}, ()
                return self._result(path[len("/v1/result/"):])
            if path == "/v1/policy":
                if method != "GET":
                    return 405, {"error": "GET required"}, ()
                return self._policy()
            return 404, {"error": "not found", "path": path}, ()
        except ValidationError as e:
            self._count_request(path, 400)
            return 400, {"error": str(e)}, ()
        except Exception:
            self._count_error()
            self._count_request(path, 500)
            return 500, {"error": "internal error"}, ()

    async def _solve(self, body: bytes, sync: bool):
        route = "/v1/solve:sync" if sync else "/v1/solve"
        if self._draining:
            self._count_request(route, 503)
            return 503, {"error": "server is draining"}, ()
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ValidationError("body must be valid JSON")
        sreq = SolveRequest.from_payload(payload, max_n=self.cfg.max_n)
        bucket = self._bucket_for(sreq.n)
        # Rule 3: shed load before the O(n^3) feature work.
        if self._depth.get(bucket, 0) >= self.cfg.max_queue_depth:
            self._count_request(route, 429)
            retry = max(1, int(-(-self.cfg.retry_after_s // 1)))
            return (429,
                    {"error": "bucket queue full", "bucket": bucket,
                     "retry_after_s": self.cfg.retry_after_s},
                    (("Retry-After", str(retry)),))
        self._depth[bucket] = self._depth.get(bucket, 0) + 1
        try:
            rid = await self._loop.run_in_executor(
                self._exec, self._build_and_submit, sreq)
        except BaseException:
            self._depth[bucket] = max(self._depth.get(bucket, 1) - 1, 0)
            raise
        entry = _PendingEntry(bucket=bucket,
                              client_id=sreq.client_request_id,
                              has_x_true=sreq.x_true is not None)
        extra = ()
        if sreq.client_request_id is not None:
            extra = (("X-Request-Id", sreq.client_request_id),)
        if not sync:
            self._register(rid, entry)
            self._count_request(route, 202)
            return (202, accepted_payload(rid, bucket,
                                          sreq.client_request_id), extra)
        entry.future = self._loop.create_future()
        self._register(rid, entry)
        try:
            result = await asyncio.wait_for(entry.future,
                                            self.cfg.sync_timeout_s)
        except asyncio.TimeoutError:
            # Detach: the result lands in the done-store when it arrives
            # and stays retrievable via GET /v1/result/<id>.
            entry.future = None
            self._count_request(route, 504)
            return (504, {"error": "solve timed out", "request_id": rid,
                          "status": "pending"}, extra)
        if result.get("status") == "failed":
            # Terminal failure from the drain deadline: the request was
            # admitted but the server shut down before solving it.
            self._count_request(route, 503)
            return 503, result, extra
        self._count_request(route, 200)
        return 200, result, extra

    def _build_and_submit(self, sreq: SolveRequest) -> int:
        return self.server.submit(sreq.to_instance())

    def _result(self, raw_id: str):
        route = "/v1/result"
        try:
            rid = int(raw_id)
        except ValueError:
            self._count_request(route, 400)
            return 400, {"error": f"bad request id {raw_id!r}"}, ()
        payload = self._done.pop(rid, None)
        if payload is not None:
            self._count_request(route, 200)
            return 200, payload, ()
        if rid in self._pending:
            self._count_request(route, 202)
            return 202, {"request_id": rid, "status": "pending"}, ()
        self._count_request(route, 404)
        return 404, {"error": "unknown or already-claimed request id",
                     "request_id": rid}, ()

    def _policy(self):
        reg = getattr(self.server, "registry", None)
        out = {"policy_version": self.server.policy_version,
               "current": reg.current_version() if reg else None,
               "versions": reg.versions() if reg else [],
               "history": reg.history() if reg else []}
        state_fn = getattr(self.server, "rollout_state", None)
        if state_fn is not None:
            out["rollout"] = state_fn()
        self._count_request("/v1/policy", 200)
        return 200, out, ()

    # -- helpers ----------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        task = self.server.task
        step = getattr(task, "bucket_step", 128)
        minimum = getattr(task, "min_bucket", step)
        return bucket_of(n, step, minimum)

    def queue_depth(self, bucket: int) -> int:
        return self._depth.get(bucket, 0)

    def _registry(self):
        obs = getattr(self.server, "obs", None)
        if obs is not None:
            return obs.registry
        from repro_torch.obs.metrics import default_registry
        return default_registry()

    def _count_request(self, route: str, code: int) -> None:
        try:
            self._registry().counter(
                "repro_http_requests_total",
                "HTTP front-door requests, by route and status code.",
                ("route", "code")).labels(route=route,
                                          code=str(code)).inc()
        except Exception:
            pass

    def _count_error(self) -> None:
        try:
            self._registry().count_error()
        except Exception:
            pass

    def _count_flush_restart(self) -> None:
        self.flush_restarts += 1
        try:
            self._registry().counter(
                "repro_http_flush_restarts_total",
                "Background flush-loop crashes survived by the "
                "supervisor (the pump was restarted).").inc()
        except Exception:
            pass


def serve_http(server, host: str = "127.0.0.1", port: int = 0,
               cfg: HttpConfig = HttpConfig()) -> HttpFrontDoor:
    """Start the front door on a background event-loop thread; returns
    the running `HttpFrontDoor` (read ``.url``, call ``.close()``)."""
    return HttpFrontDoor(server, host=host, port=port, cfg=cfg).start()
