"""Asyncio router data path (port of ome_tpu/router/aserver.py).

The threaded router (server.py) carries one OS thread per in-flight
SSE stream — ~8 MiB of stack per slow reader, and a hard ceiling in
the low thousands of concurrent streams per process. This server
keeps the ENTIRE policy surface of the threaded one — breaker and
draining state machine, cache_aware + fleet prefix directory, class
headers, traceparent spans, the guarded /backends admin API,
/metrics — but proxies on a single event loop: tens of thousands of
concurrent streams are tens of thousands of coroutines, not threads.

Data-path rules (docs/router-ha.md):

  * per-stream buffers are BOUNDED (an asyncio.Queue of
    --stream-buffer chunks between the upstream reader and the
    client writer). A slow client fills its own queue, at which point
    that ONE stream's upstream read pauses (TCP backpressure to the
    engine) — it never stalls the loop or any other stream, and
    memory per stream stays bounded;
  * a client disconnect cancels the upstream fetch: the connection
    watcher sees EOF on the client socket and cancels the proxy task,
    which closes the upstream connection on its way out (the engine
    sees the close and stops generating);
  * all blocking I/O stays on threads — the health loop and the
    gossip pull loop (gossip.py) run exactly as before. The event
    loop talks to the Router/Backend/PrefixDirectory policy objects
    (reused unchanged from server.py) directly: their critical
    sections are leaf threading.Locks held for microseconds, never
    across I/O, which is the explicit thread<->event-loop boundary —
    cheap enough to take on the loop, and the only shared state.

Fault injection uses faults.afire (asyncio.sleep for slow rules): a
time.sleep here would stall every stream on the loop, not just the
faulted one — exactly what omelint's blocking-in-async rule rejects.

Multi-replica: N of these processes front the same engine pool; they
share breaker/draining observations and the prefix directory via
gossip.py anti-entropy (--gossip-peer), serving snapshots at
/gossip/state. Losing a replica loses its connections, never
correctness (journal durability lives in the engines).
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import logging
import os
import random
import threading
import time
import urllib.parse
from typing import Dict, Optional, Tuple

from ..priority import DEFAULT_PRIORITY, PRIORITY_CLASSES, coerce_priority
from ..telemetry import tracing
from ..telemetry.reqlog import coerce as _coerce_reqlog
from .gossip import GossipAgent, GossipState
from .server import (Backend, RetryBudget, Router, _BackendDraining,
                     _ClientGone, _ResponseStarted, _parse_selector,
                     affinity_from_payload, discover_backends,
                     prefix_digest)

log = logging.getLogger("ome.router.async")


class _UpstreamError(Exception):
    """Retryable transport failure talking to a backend (the asyncio
    analogue of urllib.error.URLError in the threaded path)."""


class _Headers(dict):
    """Case-insensitive header view: keys are stored lowercased, and
    get() lowercases its argument — the one behavior the shared
    helpers (tracing.from_headers, priority coercion) rely on from
    http.server's message object."""

    def get(self, key, default=None):
        return dict.get(self, key.lower(), default)


async def _bounded(coro, deadline_mono: Optional[float]):
    """Await `coro` within the remaining budget of an absolute
    monotonic deadline (None = unbounded)."""
    if deadline_mono is None:
        return await coro
    remaining = deadline_mono - time.monotonic()
    if remaining <= 0:
        raise asyncio.TimeoutError("upstream deadline exceeded")
    return await asyncio.wait_for(coro, timeout=remaining)


class AsyncRouterServer:
    """Single-event-loop router front end over the threaded policy
    core. Constructor surface mirrors RouterServer, plus gossip and
    the stream-buffer bound."""

    def __init__(self, router: Router, host: str = "0.0.0.0",
                 port: int = 0, retries: int = 2,
                 retry_backoff: float = 0.05,
                 retry_budget_ratio: float = 0.2,
                 request_log=None, span_log=None,
                 debug_endpoints: bool = False,
                 gossip: Optional[GossipState] = None,
                 stream_buffer: int = 64):
        self.router = router
        self.host = host
        self.port = port
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.debug_endpoints = debug_endpoints
        # fleet SLO rollup (docs/slo.md): attached by main() when
        # --slo-spec is given; GET /slo answers 404 until then
        self.slo_rollup = None
        self.gossip = gossip
        self.stream_buffer = max(1, stream_buffer)
        self.budget = RetryBudget(ratio=retry_budget_ratio)
        self._jitter = random.Random(1)
        self.request_log = _coerce_reqlog(request_log)
        self.span_log = tracing.coerce_span_log(span_log,
                                                component="router")
        self._h_request = router.registry.histogram(
            "ome_router_request_seconds",
            "End-to-end proxied request seconds (retries included)")
        _fam_class = router.registry.counter(
            "ome_router_class_requests_total",
            "Completion requests proxied, by priority class",
            labelnames=("class",))
        self._c_class = {c: _fam_class.labels(**{"class": c})
                         for c in PRIORITY_CLASSES}
        # asyncio data-path telemetry (docs/observability.md)
        self._g_open_streams = router.registry.gauge(
            "ome_router_open_streams",
            "SSE streams currently being proxied by this replica")
        self._c_backpressure = router.registry.counter(
            "ome_router_stream_backpressure_total",
            "Stream chunks that found the per-stream buffer full (the "
            "slow client is now backpressuring its upstream read)")
        self._c_disconnects = router.registry.counter(
            "ome_router_client_disconnects_total",
            "Proxied requests whose client vanished mid-flight")
        # mutated only on the event loop (single-threaded); exported
        # to the gauge at scrape time
        self._open_streams = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "AsyncRouterServer":
        """Run the event loop on a dedicated thread (the process main
        thread keeps the threaded ecosystem: signal handling, health
        loop, gossip agent, tests driving with urllib)."""
        self.router.start_health_loop()
        self._thread = threading.Thread(target=self._run,
                                        name="ome-arouter", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("async router failed to start")
        return self

    def _run(self):
        asyncio.run(self._serve())

    async def _serve(self):
        server = await asyncio.start_server(
            self._handle_conn, host=self.host, port=self.port)
        self.port = server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        self._stopping = asyncio.Event()
        self._ready.set()
        async with server:
            await self._stopping.wait()

    def stop(self):
        self.router.stop()
        if self._loop is not None and self._stopping is not None:
            self._loop.call_soon_threadsafe(self._stopping.set)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.request_log.close()
        self.span_log.close()

    # -- HTTP plumbing -------------------------------------------------

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line or not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, target = parts[0].upper(), parts[1]
        headers = _Headers()
        while True:
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("Content-Length") or 0)
        body = await reader.readexactly(n) if n > 0 else b""
        return method, target, headers, body

    @staticmethod
    def _head(code: int, headers) -> bytes:
        reason = http.client.responses.get(code, "Unknown")
        lines = [f"HTTP/1.1 {code} {reason}"]
        lines += [f"{k}: {v}" for k, v in headers]
        lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _send_body(self, writer, code: int, body: bytes,
                         content_type: str, extra: Optional[dict] = None):
        headers = [("Content-Type", content_type),
                   ("Content-Length", str(len(body)))]
        headers += list((extra or {}).items())
        try:
            writer.write(self._head(code, headers) + body)
            await writer.drain()
        except (OSError, ConnectionError) as e:
            raise _ClientGone(str(e)) from e

    async def _send_json(self, writer, code: int, obj,
                         extra: Optional[dict] = None):
        await self._send_body(writer, code, json.dumps(obj).encode(),
                              "application/json", extra)

    # -- connection handling -------------------------------------------

    async def _handle_conn(self, reader, writer):
        try:
            try:
                request = await asyncio.wait_for(
                    self._read_request(reader), timeout=120.0)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                    OSError, ValueError):
                return
            if request is None:
                return
            method, path, headers, body = request
            await self._dispatch(method, path, headers, body,
                                 reader, writer)
        except _ClientGone:
            self._c_disconnects.inc()
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("connection handler failed")
            try:
                await self._send_json(writer, 500,
                                      {"error": "internal error"})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    def _guard(self) -> bool:
        return self.debug_endpoints

    async def _dispatch(self, method, path, headers, body,
                        reader, writer):
        router = self.router
        if method == "GET":
            if path in ("/health", "/healthz"):
                snap = router.backend_snapshot()
                up = any(b["healthy"] for b in snap)
                return await self._send_json(
                    writer, 200 if up else 503, {
                        "status": "ok" if up else "no healthy backends",
                        "backends": [
                            {k: b[k] for k in
                             ("url", "pool", "healthy", "draining")}
                            for b in snap]})
            if path == "/gossip/state":
                # the anti-entropy protocol surface: unguarded like
                # /health — it carries observations, not admin power
                if self.gossip is None:
                    return await self._send_json(
                        writer, 404, {"error": "gossip disabled"})
                return await self._send_json(writer, 200,
                                             self.gossip.snapshot())
            if path == "/backends":
                if not self._guard():
                    return await self._send_json(writer, 403, {
                        "error": "debug endpoints disabled "
                                 "(enable --debug-endpoints)"})
                return await self._send_json(writer, 200, {
                    "backends": router.backend_snapshot()})
            if path == "/slo":
                # fleet SLO attainment / budget / alert state
                # (docs/slo.md), guarded like /backends
                if not self._guard():
                    return await self._send_json(writer, 403, {
                        "error": "debug endpoints disabled "
                                 "(enable --debug-endpoints)"})
                if self.slo_rollup is None:
                    return await self._send_json(writer, 404, {
                        "error": "slo rollup not configured "
                                 "(start with --slo-spec)"})
                return await self._send_json(
                    writer, 200, self.slo_rollup.report())
            if path == "/debug/state":
                if not self._guard():
                    return await self._send_json(writer, 403, {
                        "error": "debug endpoints disabled "
                                 "(enable --debug-endpoints)"})
                return await self._send_json(writer, 200, {
                    "backends": router.backend_snapshot(),
                    "gossip": (self.gossip.stats()
                               if self.gossip else None),
                    "streams": {
                        "open": self._open_streams,
                        "backpressure_total":
                            self._c_backpressure.value,
                        "client_disconnects_total":
                            self._c_disconnects.value}})
            if path == "/metrics":
                router.update_gauges()
                self._g_open_streams.set(self._open_streams)
                body_b = router.registry.render().encode()
                return await self._send_body(
                    writer, 200, body_b, "text/plain; version=0.0.4")
            return await self._proxy(method, path, headers, b"",
                                     False, "", reader, writer)
        if method == "POST":
            if path == "/backends":
                return await self._backends_mutate(writer, body,
                                                   add=True)
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                payload = {}
            cls = None
            if path in ("/v1/completions", "/v1/chat/completions"):
                try:
                    cls = coerce_priority(
                        headers.get("X-OME-Priority")
                        or payload.get("priority"))
                except ValueError:
                    cls = DEFAULT_PRIORITY
                self._c_class[cls].inc()
            stream = bool(payload.get("stream"))
            mdl = payload.get("model")
            return await self._proxy(
                method, path, headers, body, stream,
                affinity_from_payload(payload), reader, writer,
                cls=cls,
                model=mdl if isinstance(mdl, str) else None)
        if method == "DELETE":
            if path == "/backends":
                return await self._backends_mutate(writer, body,
                                                   add=False)
            return await self._send_json(writer, 404,
                                         {"error": "not found"})
        return await self._send_json(writer, 405,
                                     {"error": "method not allowed"})

    async def _backends_mutate(self, writer, body: bytes, add: bool):
        if not self._guard():
            return await self._send_json(writer, 403, {
                "error": "debug endpoints disabled "
                         "(enable --debug-endpoints)"})
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            payload = {}
        url = payload.get("url")
        if not url:
            return await self._send_json(writer, 400,
                                         {"error": "missing 'url'"})
        if add:
            b = self.router.add_backend(url,
                                        payload.get("pool") or "engine")
            return await self._send_json(writer, 200, {
                "ok": True, "url": b.url, "pool": b.pool})
        removed = self.router.remove_backend(url)
        return await self._send_json(writer, 200 if removed else 404, {
            "ok": removed, "url": url.rstrip("/")})

    # -- proxy path ----------------------------------------------------

    def _pick_pool(self, headers) -> str:
        want = headers.get("X-OME-Pool") or "engine"
        if self.router._alive(want):
            return want
        other = "decoder" if want == "engine" else "engine"
        return other if self.router._alive(other) else want

    @staticmethod
    def _deadline(headers) -> Optional[float]:
        hdr = headers.get("X-Request-Deadline")
        if not hdr:
            return None
        try:
            return float(hdr)
        except ValueError:
            return None

    async def _proxy(self, method, path, headers, body, stream,
                     affinity, reader, writer, cls=None, model=None):
        ctx = tracing.from_headers(headers)
        t0 = time.monotonic()
        outcome = {"backend": None, "pool": None,
                   "status": "error", "retries": 0,
                   "class": cls}
        span = None
        if self.span_log.enabled:
            span = tracing.Span("router.request",
                                trace_id=ctx.trace_id,
                                span_id=ctx.span_id, start_mono=t0)
            span.set(path=path)
        # disconnect watcher: once the request body is consumed, any
        # read on the client socket resolves only at EOF — the client
        # hanging up. Cancelling the proxy task tears the upstream
        # connection down with it (the fetch is cancelled, the engine
        # stops generating for a viewer that left).
        gone = {"flag": False}
        me = asyncio.current_task()
        async def watch():
            try:
                while True:
                    data = await reader.read(65536)
                    if not data:
                        break
            except (OSError, asyncio.CancelledError):
                return
            gone["flag"] = True
            me.cancel()
        watcher = asyncio.create_task(watch())
        try:
            return await self._route(method, path, headers, body,
                                     stream, affinity, ctx, outcome,
                                     writer, model=model)
        except asyncio.CancelledError:
            if not gone["flag"]:
                raise
            # real SSE clients hang up the moment they read the
            # `data: [DONE]` sentinel — the watcher's cancellation
            # then races the relay's own return. If the full
            # response was already delivered the request was SERVED;
            # only a mid-response hangup is a true client_gone
            # (docs/slo.md availability classification)
            outcome["status"] = ("ok" if outcome.get("delivered")
                                 else "client_gone")
            raise _ClientGone("client closed connection") from None
        finally:
            watcher.cancel()
            dur = time.monotonic() - t0
            self._h_request.observe(dur)
            if cls is not None and outcome["status"] != "client_gone":
                # availability: everything the router answered is
                # good except its own failure statuses
                self.router.note_outcome(
                    cls, outcome["status"] == "ok")
            if span is not None:
                span.set(pool=outcome["pool"],
                         backend=outcome["backend"],
                         status=outcome["status"],
                         retries=outcome["retries"])
                span.end(t0 + dur)
                self.span_log.write(span)
            if self.request_log.enabled:
                self.request_log.write({
                    "component": "router",
                    "trace_id": ctx.trace_id,
                    "span_id": ctx.span_id,
                    "path": path,
                    "pool": outcome["pool"],
                    "backend": outcome["backend"],
                    "status": outcome["status"],
                    "retries": outcome["retries"],
                    "duration_s": round(dur, 6)})

    async def _route(self, method, path, headers, body, stream,
                     affinity, ctx, outcome, writer, model=None):
        router = self.router
        router.inc("requests_total")
        self.budget.deposit()
        deadline = self._deadline(headers)
        # model-aware gate (docs/model-fleet.md) — same verdicts as
        # the threaded router: 404 unknown, 503 + Retry-After cold,
        # steer when serving, legacy any-backend when routing is off
        if model:
            verdict, _ = router.classify_model(model)
            if verdict == "unknown":
                router.note_model_unknown()
                outcome["status"] = "unknown_model"
                return await self._send_json(writer, 404, {
                    "error": f"model {model!r} is not served "
                             "by this fleet",
                    "model": model})
            if verdict == "cold":
                ra = router.model_map.retry_after(model)
                router.note_model_cold(model)
                if self.span_log.enabled:
                    cspan = tracing.Span(
                        "router.cold_start",
                        trace_id=ctx.trace_id,
                        parent_id=ctx.span_id)
                    cspan.set(model=model, retry_after=ra)
                    self.span_log.write(cspan)
                outcome["status"] = "cold_start"
                return await self._send_json(writer, 503, {
                    "error": f"model {model!r} is cold "
                             "(no live backend yet)",
                    "model": model, "retry_after": ra},
                    extra={"Retry-After": str(ra)})
            if verdict == "serving":
                router.note_model_request(model)
            else:
                model = None  # routing off for this name
        pool = self._pick_pool(headers)
        outcome["pool"] = pool
        peer_hint = None
        if affinity and router.policy == "cache_aware":
            peer_hint = router.prefix_directory.lookup(
                prefix_digest(affinity))
            if peer_hint is not None:
                router.inc("prefix_directory_hits_total")
        tried: set = set()
        last_err = "no healthy backends"
        failures = 0
        need_backoff = False
        while failures <= self.retries:
            if deadline is not None and time.time() >= deadline:
                router.inc("deadline_shed_total")
                outcome["status"] = "deadline"
                return await self._send_json(writer, 504, {
                    "error": "request deadline exceeded"})
            if need_backoff:
                need_backoff = False
                if not self.budget.withdraw():
                    router.inc("retry_budget_exhausted_total")
                    break
                delay = (self.retry_backoff * (2 ** (failures - 1))
                         * (1 + self._jitter.random()))
                await asyncio.sleep(delay)
            backend = router.pick(pool, affinity, exclude=tried,
                                  model=model)
            if backend is None:
                break
            tried.add(backend.url)
            outcome["backend"] = backend.url
            outcome["retries"] = failures
            child = ctx.child()
            aspan = None
            if self.span_log.enabled:
                aspan = tracing.Span("router.attempt",
                                     trace_id=ctx.trace_id,
                                     parent_id=ctx.span_id,
                                     span_id=child.span_id)
                aspan.set(backend=backend.url, retries=failures)
            try:
                result = await self._forward(
                    backend, method, path, headers, body, stream,
                    deadline, trace=child,
                    prefix_peer=(peer_hint
                                 if peer_hint != backend.url
                                 else None),
                    writer=writer, outcome=outcome)
                router.note_result(backend, ok=True)
                outcome["status"] = "ok"
                if aspan is not None:
                    self.span_log.write(aspan.set(status="ok"))
                return result
            except _BackendDraining:
                router.note_draining(backend)
                router.inc("draining_skips_total")
                log.info("backend %s draining; redirecting",
                         backend.url)
                if aspan is not None:
                    self.span_log.write(aspan.set(status="draining"))
                continue
            except _ClientGone:
                router.probe_aborted(backend)
                outcome["status"] = "client_gone"
                if aspan is not None:
                    self.span_log.write(
                        aspan.set(status="client_gone"))
                raise
            except asyncio.CancelledError:
                # the disconnect watcher (or shutdown) cancelled us
                # mid-forward: release any half-open probe slot —
                # same discipline as _ClientGone
                router.probe_aborted(backend)
                raise
            except _ResponseStarted as e:
                router.note_result(backend, ok=False)
                log.warning("backend %s died mid-response: %s",
                            backend.url, e)
                try:
                    writer.write(b"0\r\n\r\n")
                except (OSError, ConnectionError):
                    pass
                outcome["status"] = "stream_abort"
                if aspan is not None:
                    self.span_log.write(
                        aspan.set(status="stream_abort"))
                return None
            except _UpstreamError as e:
                last_err = str(e)
                router.note_result(backend, ok=False)
                router.inc("retries_total")
                log.warning("backend %s failed (%s); retrying",
                            backend.url, e)
                if aspan is not None:
                    self.span_log.write(aspan.set(
                        status="error", error=str(e)))
                failures += 1
                need_backoff = True
        router.inc("no_backend_total")
        outcome["status"] = "no_backend"
        await self._send_json(writer, 503, {
            "error": f"routing failed: {last_err}"},
            extra={"Retry-After": "1"})

    # -- upstream client -----------------------------------------------

    async def _open_upstream(self, url: str, method: str, path: str,
                             headers: Dict[str, str], body: bytes,
                             deadline_mono: float
                             ) -> Tuple[asyncio.StreamReader,
                                        asyncio.StreamWriter]:
        parts = urllib.parse.urlsplit(url)
        port = parts.port or (443 if parts.scheme == "https" else 80)
        reader, writer = await _bounded(
            asyncio.open_connection(
                parts.hostname, port,
                ssl=True if parts.scheme == "https" else None),
            deadline_mono)
        lines = [f"{method} {path} HTTP/1.1",
                 f"Host: {parts.netloc}",
                 "Connection: close",
                 f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                     + body)
        await _bounded(writer.drain(), deadline_mono)
        return reader, writer

    @staticmethod
    async def _read_head(reader, deadline_mono
                         ) -> Tuple[int, _Headers]:
        status_line = await _bounded(reader.readline(), deadline_mono)
        parts = status_line.decode("latin-1").split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise _UpstreamError(
                f"malformed status line {status_line!r}")
        status = int(parts[1])
        headers = _Headers()
        while True:
            raw = await _bounded(reader.readline(), deadline_mono)
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        return status, headers

    @staticmethod
    async def _iter_chunks(reader, deadline_mono):
        """Decode Transfer-Encoding: chunked frames (the engine's SSE
        framing) into raw byte chunks."""
        while True:
            size_line = await _bounded(reader.readline(), deadline_mono)
            if not size_line:
                return  # upstream closed at a frame boundary
            size = int(size_line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                await _bounded(reader.readline(), deadline_mono)
                return
            data = await _bounded(reader.readexactly(size),
                                  deadline_mono)
            await _bounded(reader.readexactly(2), deadline_mono)
            yield data

    async def _read_body(self, reader, rheaders, deadline_mono) -> bytes:
        te = (rheaders.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            out = []
            async for data in self._iter_chunks(reader, deadline_mono):
                out.append(data)
            return b"".join(out)
        n = rheaders.get("Content-Length")
        if n is not None:
            return await _bounded(reader.readexactly(int(n)),
                                  deadline_mono)
        return await _bounded(reader.read(-1), deadline_mono)

    async def _forward(self, backend: Backend, method, path, headers,
                       body, stream, deadline, trace, prefix_peer,
                       writer, outcome=None):
        from .. import faults

        await faults.afire("router_forward", key=backend.url,
                           exc=_UpstreamError)
        fwd = {"Content-Type": "application/json"}
        if trace is not None:
            fwd[tracing.TRACEPARENT_HEADER] = trace.header()
        pri = headers.get("X-OME-Priority")
        if pri:
            fwd["X-OME-Priority"] = pri
        if prefix_peer:
            fwd["X-OME-Prefix-Peer"] = prefix_peer
            self.router.inc("prefix_directory_peer_fetches_total")
        timeout = 600.0
        if deadline is not None:
            fwd["X-Request-Deadline"] = repr(deadline)
            timeout = max(min(timeout, deadline - time.time()), 0.05)
        deadline_mono = time.monotonic() + timeout
        self.router.adjust_inflight(backend, 1)
        up_writer = None
        try:
            try:
                up_reader, up_writer = await self._open_upstream(
                    backend.url, method, path, fwd, body,
                    deadline_mono)
                status, rheaders = await self._read_head(
                    up_reader, deadline_mono)
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                raise _UpstreamError(str(e)) from e
            if status == 503 and rheaders.get("X-OME-Draining"):
                raise _BackendDraining(backend.url)
            if status >= 500:
                raise _UpstreamError(f"backend returned {status}")
            if status >= 400:
                # application response: relay verbatim, no failover
                try:
                    data = await self._read_body(up_reader, rheaders,
                                                 deadline_mono)
                except (OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError, ValueError) as e:
                    raise _UpstreamError(str(e)) from e
                extra = {}
                ra = rheaders.get("Retry-After")
                if ra:
                    extra["Retry-After"] = ra
                await self._send_body(
                    writer, status, data,
                    rheaders.get("Content-Type", "application/json"),
                    extra)
                if outcome is not None:
                    outcome["delivered"] = True
                return None
            if stream:
                await self._relay_stream(up_reader, rheaders, status,
                                         writer, deadline_mono,
                                         outcome=outcome)
                return None
            try:
                data = await self._read_body(up_reader, rheaders,
                                             deadline_mono)
            except (OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, ValueError) as e:
                # nothing reached the client yet: retryable
                raise _UpstreamError(str(e)) from e
            await self._send_body(
                writer, status, data,
                rheaders.get("Content-Type", "application/json"))
            if outcome is not None:
                outcome["delivered"] = True
            return None
        finally:
            self.router.adjust_inflight(backend, -1)
            if up_writer is not None:
                # every exit path — success, retryable error, client
                # disconnect cancellation — closes the upstream
                # connection, which is what cancels the fetch
                up_writer.close()

    async def _relay_stream(self, up_reader, rheaders, status, writer,
                            deadline_mono, outcome=None):
        """Backpressure-aware SSE relay: upstream chunks flow through
        a BOUNDED queue into the client socket. The pump (upstream
        reader) and the writer are separate coroutines, so a slow
        client never blocks the pump until its own buffer fills —
        then that one stream's upstream read pauses (TCP backpressure
        to the engine) while every other stream keeps flowing."""
        try:
            writer.write(self._head(status, [
                ("Content-Type", rheaders.get("Content-Type",
                                              "text/event-stream")),
                ("Transfer-Encoding", "chunked")]))
            await writer.drain()
        except (OSError, ConnectionError) as e:
            raise _ClientGone(str(e)) from e
        q: asyncio.Queue = asyncio.Queue(maxsize=self.stream_buffer)
        chunked = "chunked" in (rheaders.get("Transfer-Encoding")
                                or "").lower()

        async def pump():
            try:
                if chunked:
                    async for data in self._iter_chunks(up_reader,
                                                        deadline_mono):
                        if q.full():
                            self._c_backpressure.inc()
                        await q.put(("data", data))
                else:
                    while True:
                        data = await _bounded(up_reader.read(65536),
                                              deadline_mono)
                        if not data:
                            break
                        if q.full():
                            self._c_backpressure.inc()
                        await q.put(("data", data))
                await q.put(("eof", None))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                await q.put(("err", e))

        pump_task = asyncio.create_task(pump())
        self._open_streams += 1
        try:
            # real SSE clients hang up the moment they read the
            # `data: [DONE]` sentinel, without draining the trailing
            # blank line or the chunked terminator — once the
            # sentinel is delivered the request was SERVED, and
            # classifying it client_gone would poison the
            # availability SLO (docs/slo.md)
            done_sent = False
            while True:
                kind, payload = await q.get()
                if kind == "eof":
                    break
                if kind == "err":
                    raise _ResponseStarted(str(payload))
                try:
                    writer.write(f"{len(payload):x}\r\n".encode()
                                 + payload + b"\r\n")
                    await writer.drain()
                except (OSError, ConnectionError) as e:
                    if done_sent:
                        break
                    raise _ClientGone(str(e)) from e
                if b"data: [DONE]" in payload:
                    done_sent = True
                    if outcome is not None:
                        # the disconnect watcher may cancel us the
                        # instant the client reads the sentinel —
                        # record that the response is complete so
                        # that cancellation classifies as served
                        outcome["delivered"] = True
            try:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            except (OSError, ConnectionError):
                # upstream is drained and every body byte was
                # relayed: a client that hangs up between the last
                # event and the terminating chunk still received the
                # whole response — served, not abandoned
                pass
            if outcome is not None:
                outcome["delivered"] = True
        finally:
            self._open_streams -= 1
            pump_task.cancel()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ome-arouter")
    p.add_argument("--backend", action="append", default=[],
                   help="engine URL (repeatable); pool prefix with "
                        "'decoder=' routes to the decode pool")
    p.add_argument("--policy", default="cache_aware",
                   choices=("cache_aware", "round_robin", "random"))
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--health-interval", type=float, default=10.0)
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--retry-backoff", type=float, default=0.05)
    p.add_argument("--cb-threshold", type=int, default=3)
    p.add_argument("--cb-cooldown", type=float, default=1.0)
    p.add_argument("--faults", default=None,
                   help="deterministic fault-injection spec "
                        "(faults.py grammar); also via "
                        "OME_FAULTS")
    p.add_argument("--debug-endpoints", action="store_true")
    p.add_argument("--model-catalog", default=None,
                   help="model catalog JSON ({model: {warmup_ms, "
                        "weight_bytes}}): declares the fleet's model "
                        "set and turns on model-aware enforcement — "
                        "unknown model 404, known-but-cold 503 + "
                        "Retry-After (docs/model-fleet.md)")
    p.add_argument("--slo-spec", default=None,
                   help="SLO spec JSON (config/slo.json format): "
                        "starts the fleet rollup loop and serves "
                        "GET /slo + ome_slo_* metrics (docs/slo.md)")
    p.add_argument("--slo-interval", type=float, default=5.0,
                   help="seconds between fleet SLO rollup scrapes")
    p.add_argument("--request-log", default=None)
    p.add_argument("--span-log", default=None)
    p.add_argument("--stream-buffer", type=int, default=64,
                   help="per-stream chunk buffer between the upstream "
                        "reader and the client writer (bounds memory; "
                        "a full buffer backpressures that stream's "
                        "upstream read)")
    p.add_argument("--gossip-peer", action="append", default=[],
                   help="peer router base URL to pull /gossip/state "
                        "from (repeatable); enables the anti-entropy "
                        "agent on the health-loop cadence")
    p.add_argument("--replica-id", default=None,
                   help="stable replica identity for gossip LWW "
                        "tie-breaks (default: host:port:pid)")
    p.add_argument("--engine-selector", default=None)
    p.add_argument("--decoder-selector", default=None)
    p.add_argument("--namespace", default="default")
    p.add_argument("--kubeconfig", default=None)
    p.add_argument("--kube-server", default=None)
    p.add_argument("--in-cluster", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.faults:
        from .. import faults
        faults.install(args.faults)
        log.warning("fault injection ACTIVE: %s", args.faults)
    backends = []
    for spec in args.backend:
        if spec.startswith("decoder="):
            backends.append(Backend(spec[len("decoder="):], "decoder"))
        elif spec.startswith("engine="):
            backends.append(Backend(spec[len("engine="):], "engine"))
        else:
            backends.append(Backend(spec, "engine"))
    if args.engine_selector or args.decoder_selector:
        from ..cmd.manager import build_client
        client = build_client(args)
        if args.engine_selector:
            backends += discover_backends(
                client, args.namespace,
                _parse_selector(args.engine_selector), "engine")
        if args.decoder_selector:
            backends += discover_backends(
                client, args.namespace,
                _parse_selector(args.decoder_selector), "decoder")
        log.info("discovered %d backends via selectors", len(backends))
    if not backends:
        p.error("at least one --backend or --engine-selector is "
                "required")
    router = Router(backends, policy=args.policy,
                    health_interval=args.health_interval,
                    cb_threshold=args.cb_threshold,
                    cb_cooldown=args.cb_cooldown)
    if args.model_catalog:
        with open(args.model_catalog, "r", encoding="utf-8") as f:
            router.model_map.load_catalog(json.load(f))
        log.info("model catalog loaded: %s (enforcement on)",
                 args.model_catalog)
    router.check_health_once()
    replica_id = args.replica_id or \
        f"{args.bind}:{args.port}:{os.getpid()}"
    gossip = GossipState(router, replica_id)
    srv = AsyncRouterServer(
        router, host=args.bind, port=args.port, retries=args.retries,
        retry_backoff=args.retry_backoff,
        request_log=args.request_log, span_log=args.span_log,
        debug_endpoints=args.debug_endpoints, gossip=gossip,
        stream_buffer=args.stream_buffer).start()
    agent = None
    if args.gossip_peer:
        agent = GossipAgent(gossip, args.gossip_peer,
                            interval=args.health_interval).start()
    if args.slo_spec:
        from ..autoscale.scrape import SharedScraper
        from ..slo import FleetRollup
        from ..slo import load as load_slo
        from ..slo.rollup import start_thread as start_slo_thread
        scraper = SharedScraper(clock=time.monotonic,
                                max_age=args.slo_interval / 2.0)
        srv.slo_rollup = FleetRollup(
            load_slo(args.slo_spec), clock=time.monotonic,
            fetch_fn=scraper.fetch,
            backends_fn=router.backend_snapshot,
            registry=router.registry,
            local_samples_fn=router.registry.snapshot)
        start_slo_thread(srv.slo_rollup, args.slo_interval)
        log.info("slo rollup active: %s every %.1fs",
                 args.slo_spec, args.slo_interval)
    log.info("async router on :%d over %d backends (policy=%s, "
             "replica=%s, peers=%d)", srv.port, len(backends),
             args.policy, replica_id, len(args.gossip_peer))
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        if agent is not None:
            agent.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
