"""The port's asyncio router (`ome_tpu_torch/router/aserver.py`) in the
reference's scenarios (tests/test_arouter.py), each run on the
reference's `AsyncRouterServer` and on the port's with the same stub:
the SSE relay end to end, a client disconnect cancelling the upstream
fetch, a slow client filling only its own bounded buffer, and held-open
streams through one event-loop thread within the reference's thread and
memory budget. What each router does is equal: the events relayed, the
upstream aborts and the disconnect count, the chunks in order, the
stream accounting drained.

The soak holds `SOAK_STREAMS` streams open at once (4 file descriptors
each, router and stub in this process), fewer than the reference's
slow-marked soak, which aims at 10,000 and clamps to the fd limit: that
many streams take minutes on a CPU test host, well past a test file's
minute.
"""

import asyncio
import json
import resource
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ome_tpu.router import aserver as ref_aserver
from ome_tpu.router import server as ref_server
from ome_tpu_torch.router import aserver as port_aserver
from ome_tpu_torch.router import server as port_server

IMPLS = {"reference": (ref_aserver, ref_server),
         "port": (port_aserver, port_server)}
SOAK_STREAMS = 1024


class _StubUpstream:
    """Threaded stand-in engine: JSON completions, chunked SSE
    streaming, optional slow streaming so that a client disconnect
    mid-stream is observable upstream."""

    def __init__(self, stream_events=3, event_delay=0.0):
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _chunk(self, data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode()
                                 + data + b"\r\n")

            def do_GET(self):
                body = json.dumps({"ready": True}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                json.loads(self.rfile.read(n) or b"{}")
                stub.hits += 1
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for i in range(stub.stream_events):
                        self._chunk(
                            f'data: {{"text": "t{i}"}}\n\n'.encode())
                        self.wfile.flush()
                        if stub.event_delay:
                            time.sleep(stub.event_delay)
                    self._chunk(b"data: [DONE]\n\n")
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    stub.aborted += 1

        self.hits = 0
        self.aborted = 0
        self.stream_events = stream_events
        self.event_delay = event_delay
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _sse(impl, n_events):
    aserver, server = IMPLS[impl]
    stub = _StubUpstream(stream_events=n_events)
    srv = aserver.AsyncRouterServer(
        server.Router([server.Backend(stub.url)]), host="127.0.0.1",
        port=0).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": "hi", "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            ctype = r.headers["Content-Type"]
            events = [raw.decode().strip() for raw in r
                      if raw.startswith(b"data:")]
        deadline = time.time() + 5
        while srv._open_streams and time.time() < deadline:
            time.sleep(0.01)
        return ctype, events, srv._open_streams, stub.hits
    finally:
        srv.stop()
        stub.close()


def test_sse_relay_end_to_end():
    want = _sse("reference", 5)
    got = _sse("port", 5)
    assert got == want
    ctype, events, open_streams, hits = got
    assert "text/event-stream" in ctype
    assert events[-1] == "data: [DONE]" and len(events) == 6
    assert open_streams == 0 and hits == 1


def _disconnect(impl):
    aserver, server = IMPLS[impl]
    stub = _StubUpstream(stream_events=200, event_delay=0.05)
    srv = aserver.AsyncRouterServer(
        server.Router([server.Backend(stub.url)]), host="127.0.0.1",
        port=0).start()
    try:
        body = json.dumps({"prompt": "hi", "stream": True}).encode()
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\n"
                  b"Host: t\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"t0" not in got:            # the first event arrived
            got += s.recv(4096)
        s.close()                          # the viewer leaves
        deadline = time.time() + 10
        while time.time() < deadline and (
                stub.aborted == 0 or srv._c_disconnects.value == 0):
            time.sleep(0.05)
        return (stub.aborted >= 1, srv._c_disconnects.value,
                srv.router.backends[0].inflight)
    finally:
        srv.stop()
        stub.close()


def test_client_disconnect_cancels_upstream():
    want = _disconnect("reference")
    got = _disconnect("port")
    assert got == want == (True, 1, 0)


def _slow_client(impl):
    aserver, server = IMPLS[impl]
    router = server.Router([server.Backend("http://x")])
    srv = aserver.AsyncRouterServer(router, host="127.0.0.1", port=0,
                                    stream_buffer=2)
    payloads = [f"data: tok{i}\n\n".encode() for i in range(40)]

    class _SlowWriter:
        def __init__(self):
            self.buf = b""

        def write(self, data):
            self.buf += data

        async def drain(self):
            await asyncio.sleep(0.002)     # slow client

    async def scenario():
        up = asyncio.StreamReader()
        for p in payloads:                 # the whole body ready at once
            up.feed_data(f"{len(p):x}\r\n".encode() + p + b"\r\n")
        up.feed_data(b"0\r\n\r\n")
        up.feed_eof()
        w = _SlowWriter()
        await srv._relay_stream(
            up, aserver._Headers({"transfer-encoding": "chunked"}),
            200, w, time.monotonic() + 30)
        return w.buf

    out = asyncio.run(scenario())
    router.stop()
    return out, srv._c_backpressure.value > 0, srv._open_streams, payloads


def test_slow_client_bounds_its_own_buffer():
    want = _slow_client("reference")
    got = _slow_client("port")
    assert got[:3] == want[:3]
    out, filled, open_streams, payloads = got
    pos = -1
    for p in payloads:                     # every chunk, in order
        nxt = out.find(p)
        assert nxt > pos
        pos = nxt
    assert out.endswith(b"0\r\n\r\n")
    assert filled and open_streams == 0


def _soak(impl, n):
    aserver, server = IMPLS[impl]
    router = server.Router([server.Backend("http://127.0.0.1:1")])
    srv = aserver.AsyncRouterServer(router, host="127.0.0.1", port=0,
                                    stream_buffer=8).start()
    threads_before = threading.active_count()
    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    async def soak():
        release = asyncio.Event()
        opened = asyncio.Semaphore(0)

        async def stub_handle(reader, writer):
            try:
                clen = 0
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    if line.lower().startswith(b"content-length"):
                        clen = int(line.split(b":")[1])
                await reader.readexactly(clen)
                first = b"data: tok\n\n"
                writer.write(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Type: text/event-stream\r\n"
                             b"Transfer-Encoding: chunked\r\n\r\n"
                             + f"{len(first):x}\r\n".encode()
                             + first + b"\r\n")
                await writer.drain()
                await release.wait()       # hold the stream open
                done = b"data: [DONE]\n\n"
                writer.write(f"{len(done):x}\r\n".encode() + done
                             + b"\r\n0\r\n\r\n")
                await writer.drain()
            except (OSError, asyncio.IncompleteReadError):
                pass
            finally:
                writer.close()

        stub = await asyncio.start_server(stub_handle, "127.0.0.1", 0,
                                          backlog=4096)
        router.backends[0].url = \
            f"http://127.0.0.1:{stub.sockets[0].getsockname()[1]}"
        body = json.dumps({"prompt": "x", "stream": True}).encode()
        head = (b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                b"Content-Type: application/json\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode())
        gate = asyncio.Semaphore(256)      # bound connect bursts

        async def one_stream():
            async with gate:
                r, w = await asyncio.open_connection("127.0.0.1", srv.port)
            w.write(head + body)
            await w.drain()
            buf = b""
            while b"data: tok" not in buf:
                got = await r.read(4096)
                assert got, "stream closed before first event"
                buf += got
            opened.release()               # held open from here on
            while b"[DONE]" not in buf:
                got = await r.read(65536)
                if not got:
                    break
                buf += got
            w.close()
            return b"[DONE]" in buf

        tasks = [asyncio.create_task(one_stream()) for _ in range(n)]
        for _ in range(n):                 # every stream delivered
            await asyncio.wait_for(opened.acquire(), timeout=60)
        peak = srv._open_streams           # all open at once
        release.set()
        done = await asyncio.wait_for(asyncio.gather(*tasks), timeout=60)
        stub.close()
        await stub.wait_closed()
        return peak, done

    try:
        peak, done = asyncio.run(soak())
    finally:
        srv.stop()
    threads = threading.active_count() - threads_before
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss \
        - rss_before
    return peak, all(done), srv._open_streams, threads, rss_kib


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_held_open_streams_one_event_loop(impl):
    peak, done, open_after, threads, rss_kib = _soak(impl, SOAK_STREAMS)
    assert peak == SOAK_STREAMS            # genuinely concurrent
    assert done and open_after == 0
    # the reference's budget: no thread per stream (the router's one
    # event-loop thread plus this test's loop), and bounded buffers
    assert threads <= 8
    assert rss_kib < 2 * 1024 * 1024       # KiB (2 GiB)
