"""The port's routers against the reference's over HTTP, in front of the
same stub upstreams (`RouterServer` and `AsyncRouterServer`, each
against its reference).

One request script runs through the reference's router and then the
port's, over the same five stubs: two engines that answer, one whose
POSTs announce a drain (503 + X-OME-Draining) while its /ready still
says ready, one that answers 500, and a decoder. The script covers
completions and chat, an SSE stream, an expired deadline (504) and a
live one, a 4xx relayed with its Retry-After, priority and traceparent
headers, the X-OME-Pool steer, a forward whose prefix owner is another
replica (X-OME-Prefix-Peer), a pass-through GET, `/health`, `/metrics`,
the guarded admin surface (`/backends` GET/POST/DELETE, `/slo`, and the
asyncio router's `/debug/state`) and, on a router whose only backend is
dead, 503. Each prompt is chosen so that the rendezvous hash sends it
to the stub the step needs.

Equal between the two: every status code, body and relayed header; the
upstream calls the stubs saw, in order, with the headers forwarded
(the traceparent by trace id, since each hop mints a span id); the
metric families and counter and gauge values (histograms by count);
`router.stats`.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ome_tpu.router import aserver as ref_aserver
from ome_tpu.router import server as ref
from ome_tpu_torch.autoscale.scrape import parse_exposition, split_key
from ome_tpu_torch.router import aserver as port_aserver
from ome_tpu_torch.router import server as port

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
PARENT = f"00-{TRACE}-00f067aa0ba902b7-01"
FORWARDED = ("content-type", "x-ome-priority", "x-request-deadline",
             "x-ome-prefix-peer")


class _Stub:
    """A stand-in engine that logs every upstream call it receives into
    the shared `calls` list. `mode`: ok, draining (POSTs 503 with
    X-OME-Draining, /ready 200) or broken (POSTs 500)."""

    def __init__(self, name, calls, mode="ok", digests=()):
        stub = self
        self.name, self.mode, self.calls = name, mode, calls
        self.digests = list(digests)

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code, obj, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _log(self, body):
                tp = self.headers.get("traceparent") or ""
                parts = tp.split("-")
                stub.calls.append((
                    stub.name, self.command, self.path, body,
                    tuple((k, self.headers.get(k)) for k in FORWARDED),
                    # the client's trace id, or a fresh one minted
                    (parts[1] if parts[1] == TRACE else "minted")
                    if len(parts) == 4 else None,
                    len(parts) == 4 and parts[2] != PARENT.split("-")[2]))

            def do_GET(self):
                if self.path == "/ready":
                    return self._send(200, {
                        "ready": True, "prefix_digests": stub.digests,
                        "models": []})
                self._log(b"")
                self._send(200, {"object": "list",
                                 "data": [{"id": stub.name}]})

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n)
                self._log(raw)
                payload = json.loads(raw or b"{}")
                if stub.mode == "draining":
                    return self._send(503, {"error": "draining"},
                                      [("X-OME-Draining", "1")])
                if stub.mode == "broken":
                    return self._send(500, {"error": "scheduler died"})
                if self.headers.get("X-OME-Priority") == "bogus":
                    return self._send(400, {"error": "unknown priority"})
                text = payload.get("prompt") or json.dumps(
                    payload.get("messages"))
                if text.startswith("overloaded"):
                    return self._send(429, {"error": "overloaded"},
                                      [("Retry-After", "7")])
                if not payload.get("stream"):
                    return self._send(200, {
                        "object": "text_completion", "model": stub.name,
                        "choices": [{"text": f"{stub.name}:{text}"}]})
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for i in range(3):
                    ev = f'data: {{"text": "{stub.name}{i}"}}\n\n'.encode()
                    self.wfile.write(f"{len(ev):x}\r\n".encode() + ev
                                     + b"\r\n")
                    self.wfile.flush()
                done = b"data: [DONE]\n\n"
                self.wfile.write(f"{len(done):x}\r\n".encode() + done
                                 + b"\r\n0\r\n\r\n")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _dead_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture(scope="module")
def stubs():
    calls = []
    fleet = {"a": _Stub("a", calls), "b": _Stub("b", calls),
             "drain": _Stub("drain", calls, "draining"),
             "broken": _Stub("broken", calls, "broken"),
             "dec": _Stub("dec", calls)}
    fleet["dead"] = _dead_url()
    yield fleet, calls
    for s in fleet.values():
        if isinstance(s, _Stub):
            s.close()


def _payload_for(urls, target, make=lambda i: {"prompt": f"q{i}"}):
    """The first of make(0), make(1), ... that the rendezvous hash sends
    to `target` among `urls` (all of them alive)."""
    r = port.Router([port.Backend(u) for u in urls])
    for i in range(10000):
        payload = make(i)
        if r.pick("engine", port.affinity_from_payload(payload)
                  ).url == target:
            return payload
    raise AssertionError("no payload found")


def _prompt_for(urls, target):
    return _payload_for(urls, target)["prompt"]


def _call(base, path, body=None, headers=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path, data=data, method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    ctype = hdrs.get("Content-Type") or ""
    if "event-stream" in ctype:
        out = [ln for ln in raw.decode().splitlines()
               if ln.startswith("data:")]
    elif "json" in ctype:
        out = json.loads(raw)
    else:
        out = raw.decode()
    return status, ctype, hdrs.get("Retry-After"), out


def _metrics(text):
    types, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
    for key, value in parse_exposition(text).items():
        name, labels = split_key(key)
        fam = next((f for f in types if name == f or (
            types[f] == "histogram" and name.startswith(f + "_"))), name)
        if types.get(fam) == "histogram" and not name.endswith("_count"):
            continue
        out[key] = value
    return types, out


def _script(base, fleet, mods_main_url):
    """The request script; returns what the client saw, step by step."""
    a, b, drain, broken = (fleet[k].url for k in ("a", "b", "drain",
                                                  "broken"))
    engines = [a, b, drain, broken]
    seen = []
    p_a = _prompt_for(engines, a)
    p_b = _prompt_for(engines, b)
    p_drain = _prompt_for(engines, drain)
    p_broken = _prompt_for(engines, broken)
    seen.append(_call(base, "/health"))
    seen.append(_call(base, "/v1/completions",
                      {"prompt": p_a, "max_tokens": 3}))
    seen.append(_call(base, "/v1/chat/completions", _payload_for(
        engines, b, lambda i: {"messages": [
            {"role": "user", "content": f"c{i}"}]})))
    seen.append(_call(base, "/v1/completions",
                      {"prompt": p_a, "stream": True}))
    seen.append(_call(base, "/v1/completions", {"prompt": p_a},
                      {"X-Request-Deadline": repr(time.time() - 5)}))
    seen.append(_call(base, "/v1/completions", {"prompt": p_b},
                      {"X-Request-Deadline": "4102444800.5",
                       "X-OME-Priority": "interactive",
                       "traceparent": PARENT}))
    seen.append(_call(base, "/v1/completions", {"prompt": p_a},
                      {"X-OME-Priority": "bogus"}))
    seen.append(_call(base, "/v1/completions", _payload_for(
        engines, a, lambda i: {"prompt": f"overloaded{i}",
                               "priority": "batch"})))
    # the drain announced on a POST: a free failover to the next pick
    seen.append(_call(base, "/v1/completions", {"prompt": p_drain}))
    seen.append(_call(base, "/v1/completions", {"prompt": p_drain}))
    # a 500: a retry (budgeted, with backoff), the breaker charged
    seen.append(_call(base, "/v1/completions",
                      {"prompt": p_broken, "stream": True}))
    seen.append(_call(base, "/v1/completions",
                      {"prompt": p_b}, {"X-OME-Pool": "decoder"}))
    # a prefix owned by a (the directory fed by its /ready), asked of b
    seen.append(_call(base, "/v1/completions", {"prompt": p_b}))
    seen.append(_call(base, "/v1/models"))
    seen.append(_call(base, "/health"))
    for path in ("/backends", "/slo", "/debug/state"):
        seen.append(_call(base, path))
    seen.append(_call(base, "/backends", {"url": "http://10.9.9.9:1/",
                                          "pool": "decoder"}))
    seen.append(_call(base, "/backends"))
    seen.append(_call(base, "/backends", {"url": "http://10.9.9.9:1"},
                      method="DELETE"))
    seen.append(_call(base, "/backends", {"url": "http://10.9.9.9:1"},
                      method="DELETE"))
    seen.append(_call(base, "/backends", {}, method="POST"))
    seen.append(_call(base, "/nope", {}, method="DELETE"))
    seen.append(_call(mods_main_url, "/v1/completions", {"prompt": "x"}))
    seen.append(_call(mods_main_url, "/health"))
    return seen


FLAVOURS = {
    "threaded": (ref.RouterServer, port.RouterServer),
    "asyncio": (ref_aserver.AsyncRouterServer,
                port_aserver.AsyncRouterServer),
}


def _run(mod, server_cls, fleet, calls, debug):
    f = fleet
    engines = [f["a"].url, f["b"].url, f["drain"].url, f["broken"].url]
    f["a"].digests = [mod.prefix_digest(mod.affinity_from_payload(
        {"prompt": _prompt_for(engines, f["b"].url)}))]
    router = mod.Router([mod.Backend(u) for u in engines]
                        + [mod.Backend(f["dec"].url, "decoder")],
                        policy="cache_aware", health_interval=3600)
    router.check_health_once()
    dead = mod.Router([mod.Backend(f["dead"])], health_interval=3600)
    srv = server_cls(router, host="127.0.0.1", port=0,
                     debug_endpoints=debug).start()
    down = server_cls(dead, host="127.0.0.1", port=0).start()
    del calls[:]
    try:
        seen = _script(f"http://127.0.0.1:{srv.port}", fleet,
                       f"http://127.0.0.1:{down.port}")
        metrics = _metrics(_call(f"http://127.0.0.1:{srv.port}",
                                 "/metrics")[3])
        stats = router.stats
    finally:
        srv.stop()
        down.stop()
    return seen, list(calls), metrics, stats


@pytest.mark.parametrize("debug", [True, False], ids=["debug", "guarded"])
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_http_parity(stubs, flavour, debug):
    fleet, calls = stubs
    ref_cls, port_cls = FLAVOURS[flavour]
    want = _run(ref, ref_cls, fleet, calls, debug)
    got = _run(port, port_cls, fleet, calls, debug)
    names = ("responses", "upstream calls", "metrics", "stats")
    for name, w, g in zip(names, want, got):
        assert g == w, name
    seen, upstream, (types, values), stats = got
    # the script did what it says
    status = [s[0] for s in seen]
    assert status[:14] == [200, 200, 200, 200, 504, 200, 400, 429, 200,
                           200, 200, 200, 200, 200]
    assert seen[3][3][-1] == "data: [DONE]" and len(seen[3][3]) == 4
    assert seen[7][2] == "7"
    assert status[-2:] == [503, 503] and seen[-2][2] == "1"
    assert stats["deadline_shed_total"] == 1
    assert stats["draining_skips_total"] == 1
    assert stats["retries_total"] == 1
    assert stats["prefix_directory_peer_fetches_total"] >= 1
    peer = [c for c in upstream
            if dict(c[4]).get("x-ome-prefix-peer") == fleet["a"].url]
    assert peer and peer[0][0] == "b"
    traced = [c for c in upstream if c[5] == TRACE]
    assert len(traced) == 1 and traced[0][6]
    assert dict(traced[0][4])["x-ome-priority"] == "interactive"
    assert dict(traced[0][4])["x-request-deadline"] == "4102444800.5"
    assert any(c[0] == "dec" for c in upstream)
    assert types["ome_router_request_seconds"] == "histogram"
    if debug:
        assert status[15] == 200 and status[16] == 404
    else:
        assert status[15] == 403 and status[16] == 403
