"""PD-disaggregated serving: the KV data path between engines (port of
ome_tpu/engine/pd.py).

  * a PREFILL node runs bucketed prefill and exports the prompt's KV
    prefix — `[L, 1, bucket, K, Dh]` k/v + first sampled token +
    true_len — over `/pd/prefill` (engine/server.py);
  * a DECODE node's RemotePrefillEngine fetches that blob instead of
    computing prefill locally, inserts it into a slot and streams
    tokens; the Scheduler is unchanged because the engine surface
    (prefill/insert/decode) is the same;
  * a replica with a prefix cache serves the same handler as a DONOR of
    cross-replica prefix reuse (engine/peering.py).

The wire format is the reference's, byte for byte: a 4-byte
little-endian header length, a JSON header, then the raw k and v bytes
(int8 blobs: then the f32 per-(row, head) scales). A blob written by
either engine is read by the other. bf16 planes go through torch (the
bytes of a bf16 tensor viewed as int16), so neither side needs
`ml_dtypes`; int8 quantization stays numpy on fp32, as in the
reference.

On a card the planes leave the device on a side stream into pinned host
memory behind an event recorded after the prefill (`gather_kv`), and a
decode node uploads a fetched blob the same way on the thread that
fetched it (`upload_planes`: the admission thread under the
scheduler's overlap), so neither copy makes the decode loop wait.

Failure semantics are the reference's: the decode node holds a POOL of
prefill peers with the router's circuit-breaker / draining discipline
(router/server.py Backend); a failed fetch fails over to the next
healthy peer with a per-attempt timeout capped by the request's
deadline; with every peer out, `local_fallback` computes the prefill on
the decode engine itself. All of it is per request: a peer's death never
restarts the scheduler. The multi-host gather of the reference
(`process_allgather`) has no counterpart: the port serves one host.
"""

from __future__ import annotations

import collections
import json
import struct
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import to_device, to_host

# wire dtype name -> torch dtype (the reference's _WIRE_DTYPES names)
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16, "int8": torch.int8}
_WIRE_NAMES = {v: n for n, v in _WIRE_DTYPES.items()}
# how the bytes of each wire dtype are read and written through numpy
# (bf16 has no numpy dtype here: its bytes travel as int16)
_NP_VIEW = {torch.bfloat16: np.int16, torch.float32: np.float32,
            torch.float16: np.float16, torch.int8: np.int8}
_TORCH_VIEW = {torch.bfloat16: torch.int16}


class PDError(Exception):
    pass


def _as_tensor(x) -> torch.Tensor:
    """A plane as a torch tensor: tensors pass through, numpy arrays
    (fp32, fp16, int8) are wrapped."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def gather_kv(x) -> torch.Tensor:
    """Bring a KV plane to host memory (one host: a plain device-to-host
    copy, where the reference gathers across hosts). A CUDA tensor is
    copied on a side stream into pinned memory behind what produced it
    and nothing queued later (`device.to_host`); CPU tensors and numpy
    arrays come back as CPU tensors."""
    x = _as_tensor(x)
    return to_host(x) if x.is_cuda else x.contiguous()


def upload_planes(k, v, device, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host planes -> `device` in `dtype`, complete on return (on a card
    through pinned memory on a side stream, `device.to_device`)."""
    device = torch.device(device)
    return (to_device(_as_tensor(k), device, dtype),
            to_device(_as_tensor(v), device, dtype))


def _bytes_of(a) -> memoryview:
    """A contiguous buffer's bytes as a flat view; an empty plane (the
    zero-width v plane of an MLA latent cache) is no bytes, which
    `memoryview.cast` cannot express."""
    view = memoryview(a)
    return view.cast("B") if view.nbytes else memoryview(b"")


def _plane_view(x: torch.Tensor) -> memoryview:
    """The bytes of a host plane, without a copy (bf16 through int16)."""
    t = x.detach().cpu().contiguous()
    view = _TORCH_VIEW.get(t.dtype)
    return _bytes_of((t.view(view) if view is not None else t).numpy())


def _pack(header: bytes, *planes) -> bytes:
    """Length-prefixed header + planes, copied once into the blob."""
    return b"".join([struct.pack("<I", len(header)), header,
                     *(_bytes_of(p) for p in planes)])


def _read_plane(body, offset: int, shape, dtype: torch.dtype):
    n = int(np.prod(shape))
    a = np.frombuffer(body, dtype=_NP_VIEW[dtype], count=n, offset=offset)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a).reshape(shape)
    return t.view(dtype) if dtype in _TORCH_VIEW else t


def quantize_kv_plane(x) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-(row, head) int8 over the feature axis, host-side
    numpy on fp32 as in the reference (fp32 from bf16 through torch).
    Returns (int8 plane, f32 scales with a keepdims feature axis of 1)."""
    xf = _as_tensor(x).detach().cpu().float().numpy()
    amax = np.max(np.abs(xf), axis=-1, keepdims=True)
    sc = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.rint(xf / sc), -127, 127).astype(np.int8)
    return q, sc.astype(np.float32)


def serialize_kv(token: int, k, v, true_len: int, bucket: int,
                 quantize: bool = False) -> bytes:
    """Pack a prefill result for the wire: 4-byte LE header length +
    JSON header + k bytes + v bytes. k, v: torch tensors (any device)
    or numpy arrays.

    `quantize=True` ships the planes as int8 + f32 per-(row, head)
    scales — half the bytes of bf16 plus ~1.5% of scales. The receiver
    dequantizes back to the original dtype; int8-pool engines
    re-quantize on insert with the same amax rule."""
    k, v = _as_tensor(k), _as_tensor(v)
    name = _WIRE_NAMES.get(k.dtype)
    if quantize:
        if name is None:
            raise PDError(f"unsupported KV dtype {k.dtype}")
        kq, k_sc = quantize_kv_plane(k)
        vq, v_sc = quantize_kv_plane(v)
        header = json.dumps({
            "token": int(token), "true_len": int(true_len),
            "bucket": int(bucket), "shape": list(kq.shape),
            "v_shape": list(vq.shape),
            "dtype": "int8", "orig_dtype": name,
            "k_scale_shape": list(k_sc.shape),
            "v_scale_shape": list(v_sc.shape),
        }).encode()
        return _pack(header, kq, vq, k_sc, v_sc)
    if name is None or name == "int8":
        raise PDError(f"unsupported KV dtype {k.dtype}")
    header = json.dumps({
        "token": int(token), "true_len": int(true_len),
        "bucket": int(bucket), "shape": list(k.shape),
        # the planes' shapes may differ (zero-width v of latent caches),
        # so both go on the wire
        "v_shape": list(v.shape),
        "dtype": name,
    }).encode()
    return _pack(header, _plane_view(k), _plane_view(v))


def deserialize_kv(data) -> Tuple[int, torch.Tensor, torch.Tensor, int,
                                  int]:
    """Inverse of serialize_kv -> (token, k, v, true_len, bucket), the
    planes as CPU tensors. Quantized (int8) payloads are dequantized
    back to their original dtype here, so every caller keeps seeing
    float planes. A writable buffer (bytearray) is read without a copy."""
    if len(data) < 4:
        raise PDError("short PD payload")
    (hlen,) = struct.unpack("<I", bytes(data[:4]))
    try:
        header = json.loads(bytes(data[4:4 + hlen]))
    except ValueError as e:
        raise PDError(f"bad PD header: {e}") from None
    dt = _WIRE_DTYPES.get(header["dtype"])
    if dt is None:
        raise PDError(f"unsupported wire dtype {header['dtype']}")
    shape = tuple(header["shape"])
    v_shape = tuple(header.get("v_shape", header["shape"]))
    item = torch.empty((), dtype=dt).element_size()
    n = int(np.prod(shape)) * item
    nv = int(np.prod(v_shape)) * item
    off = 4 + hlen
    body_len = len(data) - off
    if header["dtype"] == "int8":
        odt = _WIRE_DTYPES.get(header.get("orig_dtype"))
        if odt is None:
            raise PDError("quantized PD payload without orig_dtype")
        ks_shape = tuple(header["k_scale_shape"])
        vs_shape = tuple(header["v_scale_shape"])
        nks = int(np.prod(ks_shape)) * 4
        nvs = int(np.prod(vs_shape)) * 4
        if body_len != n + nv + nks + nvs:
            raise PDError(f"PD payload size mismatch: {body_len} != "
                          f"{n + nv + nks + nvs}")
        kq = _read_plane(data, off, shape, torch.int8).numpy()
        vq = _read_plane(data, off + n, v_shape, torch.int8).numpy()
        k_sc = _read_plane(data, off + n + nv, ks_shape,
                           torch.float32).numpy()
        v_sc = _read_plane(data, off + n + nv + nks, vs_shape,
                           torch.float32).numpy()
        k = torch.from_numpy(kq.astype(np.float32) * k_sc).to(odt)
        v = torch.from_numpy(vq.astype(np.float32) * v_sc).to(odt)
        return (header["token"], k, v, header["true_len"],
                header["bucket"])
    if body_len != n + nv:
        raise PDError(f"PD payload size mismatch: {body_len} != {n + nv}")
    k = _read_plane(data, off, shape, dt)
    v = _read_plane(data, off + n, v_shape, dt)
    return header["token"], k, v, header["true_len"], header["bucket"]


def read_body(resp) -> bytearray:
    """The whole body of an HTTP response into one writable buffer (so
    deserialize_kv reads the planes without another copy)."""
    size = resp.headers.get("Content-Length")
    if size is None:
        return bytearray(resp.read())
    buf = bytearray(int(size))
    view = memoryview(buf)
    got = 0
    while got < len(buf):
        n = resp.readinto(view[got:])
        if not n:
            raise PDError(f"PD payload truncated at {got} of {len(buf)} "
                          "bytes")
        got += n
    return buf


class PrefillPool:
    """Health-tracked prefill peers, reusing the router's Backend
    state machine verbatim (circuit breaker closed→open→half_open with
    exponential cooldown; `draining` as a deliberate, non-failure exit
    from rotation) so PD failover and router failover obey one
    discipline.

    Thread-safe: the scheduler's admission thread and synchronous
    step() callers both pick peers; multi-host leaders fetch under the
    op lock but the gauge reads race freely."""

    def __init__(self, urls: Sequence[str], cb_threshold: int = 2,
                 cb_cooldown: float = 0.5,
                 cb_max_cooldown: float = 15.0):
        from ..router.server import Backend
        if not urls:
            raise ValueError("PrefillPool needs at least one peer URL")
        seen = []
        for u in urls:
            u = u.rstrip("/")
            if u not in seen:
                seen.append(u)
        self.peers = [Backend(u, pool="prefill",
                              cb_threshold=cb_threshold,
                              cb_cooldown=cb_cooldown,
                              cb_max_cooldown=cb_max_cooldown)
                      for u in seen]
        self._lock = threading.Lock()
        self._next = 0

    @property
    def urls(self) -> List[str]:
        return [p.url for p in self.peers]

    def healthy_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for p in self.peers if p.selectable(now))

    def pick(self, exclude: Sequence[str] = ()):
        """Next selectable peer round-robin, or None when the whole
        pool is out of rotation. A half-open peer claims its single
        probe slot here — the data-path attempt IS the probe."""
        now = time.monotonic()
        with self._lock:
            n = len(self.peers)
            for i in range(n):
                p = self.peers[(self._next + i) % n]
                if p.url in exclude or not p.selectable(now):
                    continue
                self._next = (self._next + i + 1) % n
                if p.cb_state == "half_open":
                    p._probe_inflight = True
                return p
        return None

    def note_success(self, peer):
        with self._lock:
            peer.record_success()

    def note_failure(self, peer):
        with self._lock:
            peer.record_failure(time.monotonic())
            peer.healthy = False

    def note_draining(self, peer):
        """503 + X-OME-Draining from a peer: a deliberate exit, not a
        fault — no breaker charge, and the probe slot is released so
        the drain cannot wedge the breaker (router discipline)."""
        with self._lock:
            peer.draining = True
            peer._probe_inflight = False

    def reprobe(self):
        """Synchronous /ready sweep over every out-of-rotation peer —
        run when pick() comes up empty, so a recovered process or a
        cancelled drain re-enters the pool before a request gives up
        on it. A ready answer ends an open breaker's cooldown early
        (the next data-path attempt is still the half-open probe that
        decides); it never closes the breaker outright."""
        from ..router.server import probe_backend
        now = time.monotonic()
        for p in self.peers:
            with self._lock:
                if p.selectable(now):
                    continue
            healthy, draining = probe_backend(p.url, timeout=2.0)
            with self._lock:
                p.draining = draining
                if healthy and not draining:
                    p.healthy = True
                    if p.cb_state == "open":
                        p.cb_open_until = now
                    p._probe_inflight = False


class RemotePrefillEngine:
    """Engine facade for PD decode nodes: prefill() fetches KV from the
    prefill pool; insert/decode run on the local engine untouched.

    Scheduler-compatible drop-in — with overlap mode the remote fetch,
    the deserialize and the upload to the device happen on the admission
    thread, so the decode cadence never waits on the network, and a
    fetch retrying across the pool stalls ONE admission, never the
    decode loop; `insert` then copies device tensors. `timings` keeps
    the last fetches' blob bytes and seconds (HTTP, deserialize, upload,
    insert) for the smoke run's breakdown.
    """

    # network/peer faults fail ONE request, not the scheduler
    # (engine/scheduler.py admission-thread contract)
    transient_prefill_errors = (PDError, urllib.error.URLError,
                                TimeoutError, OSError)
    # the scheduler passes deadline=/trace= into prefill() so the
    # fetch can cap per-attempt timeouts and correlate reqlog records
    pd_request_context = True

    def __init__(self, engine, peer_url: Optional[str] = None,
                 timeout: float = 120.0, *,
                 peer_urls: Sequence[str] = (),
                 local_fallback: bool = False,
                 max_attempts: Optional[int] = None,
                 request_log=None, span_log=None,
                 cb_threshold: int = 2, cb_cooldown: float = 0.5,
                 cb_max_cooldown: float = 15.0):
        from ..telemetry.reqlog import coerce
        from ..telemetry.tracing import coerce_span_log
        self._engine = engine
        urls = ([peer_url] if peer_url else []) + list(peer_urls)
        self.pool = PrefillPool(urls, cb_threshold=cb_threshold,
                                cb_cooldown=cb_cooldown,
                                cb_max_cooldown=cb_max_cooldown)
        # per-ATTEMPT timeout cap; the request deadline caps it
        # further (a flat timeout must never outlive the deadline)
        self.timeout = timeout
        self.local_fallback = local_fallback
        # bounded retry: once around the pool plus one attempt for a
        # peer the empty-pool reprobe just re-admitted
        self.max_attempts = max_attempts or max(
            2, len(self.pool.peers) + 1)
        self.request_log = coerce(request_log)
        # per-attempt peer-attributed spans (pd.fetch) — the attempt's
        # span id IS the forwarded traceparent child, so the prefill
        # node's own records nest under the attempt on the timeline
        self.span_log = coerce_span_log(span_log, component="pd-client")
        self.flight = None  # scheduler attaches its ring (bind_flight)
        # plain-int mirrors of the registry counters so tests (and
        # registry-less schedulers) can assert without telemetry
        self.failovers = 0
        self.local_fallbacks = 0
        self._c_failovers = None
        self._c_fallbacks = None
        self._g_peers = None
        self._last_peer = self.pool.urls[0]
        self._fetch: dict = {}
        self.timings: "collections.deque" = collections.deque(maxlen=256)

    @property
    def peer_url(self) -> str:
        # back-compat: the single-peer attribute older callers read
        return self.pool.urls[0]

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def new_state(self):
        return self._engine.new_state()

    # -- telemetry -----------------------------------------------------

    def bind_registry(self, registry) -> None:
        """Attach PD pool metrics to the process's shared registry
        (the Scheduler calls this with its own)."""
        if registry is None:
            return
        self._c_failovers = registry.counter(
            "ome_engine_pd_failovers_total",
            "Failed /pd/prefill fetch attempts; each fails over to "
            "the next healthy peer or the local fallback")
        self._c_fallbacks = registry.counter(
            "ome_engine_pd_local_fallbacks_total",
            "PD prefills computed locally because the whole prefill "
            "pool was out of rotation")
        self._g_peers = registry.gauge(
            "ome_engine_pd_peers_healthy",
            "Prefill peers currently selectable (breaker closed/"
            "half-open, not draining)")
        self.update_pd_gauges()

    def update_pd_gauges(self) -> None:
        if self._g_peers is not None:
            self._g_peers.set(self.pool.healthy_count())

    def bind_flight(self, flight) -> None:
        """Attach the scheduler's flight recorder so peer failovers
        land in the lifecycle event ring (/debug/events)."""
        self.flight = flight

    def _note_failover(self, peer_url: str = "", error: str = ""):
        self.failovers += 1
        if self._c_failovers is not None:
            self._c_failovers.inc()
        if self.flight is not None:
            self.flight.record("pd_failover", peer=peer_url,
                               error=error[:160])

    def _log_peer_failure(self, peer_url: str, trace, error: str):
        """JSONL reqlog record for a failed peer fetch, carrying the
        request's trace id — what makes a chaos replay joinable
        across the router/engine/prefill process logs."""
        self.request_log.write({
            "component": "pd-client",
            "event": "pd_fetch_failed",
            "peer": peer_url,
            "trace_id": getattr(trace, "trace_id", None),
            "span_id": getattr(trace, "span_id", None),
            "error": error,
        })

    # -- the fetch path ------------------------------------------------

    def prefill_blob(self, prompt_ids, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0,
                     first_mask=None, adapter=None, deadline=None,
                     trace=None, priority=None) -> bytes:
        """The raw wire blob — multi-host leaders replicate it to
        followers verbatim (engine/multihost.py), so the whole decode
        group inserts bit-identical KV from ONE fetch. `first_mask`
        rides along so the PREFILL node constrains the first sampled
        token of a structured request (the decode node never re-draws
        it); `adapter` (a LoRA adapter name registered on BOTH pools)
        makes the prefill node compute the prefix with that adapter's
        deltas.

        `deadline` (monotonic, the request's own) caps each attempt's
        timeout; `trace` rides the traceparent header so the prefill
        node's logs join the request's trace. A failed attempt fails
        over to the next healthy peer (bounded by max_attempts); a
        draining peer is skipped for free. With every peer out and
        `local_fallback` set, the prefix is computed locally."""
        from .. import faults
        from ..telemetry import tracing
        from .structured import pack_mask

        body = json.dumps({
            "ids": list(map(int, prompt_ids)),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p),
            "first_mask": pack_mask(first_mask),
            "adapter": adapter,
            "priority": priority,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if priority:
            # the class rides the PD handoff too, so prefill-node
            # logs/metrics attribute the work to the right tenant
            headers["X-OME-Priority"] = str(priority)
        errors: List[str] = []
        tried: set = set()
        attempts = 0
        reprobed = False
        deadline_hit = False
        while attempts < self.max_attempts:
            peer = self.pool.pick(exclude=tried)
            if peer is None and not reprobed:
                # whole pool looks down/draining: one synchronous
                # /ready sweep lets a recovered peer (or a cancelled
                # drain) re-enter before this request gives up
                reprobed = True
                self.pool.reprobe()
                self.update_pd_gauges()
                tried.clear()  # a recovered peer is worth retrying
                peer = self.pool.pick()
            if peer is None:
                break
            attempts += 1
            per_attempt = self.timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    deadline_hit = True
                    errors.append("request deadline exhausted before "
                                  "the fetch")
                    break
                per_attempt = min(per_attempt, remaining)
            # a FRESH traceparent child per attempt: each peer's own
            # records carry a distinct span id, and the attempt span
            # below reuses that id so the timeline nests peer work
            # under the exact attempt that caused it
            hdrs = dict(headers)
            child = None
            if trace is not None:
                try:
                    child = trace.child()
                    hdrs[tracing.TRACEPARENT_HEADER] = child.header()
                except Exception:  # noqa: BLE001 — tracing must
                    child = None   # never fail a fetch
            span = None
            if self.span_log.enabled:
                span = tracing.Span(
                    "pd.fetch",
                    trace_id=getattr(trace, "trace_id", None),
                    parent_id=getattr(trace, "span_id", None),
                    span_id=(child.span_id if child is not None
                             else None))
                span.set(peer=peer.url, attempt=attempts)
            try:
                # deterministic fault injection: a dropped PD handoff
                # is a TRANSIENT error (fails one request after the
                # pool is exhausted; the scheduler stays up)
                faults.fire("pd_peer_connect", key=peer.url,
                            exc=PDError)
                faults.fire("pd_fetch", key=peer.url, exc=PDError)
                req = urllib.request.Request(
                    peer.url + "/pd/prefill", data=body,
                    headers=hdrs)
                t_http = time.monotonic()
                with urllib.request.urlopen(
                        req, timeout=per_attempt) as resp:
                    data = read_body(resp)
                self._fetch = {"bytes": len(data), "peer": peer.url,
                               "http_s": time.monotonic() - t_http}
                self.pool.note_success(peer)
                self.update_pd_gauges()
                self._last_peer = peer.url
                if span is not None:
                    self.span_log.write(
                        span.set(status="ok", bytes=len(data)))
                return data
            except urllib.error.HTTPError as e:
                draining = bool(
                    e.headers.get("X-OME-Draining")) if e.headers \
                    else False
                e.close()
                tried.add(peer.url)
                if e.code == 503 and draining:
                    # deliberate drain: free failover, no breaker
                    # charge, and the attempt is not spent
                    self.pool.note_draining(peer)
                    self.update_pd_gauges()
                    self._log_peer_failure(peer.url, trace, "draining")
                    if span is not None:
                        self.span_log.write(span.set(status="draining"))
                    attempts -= 1
                    continue
                self.pool.note_failure(peer)
                self.update_pd_gauges()
                msg = f"{peer.url}: HTTP {e.code}"
                errors.append(msg)
                self._log_peer_failure(peer.url, trace, msg)
                self._note_failover(peer.url, msg)
                if span is not None:
                    self.span_log.write(
                        span.set(status="error", error=msg))
            except (PDError, urllib.error.URLError, TimeoutError,
                    OSError) as e:
                tried.add(peer.url)
                self.pool.note_failure(peer)
                self.update_pd_gauges()
                msg = f"{peer.url}: {e}"
                errors.append(msg)
                self._log_peer_failure(peer.url, trace, msg)
                self._note_failover(peer.url, msg)
                if span is not None:
                    self.span_log.write(
                        span.set(status="error", error=msg))
        if self.local_fallback and not deadline_hit:
            self.local_fallbacks += 1
            if self._c_fallbacks is not None:
                self._c_fallbacks.inc()
            self.request_log.write({
                "component": "pd-client",
                "event": "pd_local_fallback",
                "trace_id": getattr(trace, "trace_id", None),
                "errors": errors[-3:],
            })
            kw = {}
            if first_mask is not None:
                kw["first_mask"] = first_mask
            if adapter is not None:
                kw["adapter"] = adapter
            span = None
            if self.span_log.enabled:
                span = tracing.Span(
                    "pd.fetch",
                    trace_id=getattr(trace, "trace_id", None),
                    parent_id=getattr(trace, "span_id", None))
                span.set(peer="local", status="fallback",
                         attempts=attempts)
            token, (k, v), true_len, bucket = self._engine.prefill(
                prompt_ids, temperature, top_k, top_p, **kw)
            self._last_peer = "local"
            blob = serialize_kv(token, gather_kv(k), gather_kv(v),
                                true_len, bucket)
            if span is not None:
                self.span_log.write(span)
            return blob
        raise PDError(
            f"prefill pool exhausted after {attempts} attempt(s): "
            + ("; ".join(errors[-3:]) if errors
               else "no selectable peer"))

    def prefill(self, prompt_ids, temperature: float = 0.0,
                top_k: int = 0, top_p: float = 1.0, first_mask=None,
                adapter=None, deadline=None, trace=None,
                priority=None):
        from .. import faults
        data = self.prefill_blob(prompt_ids, temperature, top_k, top_p,
                                 first_mask=first_mask, adapter=adapter,
                                 deadline=deadline, trace=trace,
                                 priority=priority)
        # a corrupt/truncated blob fails this one request, exactly
        # like the fetch it came from
        faults.fire("pd_deserialize", key=self._last_peer, exc=PDError)
        t0 = time.monotonic()
        token, k, v, true_len, bucket = deserialize_kv(data)
        t1 = time.monotonic()
        # on this (admission) thread, not the decode thread's insert
        k, v = upload_planes(k, v, self._engine.device,
                             self._engine.cfg.dtype)
        rec = dict(self._fetch) if self._last_peer != "local" else {
            "bytes": len(data), "peer": "local", "http_s": 0.0}
        rec.update(deserialize_s=t1 - t0,
                   upload_s=time.monotonic() - t1)
        self.timings.append(rec)
        return token, (k, v), true_len, bucket

    def insert(self, state, kv, slot, true_len, token, bucket,
               adapter=None):
        # a failed insert of fetched KV is the same transient,
        # per-request failure as a failed fetch (the scheduler's
        # insert paths check transient_prefill_errors)
        from .. import faults
        faults.fire("pd_insert", key=self._last_peer, exc=PDError)
        kw = {} if adapter is None else {"adapter": adapter}
        t0 = time.monotonic()
        state = self._engine.insert(state, kv, slot, true_len, token,
                                    bucket, **kw)
        if self.timings:
            self.timings[-1].setdefault("insert_s", time.monotonic() - t0)
        return state

    def decode(self, state, temperature, top_k, top_p, **kw):
        # decode runs on the LOCAL engine; grammar masks — dense
        # (mask=) or mask-table row indices (mask_idx=) — apply to
        # locally sampled tokens only
        kw = {k: v for k, v in kw.items() if v is not None}
        return self._engine.decode(state, temperature, top_k, top_p,
                                   **kw)




def make_pd_prefill_handler(engine):
    """The prefill node's `/pd/prefill` implementation: run a bucketed
    prefill (prefix cache included) and export the KV. Also the donor
    side of cross-replica prefix reuse (engine/peering.py). Engines with
    an int8 paged pool ship the blob quantized — half the bytes on the
    wire.

    Serialized under one lock around prefill -> gather -> serialize:
    concurrent prefills would race the prefix cache, and the card runs
    them one at a time regardless. The whole call runs without autograd
    (grad mode is per thread; the HTTP handler thread is not the
    engine's). `handler.timings` keeps the last calls' seconds of
    prefill and of gather + serialize, and the blob bytes.
    """
    lock = threading.Lock()
    quantize = bool(getattr(engine, "kv_quantized", False))
    timings: "collections.deque" = collections.deque(maxlen=256)

    def handler(payload: dict) -> bytes:
        from .structured import unpack_mask
        ids = payload["ids"]
        if not isinstance(ids, list) or not ids:
            raise PDError("ids must be a non-empty token list")
        first_mask = unpack_mask(payload.get("first_mask"))
        with lock, torch.no_grad():
            kwargs = {} if first_mask is None \
                else {"first_mask": first_mask}
            if payload.get("adapter") is not None:
                kwargs["adapter"] = payload["adapter"]
            t0 = time.monotonic()
            token, (k, v), true_len, bucket = engine.prefill(
                ids, float(payload.get("temperature", 0.0)),
                int(payload.get("top_k", 0)),
                float(payload.get("top_p", 1.0)), **kwargs)
            t1 = time.monotonic()
            # a tp group's engine gathers every rank's KV heads (its
            # followers join the gather in their pd_export replay)
            gather = getattr(engine, "gather_kv", gather_kv)
            blob = serialize_kv(token, gather(k), gather(v),
                                true_len, bucket, quantize=quantize)
            timings.append({"prefill_s": t1 - t0,
                            "serialize_s": time.monotonic() - t1,
                            "bytes": len(blob), "prompt_tokens": len(ids),
                            "bucket": bucket})
            return blob

    handler.timings = timings
    return handler
