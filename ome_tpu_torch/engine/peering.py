"""Cross-replica prefix KV reuse: the fetch side (port of
ome_tpu/engine/peering.py).

The router's fleet prefix directory learns which replica recently
served which prefix. When it places a request on a replica that does
NOT own its prefix, the forward carries an `X-OME-Prefix-Peer` header
naming the owner; this client lets the receiving replica pull the hot
prefix's KV from that peer over the `/pd/prefill` blob path
(engine/pd.py wire format; int8-pool peers ship the blob at half the
bytes) instead of recomputing the whole prefix.

A peer fetch is an OPTIMIZATION, never a dependency: every failure —
connect error, timeout, HTTP 5xx, corrupt blob, open breaker — falls
back to computing the prefix locally. Each peer is tracked with the
router's Backend circuit breaker (router/server.py), so a dead peer
costs `cb_threshold` failed fetches and then nothing until its cooldown
expires. The fetch runs on the scheduler's admission path, never the
decode step path.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Optional, Tuple

from .pd import PDError, deserialize_kv, read_body

# every way a peer fetch can fail that should mean "recompute
# locally" rather than "fail the request"
TRANSIENT_FETCH_ERRORS = (PDError, urllib.error.URLError,
                          TimeoutError, OSError, ValueError, KeyError)


class PrefixPeerClient:
    """Fetch prefix KV blobs from peer replicas, one circuit breaker
    per peer URL (router/server.py Backend reused verbatim — the same
    discipline as the PD prefill pool).

    Thread-safe: admission threads for different requests may fetch
    concurrently; breaker state mutates under one lock. Counters are
    plain ints mirrored into the registry when one is bound
    (`ome_engine_prefix_peer_{fetches,fallbacks}_total`)."""

    def __init__(self, timeout: float = 15.0, cb_threshold: int = 2,
                 cb_cooldown: float = 0.5,
                 cb_max_cooldown: float = 15.0, max_peers: int = 32,
                 registry=None):
        self.timeout = timeout
        self.cb_threshold = cb_threshold
        self.cb_cooldown = cb_cooldown
        self.cb_max_cooldown = cb_max_cooldown
        self.max_peers = max_peers
        self._peers: dict = {}  # url -> router Backend
        self._lock = threading.Lock()
        self.fetches = 0    # successful peer fetches
        self.fallbacks = 0  # fetches that fell back to local compute
        self._c_fetches = None
        self._c_fallbacks = None
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        self._c_fetches = registry.counter(
            "ome_engine_prefix_peer_fetches_total",
            "Prefix KV blobs successfully fetched from a peer replica "
            "over /pd/prefill (cross-replica prefix reuse)")
        self._c_fallbacks = registry.counter(
            "ome_engine_prefix_peer_fallbacks_total",
            "Peer prefix fetches that fell back to local recompute "
            "(open breaker, fetch failure, or corrupt blob)")

    def _backend(self, url: str):
        from ..router.server import Backend
        url = url.rstrip("/")
        with self._lock:
            b = self._peers.get(url)
            if b is None:
                if len(self._peers) >= self.max_peers:
                    # a rogue header cannot grow breaker state without
                    # bound; evict an arbitrary cold entry
                    self._peers.pop(next(iter(self._peers)))
                b = Backend(url, pool="prefix-peer",
                            cb_threshold=self.cb_threshold,
                            cb_cooldown=self.cb_cooldown,
                            cb_max_cooldown=self.cb_max_cooldown)
                self._peers[url] = b
            return b

    def _fallback(self) -> None:
        self.fallbacks += 1
        if self._c_fallbacks is not None:
            self._c_fallbacks.inc()

    def fetch(self, peer_url: str, prompt_ids,
              temperature: float = 0.0, top_k: int = 0,
              top_p: float = 1.0, deadline: Optional[float] = None,
              priority: Optional[str] = None, trace=None
              ) -> Optional[Tuple[int, tuple, int, int]]:
        """Fetch `(token, (k, v), true_len, bucket)` — the exact
        engine.prefill() return shape — from `peer_url`, or None when
        the caller should compute the prefix locally. Never raises on
        peer/transport faults: the fallback IS the contract."""
        from .. import faults
        from ..telemetry import tracing

        if not peer_url.startswith(("http://", "https://")):
            # the header is router-injected, but a direct client can
            # set anything; refuse non-HTTP schemes outright
            self._fallback()
            return None
        peer = self._backend(peer_url)
        now = time.monotonic()
        with self._lock:
            if not peer.selectable(now):
                self._fallback()
                return None
            if peer.cb_state == "half_open":
                peer._probe_inflight = True
        timeout = self.timeout
        if deadline is not None:
            remaining = deadline - now
            if remaining <= 0:
                with self._lock:
                    peer._probe_inflight = False
                self._fallback()
                return None
            timeout = min(timeout, remaining)
        body = json.dumps({
            "ids": list(map(int, prompt_ids)),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "priority": priority,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if priority:
            headers["X-OME-Priority"] = str(priority)
        if trace is not None:
            try:
                headers[tracing.TRACEPARENT_HEADER] = \
                    trace.child().header()
            except Exception:  # noqa: BLE001 — tracing must never
                pass           # fail a fetch
        try:
            # deterministic fault injection: a dropped peer fetch must
            # degrade to local recompute, never to a failed request
            faults.fire("prefix_peer_fetch", key=peer.url, exc=PDError)
            req = urllib.request.Request(
                peer.url + "/pd/prefill", data=body, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = read_body(resp)
            token, k, v, true_len, bucket = deserialize_kv(data)
        except TRANSIENT_FETCH_ERRORS:
            with self._lock:
                # breaker only — never clear `healthy`: that flag is
                # the router's PROBE-driven view, and this client runs
                # no probes, so a cleared flag would disable the peer
                # after ONE transient failure with no way back. The
                # breaker alone gates: open after cb_threshold
                # consecutive failures, half-open probe after cooldown
                peer.record_failure(time.monotonic())
            self._fallback()
            return None
        with self._lock:
            peer.record_success()
        self.fetches += 1
        if self._c_fetches is not None:
            self._c_fetches.inc()
        return token, (k, v), true_len, bucket
