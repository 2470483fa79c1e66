"""The router's backend health state, as the port's PD and peering
clients use it (port of ome_tpu/router/server.py:99-260).

Only what engine/pd.py (`PrefillPool`) and engine/peering.py
(`PrefixPeerClient`) need is copied here: `Backend`, the per-backend
circuit breaker (closed -> open -> half_open with exponential cooldown)
and the `draining` state, and the readiness probes `probe_backend_info`
/ `probe_backend`. The router itself (request forwarding, policies, the
retry budget, the fleet prefix directory) is not part of the port yet;
deployments of the port run the reference's router in front of it.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Optional


class Backend:
    def __init__(self, url: str, pool: str = "engine",
                 cb_threshold: int = 3, cb_cooldown: float = 1.0,
                 cb_max_cooldown: float = 30.0):
        self.url = url.rstrip("/")
        self.pool = pool
        self.healthy = True
        self.inflight = 0
        self.last_checked = 0.0
        # circuit breaker (closed -> open -> half_open -> closed):
        # consecutive REQUEST failures trip it; the health probe does
        # not reset it — only a successful half-open data-path probe
        # closes it again (a flapping /health cannot re-admit a
        # backend that keeps failing live traffic)
        self.cb_threshold = cb_threshold
        self.cb_cooldown = cb_cooldown
        self.cb_max_cooldown = cb_max_cooldown
        self.cb_state = "closed"
        self.cb_open_until = 0.0
        self.fails = 0       # consecutive request failures
        self.cb_trips = 0    # times opened (drives the backoff)
        self._probe_inflight = False
        # half-open probe idempotency: every admitted probe carries a
        # token (minted by begin_probe); a failure verdict charges the
        # breaker AT MOST ONCE per token. Two routers probing the same
        # recovering backend concurrently (multi-replica ingress, or a
        # gossip merge releasing _probe_inflight mid-probe) would
        # otherwise double-charge cb_trips and double the cooldown
        # twice for one real failure.
        self._probe_token = 0     # last token minted
        self._probe_charged = 0   # highest token already charged
        # drain-aware routing: a draining backend (SIGTERM, finishing
        # in-flight work) leaves rotation WITHOUT being a failure —
        # distinct from the breaker's `open` (which punishes) and
        # from healthy=False (which marks it unreachable). Set by the
        # /ready probe and by X-OME-Draining responses; cleared when
        # the probe sees it ready again (rollback / cancelled drain).
        self.draining = False
        # breaker state is self-guarded: Backend now has three owners
        # (Router, pd.PrefillPool, peering.PrefixPeerClient), each
        # serializing under its OWN lock, so the state transitions
        # take this leaf lock rather than trusting any one of them.
        # Callers still hold their owner lock around selection so a
        # pick and its result-note stay paired.
        self._lock = threading.Lock()

    def record_success(self):
        with self._lock:
            self.fails = 0
            self.cb_trips = 0
            self.cb_state = "closed"
            self._probe_inflight = False
            self.healthy = True

    def begin_probe(self) -> int:
        """Admit ONE half-open probe and mint its idempotency token.
        The caller passes the token back to record_failure so a
        duplicate verdict for the same probe is a no-op."""
        with self._lock:
            self._probe_inflight = True
            self._probe_token += 1
            return self._probe_token

    def record_failure(self, now: float,
                       probe_token: Optional[int] = None):
        with self._lock:
            half_open = self.cb_state == "half_open"
            if half_open:
                # idempotency gate: a probe verdict without a token
                # adopts the latest minted one (legacy callers), and a
                # token at or below the charged high-water mark has
                # already been counted — release the slot and return.
                tok = probe_token if probe_token is not None \
                    else self._probe_token
                if tok and tok <= self._probe_charged:
                    self._probe_inflight = False
                    return
                self._probe_charged = max(self._probe_charged, tok)
            self.fails += 1
            self._probe_inflight = False
            if half_open or self.fails >= self.cb_threshold:
                self.cb_trips += 1
                self.cb_state = "open"
                self.cb_open_until = now + min(
                    self.cb_cooldown * (2 ** (self.cb_trips - 1)),
                    self.cb_max_cooldown)

    def selectable(self, now: float) -> bool:
        with self._lock:
            if self.draining:
                return False  # leaving rotation, but NOT a failure
            if self.cb_state == "open":
                if now < self.cb_open_until:
                    return False
                # cooldown over: allow probes
                self.cb_state = "half_open"
            if self.cb_state == "half_open":
                # ONE probe request at a time re-tests the backend
                return not self._probe_inflight
            return self.healthy

    def __repr__(self):
        return f"Backend({self.url}, {self.pool}, " \
               f"{'up' if self.healthy else 'down'}, " \
               f"cb={self.cb_state}" \
               f"{', draining' if self.draining else ''})"


def probe_backend_info(url: str, timeout: float = 5.0):
    """Probe /ready (falling back to /health for pre-readiness
    backends). Returns (healthy, draining, info): a draining replica
    answers /ready with 503 + {"draining": true} while still
    finishing in-flight work — it is HEALTHY but must leave the
    rotation, and re-enters it if a later probe sees 200 again.

    `info` is the parsed /ready JSON body (None when unavailable) —
    the piggyback channel for the fleet prefix directory: replicas
    report the digests of prefixes they recently served
    ("prefix_digests") on the probe the router already makes."""
    url = url.rstrip("/")
    try:
        with urllib.request.urlopen(url + "/ready",
                                    timeout=timeout) as resp:
            ok = resp.status == 200
            try:
                info = json.loads(resp.read() or b"{}")
            except ValueError:
                info = None
            return ok, False, info if isinstance(info, dict) else None
    except urllib.error.HTTPError as e:
        if e.code == 503:
            try:
                info = json.loads(e.read() or b"{}")
            except ValueError:
                info = {}
            e.close()
            if info.get("draining"):
                return True, True, info
            return False, False, None  # not ready for another reason
        e.close()
        if e.code == 404:
            # old backend without /ready: fall back to /health
            try:
                with urllib.request.urlopen(url + "/health",
                                            timeout=timeout) as resp:
                    return resp.status == 200, False, None
            except Exception:
                return False, False, None
        return False, False, None
    except Exception:
        return False, False, None


def probe_backend(url: str, timeout: float = 5.0):
    """(healthy, draining) view of probe_backend_info — the contract
    shared by the router's health loop and the PD decode node's
    prefill pool (engine/pd.py), so every pool in the system applies
    one draining/readiness discipline."""
    healthy, draining, _ = probe_backend_info(url, timeout=timeout)
    return healthy, draining
