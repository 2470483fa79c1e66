"""The router (port of ome_tpu/router/server.py, the whole file).

An OpenAI-API load balancer in front of the port's engine replicas,
with the reference's policy surface and wire behaviour:

  * backends come from static --backend flags or from Services found
    through the shared client (component selectors, the RouterConfig
    engine-selector / decoder-selector contract; core/kubeclient.py
    lists them from a kube-apiserver);
  * policies: `cache_aware` (rendezvous prefix-hash affinity, so a
    conversation keeps hitting the replica whose KV cache holds its
    prefix), `round_robin`, `random`; pools `engine` and `decoder`;
  * health: background probing of each backend's /ready (the fleet
    prefix directory and the model map ride on its body); a
    per-backend circuit breaker (closed -> open -> half_open with an
    exponential cooldown and one tokened half-open probe) and the
    `draining` state, which leaves rotation without a penalty;
  * retries draw from a token-bucket retry budget with exponential
    backoff and jitter; X-Request-Deadline bounds the upstream wait
    and sheds expired requests with 504; X-OME-Priority and
    traceparent propagate; a forward whose prefix owner is another
    replica carries X-OME-Prefix-Peer (engine/peering.py fetches the
    KV from that owner);
  * streaming passthrough: SSE bodies relay chunk by chunk.

`Backend` and the readiness probes are also used by engine/pd.py
(`PrefillPool`) and engine/peering.py (`PrefixPeerClient`);
`affinity_from_payload` and `prefix_digest` by engine/server.py, so
the digests a replica advertises meet the router's.

    python -m ome_tpu_torch.router --backend http://127.0.0.1:8080 \
        --backend http://127.0.0.1:8081 --policy cache_aware

aserver.py is the asyncio data path over the same policy objects, and
gossip.py shares breaker and prefix observations between replicas.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..priority import DEFAULT_PRIORITY, PRIORITY_CLASSES, coerce_priority
from ..telemetry import Registry, tracing
from ..telemetry.reqlog import coerce as _coerce_reqlog

log = logging.getLogger("ome.router")

_COUNTER_HELP = {
    "requests_total": "Requests received by the router",
    "retries_total": "Backend failures that triggered a failover",
    "no_backend_total": "Requests that exhausted every backend (503)",
    "circuit_open_total": "Circuit-breaker open transitions",
    "retry_budget_exhausted_total":
        "Retries suppressed by the token-bucket budget",
    "deadline_shed_total":
        "Requests shed because their deadline had passed (504)",
    "draining_skips_total":
        "Forwards redirected because the backend announced it was "
        "draining (free failover: no breaker hit, no retry token)",
    "prefix_directory_hits_total":
        "Forwarded requests whose prefix digest the fleet prefix "
        "directory mapped to a replica",
    "prefix_directory_peer_fetches_total":
        "Forwards carrying an X-OME-Prefix-Peer header because the "
        "prefix owner differed from the chosen backend (the backend "
        "fetches the prefix KV from the peer)",
}

_CB_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


class _ClientGone(Exception):
    """The requesting client disconnected; abort without failover."""


class _ResponseStarted(Exception):
    """Backend failed after response bytes reached the client —
    failover would corrupt the stream."""


class _BackendDraining(Exception):
    """Backend answered 503 + X-OME-Draining: it is shutting down
    gracefully. Fail over for free — the backend is HEALTHY, so the
    redirect must not trip its breaker or spend a retry token."""


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


def prefix_digest(affinity_key: str) -> str:
    """Stable short digest of a request's prefix-affinity key — the
    fleet prefix directory's key. Computed identically by the router
    (from affinity_from_payload) and by replicas reporting the
    prefixes they served, so the two sides meet without shipping raw
    prompt text through health probes."""
    return hashlib.blake2b(affinity_key.encode(),
                           digest_size=8).hexdigest()


class PrefixDirectory:
    """Which replica owns which prefix digest — the fleet-scale half
    of cache-aware routing (docs/kv-hierarchy.md). Entries arrive as
    health-probe piggyback (each replica's /ready body lists the
    digests it recently served) and are looked up per forward: when
    the rendezvous-chosen backend differs from the digest's owner,
    the forward carries X-OME-Prefix-Peer so the backend can fetch
    the hot prefix KV from the owner instead of recomputing it.

    LRU-bounded; last reporter wins a digest (the directory tracks
    recency, not truth — a stale entry costs one failed peer fetch
    that falls back to local recompute)."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        import collections
        self._owners: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def update(self, url: str, digests) -> None:
        url = url.rstrip("/")
        if not isinstance(digests, (list, tuple)):
            return
        with self._lock:
            for d in digests:
                if not isinstance(d, str) or not d:
                    continue
                self._owners.pop(d, None)
                self._owners[d] = url
            while len(self._owners) > self.max_entries:
                self._owners.popitem(last=False)

    def forget(self, url: str) -> None:
        """Drop every digest owned by a removed backend."""
        url = url.rstrip("/")
        with self._lock:
            for d in [d for d, u in self._owners.items() if u == url]:
                del self._owners[d]

    def lookup(self, digest: str) -> Optional[str]:
        with self._lock:
            return self._owners.get(digest)

    def export(self) -> List[tuple]:
        """(digest, owner) pairs in LRU order (oldest first) — the
        gossip snapshot's view of the directory. Re-importing via
        update() in this order reproduces the same LRU recency."""
        with self._lock:
            return list(self._owners.items())

    def __len__(self) -> int:
        with self._lock:
            return len(self._owners)


# cold-start math fallback when no engine has advertised a measured
# fetch throughput yet (matches the weight plane's default)
DEFAULT_FETCH_BPS = 256e6


class ModelMap:
    """Which backends serve which model, plus the cold-start catalog —
    the model-aware half of routing (docs/model-fleet.md).

    Two information planes feed it:

      * **advertisements** — every /ready probe (and gossip merge)
        carries the backend's ``models`` list and its measured weight
        ``fetch_bps``; advertisements steer requests whose ``model``
        field names a served model onto the backends serving it;
      * **the catalog** — operator-declared ``{model: {warmup_ms,
        weight_bytes}}`` (the fleet's registered model set, cost-table
        ``warmup_ms`` semantics). A non-empty catalog turns on
        ENFORCEMENT: a model outside catalog+advertisements answers
        404, a known model with no live backend answers 503 with a
        Retry-After derived from ``warmup_ms`` + weight bytes over the
        measured fetch throughput.

    Without a catalog the map only steers — a deployment that never
    declared its model set keeps the legacy any-backend behavior for
    unknown names instead of 404ing them.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._by_url: Dict[str, frozenset] = {}
        self._catalog: Dict[str, Dict] = {}
        self._fetch_bps = 0.0  # EWMA over advertised measurements

    def load_catalog(self, catalog: Dict[str, Dict]):
        with self._lock:
            for name, spec in (catalog or {}).items():
                self._catalog[name] = {
                    "warmup_ms": float(spec.get("warmup_ms", 0.0)),
                    "weight_bytes": int(spec.get("weight_bytes", 0))}

    def advertise(self, url: str, models, fetch_bps=None):
        url = url.rstrip("/")
        if isinstance(models, (list, tuple)):
            served = frozenset(m for m in models
                               if isinstance(m, str) and m)
            with self._lock:
                self._by_url[url] = served
        if isinstance(fetch_bps, (int, float)) and fetch_bps > 0:
            with self._lock:
                self._fetch_bps = (fetch_bps if not self._fetch_bps
                                   else 0.8 * self._fetch_bps
                                   + 0.2 * fetch_bps)

    def forget(self, url: str):
        with self._lock:
            self._by_url.pop(url.rstrip("/"), None)

    def active(self) -> bool:
        with self._lock:
            return bool(self._by_url) or bool(self._catalog)

    def enforcing(self) -> bool:
        with self._lock:
            return bool(self._catalog)

    def cataloged(self, model: str) -> bool:
        with self._lock:
            return model in self._catalog

    def backends_for(self, model: str) -> frozenset:
        with self._lock:
            return frozenset(u for u, ms in self._by_url.items()
                             if model in ms)

    def models_of(self, url: str) -> frozenset:
        with self._lock:
            return self._by_url.get(url.rstrip("/"), frozenset())

    def backend_counts(self) -> Dict[str, int]:
        """{model: advertising-backend count} over catalog + served
        models — the per-model gauge's value set."""
        with self._lock:
            counts = {m: 0 for m in self._catalog}
            for ms in self._by_url.values():
                for m in ms:
                    counts[m] = counts.get(m, 0) + 1
            return counts

    def fetch_bps(self) -> float:
        with self._lock:
            return self._fetch_bps

    def retry_after(self, model: str) -> int:
        """Cold-start wait hint: catalog ``warmup_ms`` plus the time
        to fetch the model's weight bytes at the fleet's measured
        fetch throughput (EWMA of /ready advertisements; a default
        when nothing measured yet). Clamped to [1, 600]s."""
        with self._lock:
            spec = self._catalog.get(model) or {}
            bps = self._fetch_bps or DEFAULT_FETCH_BPS
        seconds = spec.get("warmup_ms", 0.0) / 1000.0 \
            + spec.get("weight_bytes", 0) / bps
        return max(1, min(600, int(seconds + 0.999)))

    def export(self) -> Dict[str, List[str]]:
        """{url: sorted models} — the gossip/debug view."""
        with self._lock:
            return {u: sorted(ms) for u, ms in self._by_url.items()}


class Router:
    def __init__(self, backends: List[Backend],
                 policy: str = "cache_aware",
                 health_interval: float = 10.0,
                 cb_threshold: Optional[int] = None,
                 cb_cooldown: Optional[float] = None,
                 registry: Optional[Registry] = None,
                 clock=time.monotonic):
        self.backends = backends
        # the time source the selection/breaker path reads (pick,
        # note_result, check_health_once); a test can inject its own
        # clock so breaker cooldowns elapse without waiting
        self._clock = clock
        for b in backends:  # router-level CB settings apply uniformly
            if cb_threshold is not None:
                b.cb_threshold = cb_threshold
            if cb_cooldown is not None:
                b.cb_cooldown = cb_cooldown
        self.policy = policy
        self.health_interval = health_interval
        self._rr = itertools.count()
        self._rng = random.Random(0)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # every stat lives in the shared registry (leaf-locked
        # counters), so mutation is uniformly guarded — no more
        # direct dict bumps racing handler threads
        self.registry = registry or Registry()
        self._counters = {
            key: self.registry.counter(f"ome_router_{key}", help)
            for key, help in _COUNTER_HELP.items()}
        self._g_backends_up = self.registry.gauge(
            "ome_router_backends_up", "Backends passing health checks")
        self._g_backend_healthy = self.registry.gauge(
            "ome_router_backend_healthy",
            "Per-backend health bit (1 healthy)",
            labelnames=("backend", "pool"))
        self._g_backend_cb = self.registry.gauge(
            "ome_router_backend_circuit_state",
            "Per-backend breaker state: 0 closed, 1 half-open, 2 open",
            labelnames=("backend", "pool"))
        self._g_backends_draining = self.registry.gauge(
            "ome_router_backends_draining",
            "Backends currently draining (out of rotation, healthy)")
        self._g_backend_draining = self.registry.gauge(
            "ome_router_backend_draining",
            "Per-backend draining bit (1 draining)",
            labelnames=("backend", "pool"))
        self._g_backend_inflight = self.registry.gauge(
            "ome_router_backend_inflight",
            "Requests currently forwarded to this backend",
            labelnames=("backend", "pool"))
        # (url, pool) pairs exported on the last scrape — a removed
        # backend's gauges are zeroed once instead of lingering at
        # their final values forever (the registry has no child
        # removal, and a stale draining=1 would confuse autoscaling)
        self._gauge_keys: set = set()
        # fleet prefix directory: digest -> owning replica, fed by the
        # health probes' /ready piggyback, consulted per forward to
        # name a KV donor peer (cross-replica prefix reuse)
        self.prefix_directory = PrefixDirectory()
        self._g_prefix_dir = self.registry.gauge(
            "ome_router_prefix_directory_entries",
            "Prefix digests currently tracked by the fleet prefix "
            "directory")
        # per-class terminal outcomes at the front door — the SLO
        # rollup's availability signal (docs/slo.md). Children are
        # pre-created over the two fixed enums so cardinality is
        # bounded by construction.
        _fam_outcomes = self.registry.counter(
            "ome_router_class_outcomes_total",
            "Terminal request outcomes by priority class (ok = "
            "answered, including 4xx relays; error = 5xx/timeout/"
            "transport failures)",
            labelnames=("class", "result"))
        self._c_outcomes = {
            (cls, res): _fam_outcomes.labels(
                **{"class": cls, "result": res})
            for cls in PRIORITY_CLASSES
            for res in ("ok", "error")}
        # model-aware routing (docs/model-fleet.md): backend map fed
        # by /ready advertisements + gossip, catalog fed by
        # --model-catalog; per-model metric cardinality is bounded by
        # that operator-declared set plus what the fleet advertises
        self.model_map = ModelMap()
        self._c_model_requests = self.registry.counter(
            "ome_router_model_requests_total",
            "Requests routed by model field, per known model",
            labelnames=("model",))
        self._c_model_cold = self.registry.counter(
            "ome_router_model_cold_total",
            "Requests answered 503 + Retry-After because the model "
            "is known but has no live backend (cold start)",
            labelnames=("model",))
        self._c_model_unknown = self.registry.counter(
            "ome_router_model_unknown_total",
            "Requests answered 404 because the model is neither "
            "cataloged nor advertised by any backend")
        self._g_model_backends = self.registry.gauge(
            "ome_router_model_backends",
            "Backends currently advertising each model",
            labelnames=("model",))
        self._model_gauge_keys: set = set()

    @property
    def stats(self) -> Dict[str, float]:
        """Read-only snapshot of the registry-backed counters (the
        pre-telemetry dict API; mutate via inc(), never this view)."""
        return {key: c.value for key, c in self._counters.items()}

    def inc(self, key: str, by: float = 1):
        c = self._counters.get(key)
        if c is None:  # late-declared stat (tests, extensions)
            c = self._counters.setdefault(
                key, self.registry.counter(f"ome_router_{key}"))
        c.inc(by)

    def update_gauges(self):
        """Refresh the per-backend gauges (scrape-time; the breaker
        and health bits otherwise only change on traffic/probes)."""
        up = 0
        draining = 0
        with self._lock:
            views = [(b.url, b.pool, b.healthy, b.cb_state,
                      b.draining, b.inflight) for b in self.backends]
        seen = set()
        for url, pool, healthy, cb_state, drain, infl in views:
            up += bool(healthy)
            draining += bool(drain)
            seen.add((url, pool))
            self._g_backend_healthy.labels(
                backend=url, pool=pool).set(1 if healthy else 0)
            self._g_backend_cb.labels(backend=url, pool=pool).set(
                _CB_STATE_VALUE.get(cb_state, 2))
            self._g_backend_draining.labels(
                backend=url, pool=pool).set(1 if drain else 0)
            self._g_backend_inflight.labels(
                backend=url, pool=pool).set(infl)
        with self._lock:
            stale = self._gauge_keys - seen
            self._gauge_keys = seen
        for url, pool in stale:
            for g in (self._g_backend_healthy, self._g_backend_cb,
                      self._g_backend_draining,
                      self._g_backend_inflight):
                g.labels(backend=url, pool=pool).set(0)
        self._g_backends_up.set(up)
        self._g_backends_draining.set(draining)
        self._g_prefix_dir.set(len(self.prefix_directory))
        counts = self.model_map.backend_counts()
        for model, n in counts.items():
            # model names come from the operator catalog + engine
            # /ready advertisements, never from client payloads
            self._g_model_backends.labels(model=model).set(n)  # omelint: disable=metrics-label-cardinality -- catalog/advertised model names only, bounded by fleet config
        model_seen = set(counts)
        with self._lock:
            stale_models = self._model_gauge_keys - model_seen
            self._model_gauge_keys = model_seen
        for model in stale_models:
            self._g_model_backends.labels(model=model).set(0)  # omelint: disable=metrics-label-cardinality -- zeroing series created from the bounded catalog/advertised set above

    # -- membership ----------------------------------------------------
    # The autoscale controller's registration surface (POST/DELETE
    # /backends on RouterServer). Pure list mutation under _lock —
    # callers probe readiness BEFORE registering, so a freshly added
    # backend enters rotation immediately and the next health sweep
    # keeps it honest.

    def add_backend(self, url: str, pool: str = "engine") -> Backend:
        """Register a backend (idempotent on URL). Re-adding an
        existing URL cancels any drain — the autoscale controller
        re-registers a replica whose scale-down it aborted."""
        u = url.rstrip("/")
        with self._lock:
            for b in self.backends:
                if b.url == u:
                    b.draining = False
                    return b
            b = Backend(u, pool)
            self.backends.append(b)
            return b

    def remove_backend(self, url: str) -> bool:
        """Drop a backend from the set (after its drain completed).
        In-flight forwards hold their own Backend reference, so a
        racing request finishes normally; the backend simply cannot
        be picked again."""
        u = url.rstrip("/")
        with self._lock:
            for i, b in enumerate(self.backends):
                if b.url == u:
                    del self.backends[i]
                    self.prefix_directory.forget(u)
                    self.model_map.forget(u)
                    return True
        return False

    def backend_snapshot(self) -> List[dict]:
        """Consistent machine-readable view of the backend set (the
        GET /backends body; what the controller polls instead of
        parsing text exposition)."""
        with self._lock:
            return [{"url": b.url, "pool": b.pool,
                     "healthy": b.healthy, "draining": b.draining,
                     "inflight": b.inflight, "cb_state": b.cb_state}
                    for b in self.backends]

    # -- selection -----------------------------------------------------

    def _alive(self, pool: str) -> List[Backend]:
        with self._lock:
            return [b for b in self.backends
                    if b.pool == pool and b.healthy and not b.draining]

    def pick(self, pool: str, affinity_key: str = "",
             exclude: Optional[set] = None,
             model: Optional[str] = None) -> Optional[Backend]:
        # model steering: when the request names a model the fleet
        # serves, only backends advertising it are candidates
        allowed = (self.model_map.backends_for(model)
                   if model else None)
        now = self._clock()
        with self._lock:
            alive = [b for b in self.backends
                     if b.pool == pool and b.selectable(now)
                     and (not exclude or b.url not in exclude)
                     and (allowed is None or b.url in allowed)]
            if not alive:
                return None
            if self.policy == "random":
                chosen = self._rng.choice(alive)
            elif self.policy == "cache_aware" and affinity_key:
                # rendezvous (highest-random-weight) hashing: stable
                # under backend set changes, no ring state
                def weight(b: Backend) -> int:
                    return int.from_bytes(hashlib.blake2b(
                        f"{affinity_key}|{b.url}".encode(),
                        digest_size=8).digest(), "big")
                chosen = max(alive, key=weight)
            else:
                chosen = alive[next(self._rr) % len(alive)]
            if chosen.cb_state == "half_open":
                chosen.begin_probe()
            return chosen

    def note_result(self, backend: Backend, ok: bool):
        """Feed a request outcome into the backend's circuit breaker
        (and the boolean health bit the /health view exposes)."""
        opened = False
        with self._lock:
            if ok:
                backend.record_success()
            else:
                was_open = backend.cb_state == "open"
                backend.record_failure(self._clock())
                backend.healthy = False
                opened = backend.cb_state == "open" and not was_open
        if opened:
            # same registry-counter path as every other stat bump
            # (leaf-locked; kept outside _lock for uniformity)
            self.inc("circuit_open_total")

    def note_outcome(self, cls: str, ok: bool):
        """Record one terminal per-class request outcome — the SLO
        availability signal (docs/slo.md). client_gone outcomes are
        never reported here: the backend did nothing wrong and the
        client saw nothing, so they belong to neither side of the
        budget."""
        child = self._c_outcomes.get((cls, "ok" if ok else "error"))
        if child is not None:
            child.inc()

    def classify_model(self, model: str):
        """Route verdict for a request's ``model`` field:

        * ``("off", None)`` — model routing inactive for this name
          (no advertisements/catalog at all, or the name is unknown
          and no catalog demands enforcement): legacy any-backend;
        * ``("serving", urls)`` — at least one selectable backend
          advertises it: steer onto ``urls``;
        * ``("cold", urls)`` — known (cataloged, or advertised but
          every advertiser gone): 503 + Retry-After;
        * ``("unknown", None)`` — catalog enforcement on and the name
          is neither cataloged nor advertised: 404.
        """
        mm = self.model_map
        if not mm.active():
            return "off", None
        urls = mm.backends_for(model)
        if urls:
            now = self._clock()
            with self._lock:
                live = any(b.url in urls and b.selectable(now)
                           for b in self.backends)
            if live:
                return "serving", urls
            return "cold", urls
        if mm.cataloged(model):
            return "cold", frozenset()
        if mm.enforcing():
            return "unknown", None
        return "off", None

    def note_model_request(self, model: str):
        # only called on a "serving" verdict, so the label set is the
        # advertised-model universe — an arbitrary client-sent name
        # gets 404/off and never reaches a labeled series
        self._c_model_requests.labels(model=model).inc()  # omelint: disable=metrics-label-cardinality -- serving verdict gate bounds values to advertised models

    def note_model_cold(self, model: str):
        self._c_model_cold.labels(model=model).inc()  # omelint: disable=metrics-label-cardinality -- cold verdict gate bounds values to cataloged/advertised models

    def note_model_unknown(self):
        self._c_model_unknown.inc()

    def note_draining(self, backend: Backend):
        """The backend announced it is draining (503 + X-OME-Draining).
        Take it out of rotation WITHOUT penalty: the drain is
        deliberate, not a fault, so the breaker and the health bit are
        untouched — the /ready probe re-admits it if the drain is
        cancelled. Also releases a half-open probe slot so the drain
        cannot wedge the breaker."""
        with self._lock:
            backend.draining = True
            backend._probe_inflight = False

    def probe_aborted(self, backend: Backend):
        """A half-open probe request ended without a backend verdict
        (e.g. the CLIENT disconnected mid-probe). Release the probe
        slot; otherwise _probe_inflight stays latched and the backend
        can never be re-tested — it is wedged out of rotation until
        process restart."""
        with self._lock:
            backend._probe_inflight = False

    def adjust_inflight(self, backend: Backend, delta: int):
        """Bump a backend's in-flight counter under the router lock.
        Handler threads are concurrent (ThreadingHTTPServer): a bare
        ``backend.inflight += 1`` on the forwarding path is a
        read-modify-write that loses updates under contention and
        drifts the counter permanently."""
        with self._lock:
            backend.inflight += delta

    # -- health --------------------------------------------------------

    def check_health_once(self):
        with self._lock:
            targets = list(self.backends)
        for b in targets:
            res = self._probe_backend(b)
            # test overrides return the legacy (healthy, draining)
            # pair; the default carries the /ready body as a third
            # element — the prefix-directory piggyback
            healthy, draining = res[0], res[1]
            info = res[2] if len(res) > 2 else None
            with self._lock:
                b.healthy = healthy
                b.draining = draining
                b.last_checked = self._clock()
            if isinstance(info, dict):
                self.prefix_directory.update(
                    b.url, info.get("prefix_digests"))
                # model advertisement piggyback: which models this
                # backend serves + its measured weight-fetch
                # throughput (the Retry-After math's denominator)
                self.model_map.advertise(
                    b.url, info.get("models"),
                    info.get("fetch_bps"))

    @staticmethod
    def _probe_backend(b: Backend):
        return probe_backend_info(b.url)

    def start_health_loop(self):
        def loop():
            while not self._stop.wait(self.health_interval):
                self.check_health_once()
        self._health_thread = threading.Thread(
            target=loop, name="router-health", daemon=True)
        self._health_thread.start()

    def stop(self):
        self._stop.set()


class RetryBudget:
    """Finagle-style token bucket bounding retry amplification: each
    incoming request deposits `ratio` tokens (plus a small constant
    burst floor to keep single-request failover working at low
    traffic); each retry withdraws one. A pool-wide outage therefore
    costs at most (1 + ratio) x offered load, not retries x load."""

    def __init__(self, ratio: float = 0.2, burst: float = 10.0):
        self.ratio = ratio
        self.burst = burst
        self._tokens = burst
        self._lock = threading.Lock()

    def deposit(self):
        with self._lock:
            self._tokens = min(self._tokens + self.ratio,
                               self.burst)

    def withdraw(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


def affinity_from_payload(payload: dict) -> str:
    """Prefix-affinity key: the leading content of the request, so a
    continuing conversation maps to the replica already holding its
    KV prefix."""
    if "prompt" in payload:
        p = payload["prompt"]
        p = p if isinstance(p, str) else "".join(map(str, p))
        return p[:256]
    msgs = payload.get("messages")
    if msgs:
        return json.dumps(msgs[:2])[:256]
    return ""


class RouterServer:
    def __init__(self, router: Router, host: str = "0.0.0.0",
                 port: int = 0, retries: int = 2,
                 retry_backoff: float = 0.05,
                 retry_budget_ratio: float = 0.2,
                 request_log=None, span_log=None,
                 debug_endpoints: bool = False):
        self.router = router
        self.retries = retries
        self.retry_backoff = retry_backoff
        # gates the introspection/admin surface (GET/POST/DELETE
        # /backends), same contract as the engine's /debug/state:
        # off by default, 403 when disabled
        self.debug_endpoints = debug_endpoints
        # fleet SLO rollup (docs/slo.md): attached by main() when
        # --slo-spec is given; GET /slo answers 404 until then
        self.slo_rollup = None
        self.budget = RetryBudget(ratio=retry_budget_ratio)
        self._jitter = random.Random(1)
        self.request_log = _coerce_reqlog(request_log)
        # span timeline (docs/tracing-timeline.md): one router.request
        # root span per proxied request plus one router.attempt span
        # per forward — the attempt's span id IS the traceparent child
        # the backend receives, so engine spans nest under the exact
        # attempt that carried them
        self.span_log = tracing.coerce_span_log(span_log,
                                                component="router")
        self._h_request = router.registry.histogram(
            "ome_router_request_seconds",
            "End-to-end proxied request seconds (retries included)")
        # per-class accounting at the front door: children are
        # pre-created from the fixed class enum so a hostile header
        # can never mint new label values (cardinality stays bounded)
        _fam_class = router.registry.counter(
            "ome_router_class_requests_total",
            "Completion requests proxied, by priority class",
            labelnames=("class",))
        self._c_class = {c: _fam_class.labels(**{"class": c})
                         for c in PRIORITY_CLASSES}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code: int, obj, headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _backends_guard(self) -> bool:
                """403 unless --debug-endpoints enabled the admin
                surface; True when the caller may proceed."""
                if outer.debug_endpoints:
                    return True
                self._json(403, {"error": "debug endpoints disabled "
                                          "(enable --debug-endpoints)"})
                return False

            def do_GET(self):
                if self.path in ("/health", "/healthz"):
                    snap = outer.router.backend_snapshot()
                    up = any(b["healthy"] for b in snap)
                    return self._json(200 if up else 503, {
                        "status": "ok" if up else "no healthy backends",
                        "backends": [
                            {k: b[k] for k in
                             ("url", "pool", "healthy", "draining")}
                            for b in snap]})
                if self.path == "/backends":
                    # machine-readable pool membership for the
                    # autoscale controller and tests (guarded like the
                    # engine's /debug/state)
                    if not self._backends_guard():
                        return None
                    return self._json(200, {
                        "backends": outer.router.backend_snapshot()})
                if self.path == "/slo":
                    # fleet SLO attainment / budget / alert state
                    # (docs/slo.md), guarded like /backends
                    if not self._backends_guard():
                        return None
                    if outer.slo_rollup is None:
                        return self._json(404, {
                            "error": "slo rollup not configured "
                                     "(start with --slo-spec)"})
                    return self._json(200, outer.slo_rollup.report())
                if self.path == "/metrics":
                    outer.router.update_gauges()
                    body = outer.router.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    return self.wfile.write(body)
                # pass through model listings etc. to any backend
                return self._proxy(b"", stream=False)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                if self.path == "/backends":
                    return self._backends_mutate(body, add=True)
                try:
                    payload = json.loads(body or b"{}")
                except ValueError:
                    payload = {}
                cls = None
                if self.path in ("/v1/completions",
                                 "/v1/chat/completions"):
                    # account the class here but forward the request
                    # verbatim: an unknown value counts as the default
                    # class and the ENGINE answers the 400 (the router
                    # never rewrites or silently drops tenant intent)
                    try:
                        cls = coerce_priority(
                            self.headers.get("X-OME-Priority")
                            or payload.get("priority"))
                    except ValueError:
                        cls = DEFAULT_PRIORITY
                    outer._c_class[cls].inc()
                stream = bool(payload.get("stream"))
                mdl = payload.get("model")
                self._proxy(body, stream=stream,
                            affinity=affinity_from_payload(payload),
                            cls=cls,
                            model=mdl if isinstance(mdl, str) else None)

            def do_DELETE(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                if self.path == "/backends":
                    return self._backends_mutate(body, add=False)
                return self._json(404, {"error": "not found"})

            def _backends_mutate(self, body: bytes, add: bool):
                """POST /backends {"url":..,"pool":..} registers a
                backend; DELETE /backends {"url":..} removes one.
                The autoscale pool calls these after spawning a ready
                engine / after a drained engine exits."""
                if not self._backends_guard():
                    return None
                try:
                    payload = json.loads(body or b"{}")
                except ValueError:
                    payload = {}
                url = payload.get("url")
                if not url:
                    return self._json(400, {"error": "missing 'url'"})
                if add:
                    b = outer.router.add_backend(
                        url, payload.get("pool") or "engine")
                    return self._json(200, {
                        "ok": True, "url": b.url, "pool": b.pool})
                removed = outer.router.remove_backend(url)
                return self._json(200 if removed else 404, {
                    "ok": removed, "url": url.rstrip("/")})

            def _pick_pool(self) -> str:
                # explicit steer via header; else engine pool, falling
                # back to decoders when no engine is configured/healthy
                want = (self.headers.get("X-OME-Pool") or "engine")
                if outer.router._alive(want):
                    return want
                other = "decoder" if want == "engine" else "engine"
                return other if outer.router._alive(other) else want

            def _deadline(self) -> Optional[float]:
                """X-Request-Deadline: absolute epoch seconds."""
                hdr = self.headers.get("X-Request-Deadline")
                if not hdr:
                    return None
                try:
                    return float(hdr)
                except ValueError:
                    return None

            def _proxy(self, body: bytes, stream: bool,
                       affinity: str = "",
                       cls: Optional[str] = None,
                       model: Optional[str] = None):
                # request-lifecycle tracing: adopt the caller's
                # traceparent or mint a fresh trace; every forwarded
                # hop carries a CHILD span of this context, and both
                # router and engine request logs share the trace id
                ctx = tracing.from_headers(self.headers)
                t0 = time.monotonic()
                outcome = {"backend": None, "pool": None,
                           "status": "error", "retries": 0,
                           "class": cls}
                # root timeline span: reuses the context's span id, so
                # per-attempt child spans (and through them the engine
                # spans) all parent on this one record
                span = None
                if outer.span_log.enabled:
                    span = tracing.Span("router.request",
                                        trace_id=ctx.trace_id,
                                        span_id=ctx.span_id,
                                        start_mono=t0)
                    span.set(path=self.path)
                try:
                    return self._route(body, stream, affinity, ctx,
                                       outcome, model=model)
                finally:
                    dur = time.monotonic() - t0
                    outer._h_request.observe(dur)
                    if cls is not None \
                            and outcome["status"] != "client_gone":
                        # availability: everything the router answered
                        # is good except its own failure statuses
                        outer.router.note_outcome(
                            cls, outcome["status"] == "ok")
                    if span is not None:
                        span.set(pool=outcome["pool"],
                                 backend=outcome["backend"],
                                 status=outcome["status"],
                                 retries=outcome["retries"])
                        span.end(t0 + dur)
                        outer.span_log.write(span)
                    if outer.request_log.enabled:
                        outer.request_log.write({
                            "component": "router",
                            "trace_id": ctx.trace_id,
                            "span_id": ctx.span_id,
                            "path": self.path,
                            "pool": outcome["pool"],
                            "backend": outcome["backend"],
                            "status": outcome["status"],
                            "retries": outcome["retries"],
                            "duration_s": round(dur, 6)})

            def _route(self, body: bytes, stream: bool, affinity: str,
                       ctx, outcome: dict,
                       model: Optional[str] = None):
                outer.router.inc("requests_total")
                outer.budget.deposit()
                deadline = self._deadline()
                # model-aware gate (docs/model-fleet.md): unknown
                # model 404s, a known-but-cold model answers 503 with
                # a Retry-After the weight plane's measured fetch
                # throughput backs — the client knows when to retry
                # instead of hammering a fleet that is still fetching
                if model:
                    verdict, _ = outer.router.classify_model(model)
                    if verdict == "unknown":
                        outer.router.note_model_unknown()
                        outcome["status"] = "unknown_model"
                        return self._json(404, {
                            "error": f"model {model!r} is not served "
                                     "by this fleet",
                            "model": model})
                    if verdict == "cold":
                        ra = outer.router.model_map.retry_after(model)
                        outer.router.note_model_cold(model)
                        if outer.span_log.enabled:
                            cspan = tracing.Span(
                                "router.cold_start",
                                trace_id=ctx.trace_id,
                                parent_id=ctx.span_id)
                            cspan.set(model=model, retry_after=ra)
                            outer.span_log.write(cspan)
                        outcome["status"] = "cold_start"
                        return self._json(503, {
                            "error": f"model {model!r} is cold "
                                     "(no live backend yet)",
                            "model": model, "retry_after": ra},
                            headers={"Retry-After": str(ra)})
                    if verdict == "serving":
                        outer.router.note_model_request(model)
                    else:
                        model = None  # routing off for this name
                pool = self._pick_pool()
                outcome["pool"] = pool
                # fleet prefix directory: if some replica owns this
                # request's prefix, remember it — a forward landing
                # ELSEWHERE names the owner as a KV donor peer
                peer_hint = None
                if affinity and outer.router.policy == "cache_aware":
                    peer_hint = outer.router.prefix_directory.lookup(
                        prefix_digest(affinity))
                    if peer_hint is not None:
                        outer.router.inc("prefix_directory_hits_total")
                tried: set = set()
                last_err = "no healthy backends"
                # `failures` counts TRANSPORT failures only; a draining
                # redirect is free (no retry token, no backoff, no
                # breaker hit). Terminates regardless: every iteration
                # adds the picked backend to `tried`, and pick()
                # excludes tried backends.
                failures = 0
                need_backoff = False
                while failures <= outer.retries:
                    if deadline is not None and time.time() >= deadline:
                        # the client stopped caring: do not burn a
                        # backend slot (or a retry token) on it
                        outer.router.inc("deadline_shed_total")
                        outcome["status"] = "deadline"
                        return self._json(504, {
                            "error": "request deadline exceeded"})
                    if need_backoff:
                        need_backoff = False
                        if not outer.budget.withdraw():
                            # retry budget exhausted: fail fast rather
                            # than amplify a pool-wide outage
                            outer.router.inc(
                                "retry_budget_exhausted_total")
                            break
                        delay = (outer.retry_backoff
                                 * (2 ** (failures - 1))
                                 * (1 + outer._jitter.random()))
                        time.sleep(delay)
                    backend = outer.router.pick(pool, affinity,
                                                exclude=tried,
                                                model=model)
                    if backend is None:
                        break
                    tried.add(backend.url)
                    outcome["backend"] = backend.url
                    outcome["retries"] = failures
                    # the child context is minted BEFORE the forward so
                    # the attempt span can claim its span id — engine
                    # records parenting on the forwarded traceparent
                    # then nest under this exact attempt
                    child = ctx.child()
                    aspan = None
                    if outer.span_log.enabled:
                        aspan = tracing.Span("router.attempt",
                                             trace_id=ctx.trace_id,
                                             parent_id=ctx.span_id,
                                             span_id=child.span_id)
                        aspan.set(backend=backend.url,
                                  retries=failures)
                    try:
                        result = self._forward(
                            backend, body, stream, deadline,
                            trace=child,
                            prefix_peer=(peer_hint
                                         if peer_hint != backend.url
                                         else None))
                        outer.router.note_result(backend, ok=True)
                        outcome["status"] = "ok"
                        if aspan is not None:
                            outer.span_log.write(aspan.set(status="ok"))
                        return result
                    except _BackendDraining:
                        # deliberate shutdown, not a fault: take the
                        # backend out of rotation and move on without
                        # touching the breaker or the retry budget
                        outer.router.note_draining(backend)
                        outer.router.inc("draining_skips_total")
                        log.info("backend %s draining; redirecting",
                                 backend.url)
                        if aspan is not None:
                            outer.span_log.write(
                                aspan.set(status="draining"))
                        continue
                    except _ClientGone:
                        # the CLIENT went away: nothing to retry, and
                        # the backend did nothing wrong — but release
                        # its half-open probe slot if this was a probe
                        outer.router.probe_aborted(backend)
                        outcome["status"] = "client_gone"
                        if aspan is not None:
                            outer.span_log.write(
                                aspan.set(status="client_gone"))
                        return None
                    except _ResponseStarted as e:
                        # bytes already reached the client: a retry
                        # would interleave two responses on one socket
                        outer.router.note_result(backend, ok=False)
                        log.warning("backend %s died mid-response: %s",
                                    backend.url, e)
                        try:
                            self.wfile.write(b"0\r\n\r\n")
                        except OSError:
                            pass
                        self.close_connection = True
                        outcome["status"] = "stream_abort"
                        if aspan is not None:
                            outer.span_log.write(
                                aspan.set(status="stream_abort"))
                        return None
                    except (urllib.error.URLError, OSError,
                            ConnectionError) as e:
                        last_err = str(e)
                        outer.router.note_result(backend, ok=False)
                        outer.router.inc("retries_total")
                        log.warning("backend %s failed (%s); retrying",
                                    backend.url, e)
                        if aspan is not None:
                            outer.span_log.write(aspan.set(
                                status="error", error=str(e)))
                        failures += 1
                        need_backoff = True
                outer.router.inc("no_backend_total")
                outcome["status"] = "no_backend"
                self._json(503, {"error": f"routing failed: {last_err}"},
                           headers={"Retry-After": "1"})

            def _client_write(self, data: bytes):
                try:
                    self.wfile.write(data)
                except (OSError, ConnectionError) as e:
                    raise _ClientGone(str(e)) from e

            def _forward(self, backend: Backend, body: bytes,
                         stream: bool, deadline: Optional[float] = None,
                         trace=None, prefix_peer: Optional[str] = None):
                from .. import faults

                # deterministic fault injection: an armed rule makes
                # this backend look connection-dead (URLError), which
                # exercises failover + the circuit breaker
                faults.fire("router_forward", key=backend.url,
                            exc=urllib.error.URLError)
                headers = {"Content-Type": "application/json"}
                if trace is not None:
                    headers[tracing.TRACEPARENT_HEADER] = trace.header()
                pri = self.headers.get("X-OME-Priority")
                if pri:
                    # the priority class propagates like the deadline:
                    # the engine's admission/scheduling decisions need
                    # the tenant class the client declared
                    headers["X-OME-Priority"] = pri
                if prefix_peer:
                    # cross-replica prefix reuse: the chosen backend
                    # does not own this prefix — name the replica that
                    # does, so it can fetch the KV over /pd/prefill
                    # (engine/peering.py) instead of recomputing it
                    headers["X-OME-Prefix-Peer"] = prefix_peer
                    outer.router.inc(
                        "prefix_directory_peer_fetches_total")
                timeout = 600.0
                if deadline is not None:
                    # propagate the client deadline downstream and
                    # bound our own wait by it
                    headers["X-Request-Deadline"] = repr(deadline)
                    timeout = max(min(timeout,
                                      deadline - time.time()), 0.05)
                req = urllib.request.Request(
                    backend.url + self.path, data=body or None,
                    method=self.command, headers=headers)
                outer.router.adjust_inflight(backend, 1)
                try:
                    resp = urllib.request.urlopen(req, timeout=timeout)
                except urllib.error.HTTPError as e:
                    if e.code == 503 and e.headers.get("X-OME-Draining"):
                        # graceful shutdown announcement, not a fault
                        e.close()
                        raise _BackendDraining(backend.url) from e
                    if e.code >= 500:
                        # a 5xx is a BACKEND failure (dead scheduler,
                        # injected fault): close the response and let
                        # the retry loop fail over + trip the breaker
                        e.close()
                        raise urllib.error.URLError(
                            f"backend returned {e.code}") from e
                    # 4xx are APPLICATION responses (bad request,
                    # model not found, 429 overload): relay verbatim,
                    # Retry-After included, don't failover
                    data = e.read()
                    self.send_response(e.code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    ra = e.headers.get("Retry-After")
                    if ra:
                        self.send_header("Retry-After", ra)
                    self.end_headers()
                    self._client_write(data)
                    return None
                finally:
                    outer.router.adjust_inflight(backend, -1)
                with resp:
                    if stream:
                        self.send_response(resp.status)
                        self.send_header("Content-Type",
                                         resp.headers.get("Content-Type",
                                                          "text/event-stream"))
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        started = True
                        # real SSE clients (the replay client
                        # included) hang up the moment they read the
                        # `data: [DONE]` sentinel, without draining
                        # the trailing blank line or the chunked
                        # terminator — once the sentinel is delivered
                        # the request was SERVED, and classifying it
                        # client_gone would poison the availability
                        # SLO (docs/slo.md)
                        done_sent = False
                        while True:
                            try:
                                raw = resp.readline()
                            except (urllib.error.URLError, OSError,
                                    ConnectionError) as e:
                                raise _ResponseStarted(str(e)) from e
                            if not raw:
                                break
                            try:
                                self._client_write(
                                    f"{len(raw):x}\r\n".encode() + raw
                                    + b"\r\n")
                                self.wfile.flush()
                            except (_ClientGone, OSError,
                                    ConnectionError) as e:
                                if done_sent:
                                    break
                                if isinstance(e, _ClientGone):
                                    raise
                                raise _ClientGone(str(e)) from e
                            if raw.strip() == b"data: [DONE]":
                                done_sent = True
                        try:
                            self._client_write(b"0\r\n\r\n")
                        except _ClientGone:
                            # upstream is drained and every body byte
                            # was relayed: a client that hangs up
                            # between the last event and the
                            # terminating chunk still received the
                            # whole response — served, not abandoned
                            pass
                        return None
                    try:
                        data = resp.read()
                    except (urllib.error.URLError, OSError,
                            ConnectionError) as e:
                        # nothing sent to the client yet: retryable
                        raise urllib.error.URLError(str(e)) from e
                    self.send_response(resp.status)
                    self.send_header("Content-Type",
                                     resp.headers.get("Content-Type",
                                                      "application/json"))
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self._client_write(data)
                    return None

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RouterServer":
        self.router.start_health_loop()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="ome-router", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.router.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.request_log.close()
        self.span_log.close()


def discover_backends(client, namespace: str, selector: Dict[str, str],
                      pool: str, port: int = 8080) -> List[Backend]:
    """Service discovery through the shared client: Services matching
    the selector labels become backends at their cluster DNS names
    (the RouterConfig engine-selector/decoder-selector contract)."""
    from ..core.k8s import Service
    out = []
    for svc in client.list(Service, namespace=namespace,
                           label_selector=selector):
        svc_port = port
        if svc.spec.ports:
            svc_port = svc.spec.ports[0].port
        out.append(Backend(
            f"http://{svc.metadata.name}.{svc.metadata.namespace}"
            f".svc.cluster.local:{svc_port}", pool))
    return out


def _parse_selector(s: str) -> Dict[str, str]:
    return dict(kv.split("=", 1) for kv in s.split(",") if "=" in kv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ome-router")
    p.add_argument("--backend", action="append", default=[],
                   help="engine URL (repeatable); pool prefix with "
                        "'decoder=' routes to the decode pool")
    p.add_argument("--policy", default="cache_aware",
                   choices=("cache_aware", "round_robin", "random"))
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--health-interval", type=float, default=10.0)
    p.add_argument("--retries", type=int, default=2,
                   help="max failover attempts per request (budgeted: "
                        "retries also draw from a token bucket "
                        "replenished by request volume)")
    p.add_argument("--retry-backoff", type=float, default=0.05,
                   help="base delay before retry N doubles from here, "
                        "with jitter")
    p.add_argument("--cb-threshold", type=int, default=3,
                   help="consecutive request failures that open a "
                        "backend's circuit breaker")
    p.add_argument("--cb-cooldown", type=float, default=1.0,
                   help="initial circuit-open cooldown seconds "
                        "(doubles per trip, capped at 30s); a single "
                        "half-open probe re-admits the backend")
    p.add_argument("--faults", default=None,
                   help="deterministic fault-injection spec "
                        "(faults.py grammar); also via "
                        "OME_FAULTS")
    p.add_argument("--debug-endpoints", action="store_true",
                   help="enable the guarded admin surface: GET "
                        "/backends (machine-readable membership) and "
                        "POST/DELETE /backends (autoscale "
                        "registration); 403 otherwise")
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
    p.add_argument("--request-log", default=None,
                   help="JSONL request-log path (one record per "
                        "proxied request with trace id, backend, "
                        "retries, duration; docs/observability.md)")
    p.add_argument("--span-log", default=None,
                   help="span-timeline JSONL path (router.request / "
                        "router.attempt spans, joinable with engine "
                        "span logs by trace id via "
                        "scripts/trace_export.py; "
                        "docs/tracing-timeline.md)")
    p.add_argument("--engine-selector", default=None,
                   help="k8s label selector for engine Services "
                        "(k=v[,k=v]); requires --in-cluster/--kube-*")
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
        # only known pool prefixes split — URLs may contain '='
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
        p.error("at least one --backend or --engine-selector is required")
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
    srv = RouterServer(router, host=args.bind, port=args.port,
                       retries=args.retries,
                       retry_backoff=args.retry_backoff,
                       request_log=args.request_log,
                       span_log=args.span_log,
                       debug_endpoints=args.debug_endpoints).start()
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
    log.info("router on :%d over %d backends (policy=%s)", srv.port,
             len(backends), args.policy)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
