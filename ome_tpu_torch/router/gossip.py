"""Versioned-snapshot anti-entropy between router replicas (port of
ome_tpu/router/gossip.py; the snapshot wire format is the reference's,
byte for byte, so a fleet can mix the two routers).

The ingress tier is N stateless routers in front of one engine pool
(docs/router-ha.md). What must be shared is small and observational:

  * per-backend breaker/draining observations — replica A tripping a
    breaker should keep replica B from burning its own cb_threshold
    failures against the same dead backend;
  * the fleet prefix directory — which engine owns which prefix
    digest, so cache-aware peer hints work regardless of which
    router a request lands on.

What is deliberately NOT shared: backend membership (each replica's
--backend flags / autoscale registrations are its own), in-flight
accounting, retry budgets, metrics. Losing a router loses its
connections, never correctness — request durability lives in the
engine journal below.

Protocol: each replica keeps a monotonically-versioned snapshot of
its observations. Peers pull /gossip/state on the health-loop
cadence and merge with last-writer-wins per record, ordered by the
(wall-clock stamp, origin replica id) pair — a total order, so merge
is commutative, associative and idempotent (tests/test_torch_gossip.py
holds it property-style), and any pull topology converges.

Clock note: breaker cooldowns are *monotonic*-clock deadlines, which
do not travel between processes. Snapshots therefore carry
``cb_open_remaining`` (seconds of cooldown left at serialization
time) and the merge re-anchors it onto the local monotonic clock.
LWW record stamps are wall-clock and only ORDER records; a skewed
clock ages one replica's observations, it never corrupts state.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from .server import Backend, Router

log = logging.getLogger("ome.router.gossip")

# observation fields that constitute content: a change to any of them
# re-stamps the record (cb_open_remaining is volatile — it decays
# every second — so it is carried but never compared). "models" is the
# backend's /ready model advertisement — gossiping it lets a replica
# steer model-routed requests onto backends it has not probed yet
# (docs/model-fleet.md).
_OBS_FIELDS = ("pool", "healthy", "draining", "cb_state", "fails",
               "cb_trips", "models")


def lww_wins(a: Optional[dict], b: Optional[dict]) -> bool:
    """True when record `a` beats record `b` under last-writer-wins.
    Ordered by (stamp, origin): the stamp is the wall-clock second
    the observation changed; the origin replica id breaks exact
    ties deterministically. None always loses."""
    if a is None:
        return False
    if b is None:
        return True
    return ((a.get("stamp", 0.0), a.get("origin", "")) >
            (b.get("stamp", 0.0), b.get("origin", "")))


def merge_records(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    """The newer of two records (pure; max under the LWW order)."""
    return a if lww_wins(a, b) else (b if b is not None else a)


def merge_backends(local: Dict[str, dict],
                   remote: Dict[str, dict]) -> Dict[str, dict]:
    """Per-URL LWW merge of backend-observation maps. Pure — the
    property tests drive this directly. Commutative and idempotent
    because each slot independently takes the max of a total order."""
    out = dict(local)
    for url, rec in remote.items():
        out[url] = merge_records(out.get(url), rec)
    return out


def merge_prefix(local: Dict[str, dict],
                 remote: Dict[str, dict]) -> Dict[str, dict]:
    """Per-digest LWW merge of prefix-directory maps (same algebra
    as merge_backends, keyed by digest instead of URL)."""
    return merge_backends(local, remote)


class GossipState:
    """One replica's versioned observation snapshot.

    The version is a monotonic counter bumped whenever snapshot
    CONTENT changes (a local observation re-stamped, or a merge that
    adopted remote records) — peers cache the last version they saw
    per replica and skip no-op merges."""

    def __init__(self, router: Router, replica_id: str):
        self.router = router
        self.replica_id = replica_id
        self._obs: Dict[str, dict] = {}
        self._prefix: Dict[str, dict] = {}
        self._version = 0
        self._seen_versions: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- local sampling ------------------------------------------------

    def _sample_backends(self) -> List[Backend]:
        with self.router._lock:
            return list(self.router.backends)

    def _refresh_local(self, now_wall: float) -> bool:
        """Fold the live Router state into the observation map. A
        record is re-stamped (stamp=now, origin=self) only when its
        content changed — an observation adopted from a peer keeps
        the peer's stamp until the LOCAL view diverges from it, so
        refresh never launders remote authorship. Caller holds
        self._lock."""
        changed = False
        live = {}
        for b in self._sample_backends():
            with b._lock:
                live[b.url] = {
                    "pool": b.pool, "healthy": b.healthy,
                    "draining": b.draining, "cb_state": b.cb_state,
                    "fails": b.fails, "cb_trips": b.cb_trips}
            # model advertisement rides the same record (leaf lock of
            # its own; taken after the backend lock is released)
            live[b.url]["models"] = sorted(
                self.router.model_map.models_of(b.url))
        for url, content in live.items():
            prev = self._obs.get(url)
            if prev is None or any(prev.get(f) != content[f]
                                   for f in _OBS_FIELDS):
                rec = dict(content)
                # a PRISTINE first record (healthy, closed, untouched
                # breaker) is a boot default, not an observation — it
                # gets stamp 0 so it can never outrank a peer's real
                # observation just because this replica booted later.
                # Any deviation (and any later change, including a
                # recovery back to pristine) earns a real stamp.
                pristine = (prev is None and content["healthy"]
                            and not content["draining"]
                            and content["cb_state"] == "closed"
                            and content["fails"] == 0
                            and content["cb_trips"] == 0
                            and not content["models"])
                rec["stamp"] = 0.0 if pristine else now_wall
                rec["origin"] = "" if pristine else self.replica_id
                self._obs[url] = rec
                changed = True
        for url in [u for u in self._obs if u not in live]:
            del self._obs[url]  # backend removed locally
            changed = True
        # prefix directory: last reporter wins a digest, same as the
        # directory itself; evicted digests drop out of the snapshot
        live_prefix = dict(self.router.prefix_directory.export())
        for digest, owner in live_prefix.items():
            prev = self._prefix.get(digest)
            if prev is None or prev.get("owner") != owner:
                self._prefix[digest] = {"owner": owner,
                                        "stamp": now_wall,
                                        "origin": self.replica_id}
                changed = True
        for digest in [d for d in self._prefix if d not in live_prefix]:
            del self._prefix[digest]
            changed = True
        return changed

    # -- snapshot / merge ----------------------------------------------

    def snapshot(self) -> dict:
        """The /gossip/state body. Backend records carry the
        non-volatile content plus cb_open_remaining computed fresh
        from the live breaker deadline (monotonic clocks do not
        travel; the peer re-anchors the remaining seconds)."""
        now_mono = time.monotonic()
        remaining = {}
        for b in self._sample_backends():
            with b._lock:
                remaining[b.url] = max(0.0, b.cb_open_until - now_mono) \
                    if b.cb_state in ("open", "half_open") else 0.0
        with self._lock:
            if self._refresh_local(time.time()):
                self._version += 1
            backends = {}
            for url, rec in self._obs.items():
                out = dict(rec)
                out["cb_open_remaining"] = round(
                    remaining.get(url, 0.0), 3)
                backends[url] = out
            return {"replica": self.replica_id,
                    "version": self._version,
                    "backends": backends,
                    "prefix": {d: dict(r)
                               for d, r in self._prefix.items()}}

    def merge(self, remote: dict) -> int:
        """Fold a peer snapshot in; returns the number of records
        adopted. Unknown backend URLs are skipped — membership is not
        gossiped, only observations about backends this replica
        already routes to. Adopted breaker state is applied to the
        live Backend (cooldown re-anchored onto the local monotonic
        clock, probe slot released — record_failure's probe-token
        idempotency absorbs the release racing a live probe)."""
        if not isinstance(remote, dict):
            return 0
        replica = remote.get("replica")
        version = remote.get("version")
        with self._lock:
            if replica is not None and \
                    self._seen_versions.get(replica) == version:
                return 0
            self._refresh_local(time.time())
            by_url = {b.url: b for b in self._sample_backends()}
            adopted = 0
            rbackends = remote.get("backends") or {}
            for url, rec in rbackends.items():
                if not isinstance(rec, dict):
                    continue
                b = by_url.get(url)
                if b is None:
                    continue
                if lww_wins(rec, self._obs.get(url)):
                    stored = {f: rec.get(f) for f in _OBS_FIELDS}
                    stored["stamp"] = rec.get("stamp", 0.0)
                    stored["origin"] = rec.get("origin", "")
                    self._obs[url] = stored
                    self._apply(b, rec)
                    # adopted model advertisements feed the model map
                    # (advertise ignores a record without the field)
                    self.router.model_map.advertise(
                        url, rec.get("models"))
                    adopted += 1
            rprefix = remote.get("prefix") or {}
            for digest, rec in rprefix.items():
                if not isinstance(rec, dict):
                    continue
                if lww_wins(rec, self._prefix.get(digest)):
                    owner = rec.get("owner")
                    if not isinstance(owner, str) or not owner:
                        continue
                    self._prefix[digest] = {
                        "owner": owner, "stamp": rec.get("stamp", 0.0),
                        "origin": rec.get("origin", "")}
                    self.router.prefix_directory.update(owner, [digest])
                    adopted += 1
            if replica is not None and isinstance(version, int):
                self._seen_versions[replica] = version
            if adopted:
                self._version += 1
            return adopted

    @staticmethod
    def _apply(b: Backend, rec: dict) -> None:
        state = rec.get("cb_state")
        if state not in ("closed", "half_open", "open"):
            return
        with b._lock:
            b.healthy = bool(rec.get("healthy", True))
            b.draining = bool(rec.get("draining", False))
            b.cb_state = state
            b.fails = int(rec.get("fails", 0))
            b.cb_trips = int(rec.get("cb_trips", 0))
            if state == "open":
                b.cb_open_until = time.monotonic() + float(
                    rec.get("cb_open_remaining") or 0.0)
            b._probe_inflight = False

    def stats(self) -> dict:
        with self._lock:
            return {"replica": self.replica_id,
                    "version": self._version,
                    "backends": len(self._obs),
                    "prefix": len(self._prefix),
                    "seen": dict(self._seen_versions)}


class GossipAgent:
    """Pull loop: fetch each peer's /gossip/state on the health-loop
    cadence and merge. Runs on a plain thread (urllib blocks) — the
    asyncio data path never touches the network here; it shares state
    through the same leaf locks the policy objects already use."""

    def __init__(self, state: GossipState, peers: List[str],
                 interval: float = 10.0, timeout: float = 5.0):
        self.state = state
        self.peers = [p.rstrip("/") for p in peers]
        self.interval = interval
        self.timeout = timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = state.router.registry
        self._c_pulls = reg.counter(
            "ome_router_gossip_pulls_total",
            "Anti-entropy snapshot pulls attempted against peers")
        self._c_pull_errors = reg.counter(
            "ome_router_gossip_pull_errors_total",
            "Anti-entropy pulls that failed (peer down or bad body)")
        self._c_merges = reg.counter(
            "ome_router_gossip_merges_total",
            "Peer snapshots merged that adopted at least one record")
        self._c_updates = reg.counter(
            "ome_router_gossip_record_updates_total",
            "Backend/prefix records adopted from peer snapshots")
        self._g_version = reg.gauge(
            "ome_router_gossip_version",
            "This replica's monotonic gossip snapshot version")
        self._g_peers = reg.gauge(
            "ome_router_gossip_peers",
            "Peer routers this replica pulls snapshots from")
        self._g_peers.set(len(self.peers))

    def pull_once(self) -> int:
        """One anti-entropy round: pull and merge every peer.
        Returns total records adopted (the convergence bound: one
        round suffices)."""
        total = 0
        for peer in self.peers:
            self._c_pulls.inc()
            try:
                with urllib.request.urlopen(
                        peer + "/gossip/state",
                        timeout=self.timeout) as resp:
                    snap = json.loads(resp.read() or b"{}")
            except Exception as e:
                self._c_pull_errors.inc()
                log.debug("gossip pull from %s failed: %s", peer, e)
                continue
            adopted = self.state.merge(snap)
            if adopted:
                self._c_merges.inc()
                self._c_updates.inc(adopted)
                total += adopted
        self._g_version.set(self.state.stats()["version"])
        return total

    def start(self) -> "GossipAgent":
        def loop():
            while not self._stop.wait(self.interval):
                self.pull_once()
        self._thread = threading.Thread(
            target=loop, name="router-gossip", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
