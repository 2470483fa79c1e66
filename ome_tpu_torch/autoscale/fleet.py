"""Model fleet: a pool-of-pools under a node weight-byte budget.

Port of ome_tpu/autoscale/fleet.py: the same registrations, uses and
clock give the same eviction order. Its pools start the port's
engines on ``device`` (default cuda).

One node serves MANY models (the reference operator's BaseModel fleet,
ROADMAP item 5), but only as many as its HBM/disk budget holds at
once. The fleet manager owns that arbitration:

  * every model registers with its published weight footprint
    (``weight_bytes``) and a per-model argv function;
  * ``ensure(model)`` spawns the model's :class:`EnginePool` on
    demand — evicting least-recently-used resident pools first when
    the byte budget would overflow, with the ``warm_standby`` most
    recently used models shielded from *proactive* reclaim (budget
    pressure always wins: serving the requested model beats keeping a
    standby warm);
  * eviction goes through the pool's SIGTERM drain ladder, so a pool
    holding in-flight or journaled work drains before it dies, and a
    kill mid-evict respawns on the same journal (EnginePool's
    ``_finish_drain``) — byte-identical greedy streams across an
    evict + respawn is the pinned contract the kill-resume suite
    extends.

Locking: ``_lock`` guards the registry maps only. Spawns, drains,
HTTP registration and exit waits — every blocking operation — run
outside it (the lock-discipline analyzer checks this, same doctrine
as pool.py). Concurrent ``ensure`` calls for one model rendezvous on
a per-model event rather than holding the lock across the spawn.
"""

from __future__ import annotations

import logging
import pathlib
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .pool import EnginePool

log = logging.getLogger("ome.autoscale.fleet")


class UnknownModelError(KeyError):
    """ensure() for a model never registered with the fleet."""


class FleetBudgetError(RuntimeError):
    """The byte budget cannot fit the model even after evicting every
    evictable pool (the model alone exceeds the budget, or everything
    else resident is itself being spawned/evicted right now)."""


@dataclass
class ModelEntry:
    name: str
    weight_bytes: int
    engine_args: Callable[[int, str, pathlib.Path], List[str]]
    warmup_ms: float = 0.0
    replicas: int = 1


@dataclass
class FleetEvent:
    """One spawn/evict decision, for tests and the soak report."""

    kind: str  # "spawn" | "evict" | "reap"
    model: str
    reason: str = ""
    freed_bytes: int = 0


class ModelFleet:
    def __init__(self, router_url: Optional[str],
                 base_dir: pathlib.Path, budget_bytes: int, *,
                 warm_standby: int = 1, router_pool: str = "engine",
                 pool_factory: Optional[Callable[[ModelEntry],
                                                 EnginePool]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 ready_timeout: float = 120.0,
                 spawn_wait_timeout: float = 180.0,
                 device: str = "cuda"):
        self.router_url = router_url
        self.device = device
        self.base_dir = pathlib.Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.budget_bytes = budget_bytes
        self.warm_standby = warm_standby
        self.router_pool = router_pool
        self.clock = clock
        self.ready_timeout = ready_timeout
        self.spawn_wait_timeout = spawn_wait_timeout
        self._pool_factory = pool_factory or self._default_pool
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}
        self._pools: Dict[str, EnginePool] = {}
        self._last_used: Dict[str, float] = {}
        self._spawning: Dict[str, threading.Event] = {}
        self._evicting: set = set()
        self.events: List[FleetEvent] = []

    def _default_pool(self, entry: ModelEntry) -> EnginePool:
        return EnginePool(
            name=entry.name, router_url=self.router_url,
            engine_args=entry.engine_args,
            base_dir=self.base_dir / entry.name,
            router_pool=self.router_pool,
            ready_timeout=self.ready_timeout, device=self.device)

    # -- registry -----------------------------------------------------

    def register_model(self, name: str, weight_bytes: int,
                       engine_args: Callable[[int, str, pathlib.Path],
                                             List[str]],
                       warmup_ms: float = 0.0, replicas: int = 1):
        if weight_bytes > self.budget_bytes:
            raise FleetBudgetError(
                f"{name}: weight_bytes {weight_bytes} exceeds the "
                f"node budget {self.budget_bytes}")
        with self._lock:
            self._entries[name] = ModelEntry(
                name=name, weight_bytes=weight_bytes,
                engine_args=engine_args, warmup_ms=warmup_ms,
                replicas=replicas)

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def catalog(self) -> Dict[str, Dict]:
        """{model: {weight_bytes, warmup_ms}} — what the gateway's
        cold-start Retry-After math consumes."""
        with self._lock:
            return {n: {"weight_bytes": e.weight_bytes,
                        "warmup_ms": e.warmup_ms}
                    for n, e in self._entries.items()}

    # -- observation --------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    def _resident_bytes_locked(self, exclude: frozenset = frozenset()
                               ) -> int:
        names = (set(self._pools) | set(self._spawning)) - exclude
        return sum(self._entries[n].weight_bytes
                   for n in names if n in self._entries)

    def resident_models(self) -> List[str]:
        with self._lock:
            return sorted(self._pools)

    def pool(self, model: str) -> Optional[EnginePool]:
        with self._lock:
            return self._pools.get(model)

    def touch(self, model: str):
        """Record a use (a routed request) for LRU purposes."""
        with self._lock:
            if model in self._pools:
                self._last_used[model] = self.clock()

    # -- the tentpole: ensure under budget ----------------------------

    def ensure(self, model: str) -> EnginePool:
        """Return a serving pool for ``model``, spawning it (and
        evicting LRU residents to fit the budget) if needed. Blocks
        until the pool's engines are ready."""
        with self._lock:
            entry = self._entries.get(model)
            if entry is None:
                raise UnknownModelError(model)
            existing = self._pools.get(model)
            if existing is not None:
                self._last_used[model] = self.clock()
                return existing
            waiter = self._spawning.get(model)
            if waiter is None:
                self._spawning[model] = threading.Event()
        if waiter is not None:
            # another thread owns the spawn; wait for it outside any
            # lock, then report its outcome
            waiter.wait(self.spawn_wait_timeout)
            with self._lock:
                pool = self._pools.get(model)
            if pool is None:
                raise FleetBudgetError(
                    f"{model}: concurrent spawn failed or timed out")
            return pool
        try:
            self._make_room(entry)
            pool = self._spawn(entry)
        finally:
            with self._lock:
                ev = self._spawning.pop(model, None)
            if ev is not None:
                ev.set()
        return pool

    def _make_room(self, entry: ModelEntry):
        """Evict LRU pools until ``entry`` fits the byte budget."""
        while True:
            with self._lock:
                # the requested model sits in _spawning already — do
                # not count its own bytes against the room it needs
                free = self.budget_bytes - self._resident_bytes_locked(
                    exclude=frozenset({entry.name}))
                if entry.weight_bytes <= free:
                    return
                victim = self._pick_victim_locked(exclude={entry.name})
                if victim is None:
                    raise FleetBudgetError(
                        f"{entry.name}: needs {entry.weight_bytes} "
                        f"bytes, {free} free, nothing evictable")
                self._evicting.add(victim)
            freed = self._entries[victim].weight_bytes
            self._evict(victim, reason=f"budget: admit {entry.name}",
                        freed=freed)

    def _pick_victim_locked(self, exclude: set) -> Optional[str]:
        candidates = [n for n in self._pools
                      if n not in exclude and n not in self._evicting
                      and n not in self._spawning]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda n: self._last_used.get(n, 0.0))

    def _spawn(self, entry: ModelEntry) -> EnginePool:
        pool = self._pool_factory(entry)
        for _ in range(max(1, entry.replicas)):
            pool.spawn()
        with self._lock:
            self._pools[entry.name] = pool
            self._last_used[entry.name] = self.clock()
            self.events.append(FleetEvent("spawn", entry.name))
        log.info("fleet: spawned pool for %s (%d bytes resident)",
                 entry.name, self.resident_bytes())
        return pool

    # -- eviction -----------------------------------------------------

    def evict(self, model: str, reason: str = "requested") -> bool:
        """Drain-first eviction of one model's pool. Safe to call
        concurrently; returns False when the model is not resident."""
        with self._lock:
            if model not in self._pools or model in self._evicting:
                return False
            self._evicting.add(model)
        self._evict(model, reason=reason,
                    freed=self._entries[model].weight_bytes)
        return True

    def _evict(self, model: str, reason: str, freed: int):
        """The drain ladder: SIGTERM-drain every member (in-flight
        work keeps streaming; a kill mid-drain respawns on the same
        journal inside EnginePool), join the waiters, then stop and
        drop the pool. The registry entry stays — the model can come
        back cold."""
        with self._lock:
            pool = self._pools.get(model)
        try:
            if pool is not None:
                while pool.drain_one() is not None:
                    pass
                pool.join_drains()
                pool.stop_all()
        finally:
            with self._lock:
                self._pools.pop(model, None)
                self._last_used.pop(model, None)
                self._evicting.discard(model)
                self.events.append(FleetEvent(
                    "evict", model, reason=reason, freed_bytes=freed))
        log.info("fleet: evicted %s (%s)", model, reason)

    def reap_idle(self, idle_seconds: float) -> List[str]:
        """Proactive reclaim: evict pools idle longer than
        ``idle_seconds``, keeping the ``warm_standby`` most recently
        used models resident regardless of idleness."""
        now = self.clock()
        with self._lock:
            by_recency = sorted(
                self._pools,
                key=lambda n: self._last_used.get(n, 0.0),
                reverse=True)
            shielded = set(by_recency[:self.warm_standby])
            victims = [n for n in by_recency
                       if n not in shielded
                       and n not in self._evicting
                       and n not in self._spawning
                       and now - self._last_used.get(n, 0.0)
                       > idle_seconds]
            for n in victims:
                self._evicting.add(n)
        for n in victims:
            self._evict(n, reason=f"idle > {idle_seconds:g}s",
                        freed=self._entries[n].weight_bytes)
        return victims

    # -- teardown -----------------------------------------------------

    def stop_all(self):
        with self._lock:
            pools = list(self._pools.values())
            self._pools.clear()
            self._last_used.clear()
        for p in pools:
            p.stop_all()

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            rows = [(name, entry, self._pools.get(name),
                     self._last_used.get(name),
                     name in self._evicting)
                    for name, entry in self._entries.items()]
        # pool counters take the pool's own lock — read them outside
        # the fleet lock to keep the acquisition order flat
        return {name: {
                    "resident": pool is not None,
                    "members": pool.size() if pool else 0,
                    "draining": pool.draining_count() if pool else 0,
                    "weight_bytes": entry.weight_bytes,
                    "last_used": last_used,
                    "evicting": evicting,
                } for name, entry, pool, last_used, evicting in rows}
