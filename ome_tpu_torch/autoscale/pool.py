"""Live engine pool: the scaling controller's actuator.

Port of ome_tpu/autoscale/pool.py. Scale-UP spawns one of the port's
engine subprocesses (through the chaos harness's ``--serve-child``
re-entry) on the pool's ``device`` (default cuda; the CPU only when
the caller names it), waits for /health, and only THEN registers the
URL with the router's guarded POST /backends — a backend never enters
rotation before it can serve. ``spawns`` records each spawn's start
and registration times on the pool's clock.

Scale-DOWN is the zero-loss path the journal + drain PRs built:
SIGTERM starts the engine's graceful drain (in-flight requests keep
streaming, /ready flips 503+draining so the router stops selecting
it), a background waiter joins the exit, and the backend is
DELETEd from the router only after the process is gone. If the
process dies mid-drain WITH journaled work outstanding (a chaos kill,
an OOM), the waiter respawns it on the same port + journal so
restart-resume finishes the admitted requests, then drains it again —
"zero admitted requests lost" holds through a kill DURING scale-down.

Locking: ``_lock`` guards the membership lists only. Every blocking
operation — Popen, readiness polls, HTTP registration, exit waits —
runs outside it (the lock-discipline analyzer checks this).
"""

from __future__ import annotations

import logging
import pathlib
import threading
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..chaos import ManagedProc, _http, free_port, journal_live_entries

log = logging.getLogger("ome.autoscale")


@dataclass
class PoolMember:
    proc: ManagedProc
    journal: pathlib.Path
    started_mono: float
    draining: bool = False


@dataclass
class DrainRecord:
    """Outcome of one scale-down, for tests and the soak report."""

    name: str
    url: str
    ok: bool
    resumed: bool = False
    detail: str = ""


class EnginePool:
    """One router pool's worth of engine subprocesses.

    ``engine_args(port, name, journal_dir)`` builds the child argv —
    the caller owns model/KV/drain flags (chaos._engine_args style);
    the pool owns ports, journals, lifecycle, and registration.
    """

    def __init__(self, name: str, router_url: Optional[str],
                 engine_args: Callable[[int, str, pathlib.Path],
                                       List[str]],
                 base_dir: pathlib.Path, router_pool: str = "engine",
                 ready_timeout: float = 120.0,
                 drain_exit_timeout: float = 60.0,
                 resume_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 device: str = "cuda"):
        self.name = name
        # every member runs `serve --device <device>`, whatever argv
        # engine_args builds (argparse keeps the last --device)
        self.device = device
        self.router_url = (router_url.rstrip("/")
                           if router_url else None)
        self.router_pool = router_pool
        self.engine_args = engine_args
        self.base_dir = pathlib.Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.ready_timeout = ready_timeout
        self.drain_exit_timeout = drain_exit_timeout
        self.resume_timeout = resume_timeout
        # clock for capacity ACCOUNTING (engine_seconds). Drain-exit
        # and resume deadlines stay on real time deliberately: they
        # bound real subprocess exits, which no virtual clock governs.
        self.clock = clock
        self._lock = threading.Lock()
        self._members: List[PoolMember] = []
        self._waiters: List[threading.Thread] = []
        self._seq = 0
        self._engine_seconds = 0.0
        self.drains: List[DrainRecord] = []
        # {"name", "started", "registered"} per spawn, pool clock
        self.spawns: List[dict] = []

    # -- observation (lock only; no blocking ops) ---------------------

    def size(self) -> int:
        """Serving members (draining ones no longer count toward
        capacity — the policy must be able to keep scaling)."""
        with self._lock:
            return sum(1 for m in self._members if not m.draining)

    def member_urls(self) -> List[str]:
        with self._lock:
            return [m.proc.url for m in self._members if not m.draining]

    def draining_count(self) -> int:
        with self._lock:
            return sum(1 for m in self._members if m.draining)

    def journals(self) -> List[pathlib.Path]:
        with self._lock:
            paths = [m.journal for m in self._members]
        seen = set(paths)
        # journals of fully drained members still hold the loss
        # evidence — include every journal this pool ever created
        for p in sorted(self.base_dir.glob("journal-*/requests.jsonl")):
            if p not in seen:
                paths.append(p)
        return paths

    def engine_seconds(self) -> float:
        """Capacity cost so far: summed lifetime of every member,
        live ones included — the number the soak compares against
        static max-provisioning."""
        now = self.clock()
        with self._lock:
            live = sum(now - m.started_mono for m in self._members)
            return self._engine_seconds + live

    # -- scale up -----------------------------------------------------

    def spawn(self) -> ManagedProc:
        with self._lock:
            self._seq += 1
            name = f"{self.name}{self._seq}"
        port = free_port()
        journal_dir = self.base_dir / f"journal-{name}"
        proc = ManagedProc(
            name, "engine",
            self.engine_args(port, name, journal_dir)
            + ["--device", self.device], port,
            self.base_dir / f"{name}.log")
        started = self.clock()
        proc.start()
        proc.wait_ready(self.ready_timeout)
        self._register(proc.url)
        registered = self.clock()
        with self._lock:
            self._members.append(PoolMember(
                proc=proc, journal=journal_dir / "requests.jsonl",
                started_mono=registered))
            self.spawns.append({"name": name, "started": started,
                                "registered": registered})
        log.info("pool %s: spawned %s on %s", self.name, name, proc.url)
        return proc

    # -- scale down ---------------------------------------------------

    def drain_one(self) -> Optional[str]:
        """SIGTERM the newest serving member and hand the rest of the
        drain to a background waiter. Returns the victim's name, or
        None when the pool has no serving member to shed."""
        with self._lock:
            victim: Optional[PoolMember] = None
            for m in reversed(self._members):
                if not m.draining:
                    victim = m
                    break
            if victim is None:
                return None
            victim.draining = True
        victim.proc.term()
        waiter = threading.Thread(
            target=self._finish_drain, args=(victim,),
            name=f"drain-{victim.proc.name}", daemon=True)
        with self._lock:
            self._waiters.append(waiter)
        waiter.start()
        log.info("pool %s: draining %s", self.name, victim.proc.name)
        return victim.proc.name

    def _finish_drain(self, member: PoolMember) -> None:
        proc = member.proc
        record = DrainRecord(name=proc.name, url=proc.url, ok=True)
        proc.wait_exit(self.drain_exit_timeout)
        if journal_live_entries(member.journal):
            # killed mid-drain with admitted work outstanding: the
            # journal is the source of truth — respawn on the same
            # port/journal, let restart-resume tombstone every admit,
            # then drain again (docs/autoscaling.md scale-down
            # guarantee)
            record.resumed = True
            try:
                proc.start()
                proc.wait_ready(self.ready_timeout)
                self._register(proc.url)
                deadline = time.monotonic() + self.resume_timeout
                while time.monotonic() < deadline:
                    if not journal_live_entries(member.journal):
                        break
                    time.sleep(0.25)
                else:
                    record.ok = False
                    record.detail = "journal resume timed out"
                proc.term()
                proc.wait_exit(self.drain_exit_timeout)
            except Exception as e:  # noqa: BLE001 — keep the pool
                record.ok = False   # alive; the record carries why
                record.detail = f"{type(e).__name__}: {e}"
                proc.kill()
        self._deregister(proc.url)
        now = self.clock()
        with self._lock:
            if member in self._members:
                self._members.remove(member)
                self._engine_seconds += now - member.started_mono
            self.drains.append(record)
        log.info("pool %s: drain of %s complete (ok=%s resumed=%s)",
                 self.name, proc.name, record.ok, record.resumed)

    def join_drains(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                waiters = [w for w in self._waiters if w.is_alive()]
                self._waiters = waiters
            if not waiters:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            waiters[0].join(min(remaining, 1.0))

    # -- registration -------------------------------------------------

    def _register(self, url: str) -> None:
        if self.router_url is None:
            return
        status, body = _http(self.router_url + "/backends",
                             {"url": url, "pool": self.router_pool},
                             timeout=10.0)
        if status != 200:
            raise RuntimeError(
                f"router refused registration of {url}: "
                f"{status} {str(body)[:200]}")

    def _deregister(self, url: str) -> None:
        if self.router_url is None:
            return
        try:
            import urllib.request
            import json as _json
            req = urllib.request.Request(
                self.router_url + "/backends",
                data=_json.dumps({"url": url}).encode(),
                method="DELETE",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10.0):
                pass
        except (urllib.error.URLError, OSError):
            # best effort: a dead router cannot misroute anyway, and
            # its health loop would shed the dead backend regardless
            log.warning("pool %s: deregister of %s failed",
                        self.name, url)

    # -- teardown -----------------------------------------------------

    def stop_all(self) -> None:
        self.join_drains(timeout=30.0)
        with self._lock:
            members = list(self._members)
            self._members = []
        now = self.clock()
        for m in members:
            m.proc.stop()
            with self._lock:
                self._engine_seconds += now - m.started_mono
