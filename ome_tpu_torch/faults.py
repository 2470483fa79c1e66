"""Deterministic fault injection for the serving path.

Production serving treats engine-step faults, slow backends, and
dropped PD handoffs as NORMAL operating conditions — but none of the
recovery paths (scheduler restart, router circuit breaking, deadline
shedding) are testable without a way to make those faults happen on
demand, at an exact step, the same way every run. This module is that
switch: a process-global registry of counted injection rules that the
hot paths consult through one cheap call.

Spec grammar (comma-separated rules)::

    point[.kind][=param]@start[:count]
    point|key[.kind][=param]@start[:count]

  * ``point`` — the injection site name (e.g. ``engine_step``,
    ``router_forward``, ``pd_fetch``, ``server_http``);
  * ``key`` — optional per-entity selector (a backend URL, a model
    name); a keyed rule only matches ``fire(point, key=...)`` calls
    with that exact key, an unkeyed rule matches every call at the
    point. Keys may contain ``.``/``:``/``/`` (URLs qualify) but not
    ``=`` (the param separator);
  * ``kind`` — ``raise`` (default): raise at the site; ``slow``:
    sleep ``param`` seconds, then continue; ``http``: make the site
    answer with HTTP status ``param`` (default 503) — only sites that
    call :func:`http` honor it;
  * ``start``/``count`` — fire on hits ``start .. start+count-1`` of
    that rule (1-based, per rule, process-global); ``count`` defaults
    to 1. ``engine_step.raise@3`` fails exactly the third engine step.

Activation: ``OME_FAULTS`` env var at first use, ``--faults`` flags on
the serve/router entrypoints, or :func:`install` from tests. The spec
is parsed once; every site costs one attribute read + truth test when
no rules are installed.

Wired sites:
  * ``engine_step``    — scheduler decode step (raise/slow);
  * ``server_http``    — EngineServer POST handling, key=model name
    (http/raise/slow);
  * ``router_forward`` — router -> backend forward, key=backend URL
    (raise surfaces as URLError, i.e. a connection failure);
  * ``pd_peer_connect`` — PD decode node's connection to one prefill
    peer, key=peer URL (raise surfaces as PDError BEFORE the request
    body is sent: the fetch fails over to the next healthy peer);
  * ``pd_fetch``       — PD decode node's remote KV fetch, key=peer
    URL (raise surfaces as PDError: transient, fails over across the
    pool, then fails one request);
  * ``pd_deserialize`` — decoding a fetched KV wire blob, key=the
    peer that served it (raise surfaces as PDError: a corrupt blob
    fails one request);
  * ``pd_insert``      — inserting fetched KV into the local cache,
    key=serving peer (raise surfaces as PDError: transient,
    per-request; the scheduler's insert paths classify it);
  * ``journal_append`` — request-journal record write (raise degrades
    the journal: serving continues, durability is lost);
  * ``journal_fsync``  — request-journal fsync (raise degrades, as
    above; slow models a stalling disk);
  * ``journal_replay`` — journal scan at startup (raise makes resume
    fail open: the engine starts empty instead of crashing);
  * ``drain_timeout``  — graceful-drain grace expiry (slow extends
    the drain window to exercise the force path);
  * ``sim_transport_submit`` / ``sim_transport_probe`` /
    ``sim_transport_scrape`` — the fleet simulator's in-process
    transport (key=backend URL). Consulted through :func:`check`
    (never :func:`fire` — the sim cannot sleep wall time): raise
    surfaces as the same OSError family a refused connection
    produces; an armed slow at submit counts as a client timeout
    once it reaches the transport's timeout budget.
  * ``weight_fetch``   — weight-plane object download, key=relative
    object name (raise kills one transfer mid-fetch: the staged tree
    stays partial, the manifest keeps only verified objects);
  * ``weight_verify``  — post-fetch digest check, key=relative object
    name (raise surfaces as WeightVerifyError: the object is
    re-fetched on the next attempt, never recorded as verified);
  * ``model_publish``  — the atomic staging->target rename, key=model
    name (raise surfaces as PublishError BEFORE the rename: the
    serving path never sees a partial tree).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["InjectedFault", "Rule", "FaultInjector", "parse_spec",
           "spec_points", "install", "reset", "fire", "afire", "http",
           "check", "active"]


class InjectedFault(RuntimeError):
    """Raised at a ``raise``-kind injection site."""


@dataclass
class Rule:
    point: str                    # site name, with optional "|key"
    kind: str = "raise"           # raise | slow | http
    param: float = 0.0            # slow: seconds; http: status code
    start: int = 1                # 1-based hit index the rule arms at
    count: int = 1                # consecutive hits it stays armed for
    seen: int = field(default=0)  # hits observed so far (mutable)

    def matches(self, point: str, key: Optional[str]) -> bool:
        if self.point == point:
            return True
        return key is not None and self.point == f"{point}|{key}"

    def armed_hit(self) -> bool:
        """Count one hit; True when this hit falls in the armed
        window."""
        self.seen += 1
        return self.start <= self.seen < self.start + self.count


def parse_spec(spec: str) -> List[Rule]:
    rules: List[Rule] = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, sep, sched = entry.rpartition("@")
        if not sep:
            raise ValueError(
                f"fault rule {entry!r}: missing @start[:count]")
        start_s, _, count_s = sched.partition(":")
        start, count = int(start_s), int(count_s) if count_s else 1
        if start < 1 or count < 1:
            raise ValueError(
                f"fault rule {entry!r}: start and count must be >= 1")
        if "=" in head:
            pk, param_s = head.rsplit("=", 1)
        else:
            pk, param_s = head, ""
        # keys (URLs) contain dots; the KIND never does, so split the
        # kind off the right only when the tail names one
        point, _, kind = pk.rpartition(".")
        if kind not in ("raise", "slow", "http"):
            point, kind = pk, "raise"
        if not point:
            raise ValueError(f"fault rule {entry!r}: empty point")
        if kind == "http":
            param = float(param_s) if param_s else 503.0
        elif kind == "slow":
            if not param_s:
                raise ValueError(
                    f"fault rule {entry!r}: slow needs =seconds")
            param = float(param_s)
        else:
            param = 0.0
        rules.append(Rule(point=point, kind=kind, param=param,
                          start=start, count=count))
    return rules


def spec_points(spec: str) -> set:
    """The set of injection-site names a spec references, keys
    stripped — what the chaos harness checks against the documented
    fault-point catalog before it will run a schedule."""
    return {r.point.split("|", 1)[0] for r in parse_spec(spec)}


class FaultInjector:
    """Holds parsed rules; thread-safe counting."""

    def __init__(self, rules: List[Rule]):
        self.rules = rules
        self._lock = threading.Lock()

    def consult(self, point: str, key: Optional[str] = None,
                exc: type = InjectedFault):
        """Count a hit against raise/slow rules at a site and return
        ``(delay_seconds, exception_or_None)`` — the caller applies
        them with the sleep primitive of its execution domain (fire:
        time.sleep on threads; afire: asyncio.sleep on the loop)."""
        delay = 0.0
        boom = None
        with self._lock:
            for r in self.rules:
                if r.kind == "http" or not r.matches(point, key):
                    continue
                if r.armed_hit():
                    if r.kind == "slow":
                        delay = max(delay, r.param)
                    else:
                        boom = boom or exc(
                            f"injected fault at {point}"
                            + (f"|{key}" if key else "")
                            + f" (hit {r.seen})")
        return delay, boom

    def fire(self, point: str, key: Optional[str] = None,
             exc: type = InjectedFault) -> None:
        """Consult raise/slow rules at a site. Raises ``exc`` when a
        raise rule is armed for this hit; sleeps for armed slow
        rules."""
        delay, boom = self.consult(point, key=key, exc=exc)
        if delay:
            time.sleep(delay)
        if boom is not None:
            raise boom

    def http(self, point: str, key: Optional[str] = None
             ) -> Optional[int]:
        """Status code an armed http rule wants the site to answer
        with, else None."""
        with self._lock:
            for r in self.rules:
                if r.kind != "http" or not r.matches(point, key):
                    continue
                if r.armed_hit():
                    return int(r.param)
        return None


# -- process-global registry ----------------------------------------
#
# _injector is None until someone installs a spec (or OME_FAULTS is
# set), so the per-site cost in production is a module attribute read
# and an `is None` test.

_injector: Optional[FaultInjector] = None
_env_checked = False


def install(spec: str) -> None:
    """Install (or with an empty spec, clear) the global rule set."""
    global _injector, _env_checked
    _env_checked = True  # explicit install overrides the env var
    rules = parse_spec(spec)
    _injector = FaultInjector(rules) if rules else None


def reset() -> None:
    global _injector, _env_checked
    _injector = None
    _env_checked = True


def _get() -> Optional[FaultInjector]:
    global _injector, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get("OME_FAULTS", "")
        if spec:
            _injector = FaultInjector(parse_spec(spec))
    return _injector


def active() -> bool:
    return _get() is not None


def fire(point: str, key: Optional[str] = None,
         exc: type = InjectedFault) -> None:
    inj = _get()
    if inj is not None:
        inj.fire(point, key=key, exc=exc)


def check(point: str, key: Optional[str] = None,
          exc: type = InjectedFault):
    """fire() for sites that own their execution domain: counts the
    hit and returns ``(delay_seconds, exception_or_None)`` WITHOUT
    sleeping or raising. The fleet simulator's transport consults its
    points through this — a ``time.sleep`` there would mix wall time
    into virtual time (the sim-wall-clock lint forbids it), so the
    sim maps an armed slow rule onto its own timeout semantics."""
    inj = _get()
    if inj is None:
        return 0.0, None
    return inj.consult(point, key=key, exc=exc)


async def afire(point: str, key: Optional[str] = None,
                exc: type = InjectedFault) -> None:
    """fire() for coroutine sites: armed slow rules await
    asyncio.sleep instead of blocking the event loop (a time.sleep
    here would stall EVERY stream the loop is carrying, not just the
    faulted one). Raise semantics are identical to fire()."""
    inj = _get()
    if inj is None:
        return
    delay, boom = inj.consult(point, key=key, exc=exc)
    if delay:
        await asyncio.sleep(delay)
    if boom is not None:
        raise boom


def http(point: str, key: Optional[str] = None) -> Optional[int]:
    inj = _get()
    if inj is not None:
        return inj.http(point, key=key)
    return None
