"""Fleet rollup: scrape every backend, merge, evaluate, serve (port of
ome_tpu/slo/rollup.py).

The rollup loop runs inside the router (a daemon thread on wall
time; the reference also ticks it on its simulator's virtual time):
each tick it fetches every registered
backend's /metrics through the injected ``fetch_fn`` (a
``SharedScraper`` when the autoscale controller also scrapes, so
each backend is fetched once per tick), merges the per-class latency
histograms bucket-wise across engines — re-basing per engine
incarnation so a mid-window restart never mixes pre- and
post-restart counters — reads the router's own per-class outcome
counters for availability, and feeds the deltas to the
``SLOEngine``.  ``report()`` is the body of ``GET /slo``.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Iterable, Optional

from ..autoscale import scrape
from .engine import SLOEngine
from .spec import SLOSpec

log = logging.getLogger("ome.slo")

# objective name -> (histogram family, has per-class children).
# tpot has no per-class family yet, so every class reads the global
# distribution — documented in docs/slo.md.
LATENCY_FAMILIES = {
    "ttft": ("ome_engine_class_ttft_seconds", True),
    "queue_wait": ("ome_engine_class_queue_wait_seconds", True),
    "e2e": ("ome_engine_class_e2e_seconds", True),
    "tpot": ("ome_engine_tpot_seconds", False),
}

# the gauge the reference's simulated engines expose so the rollup
# can re-base windows on restart; served engines do not expose it (incarnation stays None and
# the counts-went-backwards check covers restarts-from-zero)
INCARNATION_GAUGE = "ome_sim_engine_incarnation"

OUTCOME_FAMILY = "ome_router_class_outcomes_total"


class FleetRollup:
    def __init__(self, spec: SLOSpec,
                 clock: Callable[[], float],
                 fetch_fn: Callable[[str], Dict[str, float]],
                 backends_fn: Callable[[], Iterable[dict]],
                 registry=None,
                 local_samples_fn: Optional[
                     Callable[[], Dict[str, float]]] = None):
        self.spec = spec
        self.clock = clock
        self.fetch_fn = fetch_fn
        self.backends_fn = backends_fn
        self.local_samples_fn = local_samples_fn
        self.engine = SLOEngine(spec, clock, registry=registry)
        self.scrapes = 0
        self.scrape_errors = 0
        if registry is not None:
            self._c_scrapes = registry.counter(
                "ome_slo_scrapes_total",
                "Backend /metrics fetches issued by the SLO rollup")
            self._c_scrape_errors = registry.counter(
                "ome_slo_scrape_errors_total",
                "Failed backend fetches in the SLO rollup")
        else:
            self._c_scrapes = self._c_scrape_errors = None
        # one histogram window per (class, latency objective); the
        # global-family objectives (tpot) share one window per class
        # name anyway so per-class budgets still apply
        self._windows: Dict[tuple, scrape.HistogramWindow] = {}
        for cls, objectives in spec.classes.items():
            for obj in objectives:
                if obj.kind != "latency":
                    continue
                family, per_class = LATENCY_FAMILIES[obj.name]
                labels = {"class": cls} if per_class else None
                self._windows[(cls, obj.name)] = \
                    scrape.HistogramWindow(family, labels=labels,
                                           clock=clock)
        # availability from the router's own outcome counters:
        # ok/error deltas per class
        self._avail: Dict[tuple, scrape.CounterWindow] = {}
        for cls, objectives in spec.classes.items():
            if not any(o.kind == "availability" for o in objectives):
                continue
            for res in ("ok", "error"):
                self._avail[(cls, res)] = scrape.CounterWindow(
                    OUTCOME_FAMILY,
                    label_filter={"class": cls, "result": res})
        self._known: set = set()
        self._last_eval: Dict[str, dict] = {}
        self._last_at: Optional[float] = None

    def tick(self) -> None:
        """One rollup pass: scrape, merge, evaluate."""
        backends = list(self.backends_fn() or [])
        urls = [b.get("url") for b in backends if b.get("url")]
        gone = self._known - set(urls)
        for url in gone:
            for w in self._windows.values():
                w.forget(url)
        self._known = set(urls)
        for url in urls:
            try:
                samples = self.fetch_fn(url)
            except OSError:
                self.scrape_errors += 1
                if self._c_scrape_errors is not None:
                    self._c_scrape_errors.inc()
                for w in self._windows.values():
                    w.forget(url)
                continue
            self.scrapes += 1
            if self._c_scrapes is not None:
                self._c_scrapes.inc()
            incarnation = samples.get(INCARNATION_GAUGE)
            for w in self._windows.values():
                w.update(url, samples, incarnation=incarnation)
        for (cls, name), w in self._windows.items():
            merged = w.merged()
            if not merged:
                continue
            total = merged[-1][1]
            if total <= 0:
                continue
            threshold = next(
                o.threshold_s for o in self.spec.classes[cls]
                if o.name == name)
            good = scrape.count_le(merged, threshold)
            self.engine.observe(cls, name, good, total)
        if self._avail and self.local_samples_fn is not None:
            samples = self.local_samples_fn()
            for w in self._avail.values():
                w.update("local", samples)
            for cls in self.spec.classes:
                ok_w = self._avail.get((cls, "ok"))
                err_w = self._avail.get((cls, "error"))
                if ok_w is None:
                    continue
                good = ok_w.total()
                total = good + err_w.total()
                if total > 0:
                    self.engine.observe(cls, "availability",
                                        good, total)
        self._last_eval = self.engine.evaluate()
        self._last_at = round(self.clock(), 6)

    def max_burn(self) -> float:
        return self.engine.max_burn()

    def report(self) -> dict:
        """Deterministic report dict: the ``GET /slo`` body (last
        completed tick)."""
        return {
            "at": self._last_at,
            "spec": self.spec.to_doc(),
            "classes": self._last_eval,
            "alerts": list(self.engine.events),
            "scrapes": self.scrapes,
            "scrape_errors": self.scrape_errors,
        }


def start_thread(rollup: FleetRollup, interval: float,
                 stop_event: Optional[threading.Event] = None
                 ) -> threading.Event:
    """A daemon thread ticking the rollup on wall time, the router's
    loop. Returns the stop event; set it to end the loop."""
    stop = stop_event or threading.Event()

    def loop():
        while not stop.wait(interval):
            try:
                rollup.tick()
            except Exception:
                log.exception("slo rollup tick failed")

    threading.Thread(target=loop, daemon=True,
                     name="slo-rollup").start()
    return stop
