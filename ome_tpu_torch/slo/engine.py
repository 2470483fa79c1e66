"""Deterministic SLO evaluator: attainment, budget, burn alerts (port
of ome_tpu/slo/engine.py).

The engine consumes per-(class, objective) good/total event deltas —
the fleet rollup feeds it from merged histogram/counter windows, the
replay client feeds it from client-observed results — and produces:

* **attainment** — good/total over the rolling compliance window;
* **error budget** — consumed = bad / (total * (1 - target)); 1.0
  means the window's allowance is spent;
* **burn rates** — bad_fraction(W) / (1 - target) over each of the
  four alerting windows (page long/short, warn long/short);
* **alert state** — the SRE-workbook multi-window multi-burn-rate
  policy: page when BOTH page windows burn >= the page factor, else
  warn when both warn windows burn >= the warn factor, else ok. A
  transition into warn/page appends a timestamped event to
  ``events`` and bumps ``ome_slo_alerts_total``.

Everything is driven by the **injected clock** — the router runs it
on wall time, a test on its own clock — and every emitted float is
rounded so the same inputs produce byte-identical reports.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..priority import PRIORITY_CLASSES
from . import spec as spec_mod
from .spec import SLOSpec

# label-value vocabularies, module-level literals so the
# metrics-label-cardinality lint can prove every .labels() site
# bounded; OBJECTIVE_NAMES mirrors spec.OBJECTIVE_NAMES (asserted
# below) because the lint only trusts same-file constants
OBJECTIVE_NAMES = ("ttft", "tpot", "e2e", "queue_wait",
                   "availability")
BURN_WINDOW_NAMES = ("page_long", "page_short", "warn_long",
                     "warn_short")
ALERT_SEVERITIES = ("warn", "page")
ALERT_LEVELS = {"ok": 0, "warn": 1, "page": 2}

assert OBJECTIVE_NAMES == spec_mod.OBJECTIVE_NAMES


class _Series:
    """Rolling (t, good, total) deltas for one (class, objective)."""

    def __init__(self) -> None:
        self.points: Deque[Tuple[float, float, float]] = deque()
        self.state = "ok"

    def prune(self, horizon: float) -> None:
        while self.points and self.points[0][0] < horizon:
            self.points.popleft()

    def sums(self, since: float) -> Tuple[float, float]:
        good = total = 0.0
        for t, g, n in reversed(self.points):
            if t < since:
                break
            good += g
            total += n
        return good, total


class SLOEngine:
    def __init__(self, spec: SLOSpec,
                 clock: Callable[[], float],
                 registry=None):
        self.spec = spec
        self.clock = clock
        self.registry = registry
        self.events: List[dict] = []
        self._series: Dict[Tuple[str, str], _Series] = {
            (cls, obj.name): _Series()
            for cls, objectives in spec.classes.items()
            for obj in objectives}
        self._build_metrics(registry)

    # -- metrics ---------------------------------------------------
    def _build_metrics(self, registry) -> None:
        if registry is None:
            self._g_attain = self._g_budget = self._g_burn = None
            self._g_state = self._c_alerts = None
            self._c_good = self._c_events = self._c_evals = None
            return
        R = registry

        def _children(fam):
            return {(cls, obj): fam.labels(
                **{"class": cls, "objective": obj})
                for cls in PRIORITY_CLASSES
                for obj in OBJECTIVE_NAMES}

        g_attain = R.gauge(
            "ome_slo_attainment_ratio",
            "Good/total over the rolling compliance window "
            "(1.0 when the window holds no traffic)",
            labelnames=("class", "objective"))
        g_budget = R.gauge(
            "ome_slo_error_budget_remaining_ratio",
            "1 - bad/(total * (1 - target)) over the compliance "
            "window; <= 0 means the budget is exhausted",
            labelnames=("class", "objective"))
        g_state = R.gauge(
            "ome_slo_alert_state",
            "Current alert severity (0 = ok, 1 = warn, 2 = page)",
            labelnames=("class", "objective"))
        c_good = R.counter(
            "ome_slo_good_events_total",
            "SLO-good events ingested by the evaluator",
            labelnames=("class", "objective"))
        c_events = R.counter(
            "ome_slo_events_total",
            "All events ingested by the evaluator (good + bad)",
            labelnames=("class", "objective"))
        self._g_attain = _children(g_attain)
        self._g_budget = _children(g_budget)
        self._g_state = _children(g_state)
        self._c_good = _children(c_good)
        self._c_events = _children(c_events)
        g_burn = R.gauge(
            "ome_slo_burn_rate",
            "Error-budget burn rate bad_fraction/(1-target) per "
            "alerting window (1.0 = budget spent exactly over one "
            "compliance window)",
            labelnames=("class", "objective", "window"))
        self._g_burn = {
            (cls, obj, w): g_burn.labels(
                **{"class": cls, "objective": obj, "window": w})
            for cls in PRIORITY_CLASSES
            for obj in OBJECTIVE_NAMES
            for w in BURN_WINDOW_NAMES}
        c_alerts = R.counter(
            "ome_slo_alerts_total",
            "Alert-state transitions into warn/page",
            labelnames=("class", "objective", "severity"))
        self._c_alerts = {
            (cls, obj, sev): c_alerts.labels(
                **{"class": cls, "objective": obj, "severity": sev})
            for cls in PRIORITY_CLASSES
            for obj in OBJECTIVE_NAMES
            for sev in ALERT_SEVERITIES}
        self._c_evals = R.counter(
            "ome_slo_evaluations_total",
            "Evaluator passes over every (class, objective) series")

    # -- ingest ----------------------------------------------------
    def observe(self, cls: str, objective: str,
                good: float, total: float) -> None:
        """Record ``total`` new events, ``good`` of them good, for
        one (class, objective) at the current clock instant.
        Unknown pairs (not in the spec) are ignored."""
        series = self._series.get((cls, objective))
        if series is None or total <= 0:
            return
        good = max(0.0, min(good, total))
        series.points.append((self.clock(), good, total))
        if self._c_good is not None:
            self._c_good[(cls, objective)].inc(good)
            self._c_events[(cls, objective)].inc(total)

    # -- evaluate --------------------------------------------------
    def _burn(self, series: _Series, now: float, window_s: float,
              budget: float) -> float:
        good, total = series.sums(now - window_s)
        if total <= 0:
            return 0.0
        return ((total - good) / total) / budget

    def evaluate(self) -> Dict[str, dict]:
        """One evaluation pass; returns the per-class report dict
        (deterministic: sorted keys, rounded floats)."""
        now = self.clock()
        spec = self.spec
        report: Dict[str, dict] = {}
        for cls in sorted(spec.classes):
            cls_report = {}
            for obj in spec.classes[cls]:
                series = self._series[(cls, obj.name)]
                series.prune(now - spec.compliance_window_s)
                good, total = series.sums(now - spec.compliance_window_s)
                budget = obj.budget
                attainment = (round(good / total, 6)
                              if total > 0 else None)
                consumed = (round((total - good) / (total * budget), 6)
                            if total > 0 else 0.0)
                remaining = round(1.0 - consumed, 6)
                burns = {
                    "page_long": round(self._burn(
                        series, now, spec.page.long_s, budget), 6),
                    "page_short": round(self._burn(
                        series, now, spec.page.short_s, budget), 6),
                    "warn_long": round(self._burn(
                        series, now, spec.warn.long_s, budget), 6),
                    "warn_short": round(self._burn(
                        series, now, spec.warn.short_s, budget), 6),
                }
                pf, wf = spec.page.burn_factor, spec.warn.burn_factor
                if (burns["page_long"] >= pf
                        and burns["page_short"] >= pf):
                    state = "page"
                elif (burns["warn_long"] >= wf
                        and burns["warn_short"] >= wf):
                    state = "warn"
                else:
                    state = "ok"
                if state != series.state and state != "ok":
                    self.events.append({
                        "t": round(now, 6), "class": cls,
                        "objective": obj.name, "severity": state,
                        "burn_long": burns["page_long"
                                           if state == "page"
                                           else "warn_long"],
                        "burn_short": burns["page_short"
                                            if state == "page"
                                            else "warn_short"],
                        "budget_consumed": consumed,
                        "budget_remaining": remaining,
                    })
                    if self._c_alerts is not None:
                        self._c_alerts[(cls, obj.name, state)].inc()
                series.state = state
                if self._g_attain is not None:
                    key = (cls, obj.name)
                    self._g_attain[key].set(
                        1.0 if attainment is None else attainment)
                    self._g_budget[key].set(remaining)
                    self._g_state[key].set(ALERT_LEVELS[state])
                    for w, v in burns.items():
                        self._g_burn[(cls, obj.name, w)].set(v)
                cls_report[obj.name] = {
                    "good": round(good, 6),
                    "total": round(total, 6),
                    "attainment": attainment,
                    "target": obj.target,
                    "budget_consumed": consumed,
                    "budget_remaining": remaining,
                    "burn": burns,
                    "alert_state": state,
                }
            report[cls] = cls_report
        if self._c_evals is not None:
            self._c_evals.inc()
        return report

    def max_burn(self) -> float:
        """Fastest page-window long burn across every series — the
        optional autoscale pressure input (docs/autoscaling.md)."""
        now = self.clock()
        worst = 0.0
        for (cls, name), series in self._series.items():
            for obj in self.spec.classes.get(cls, ()):
                if obj.name != name:
                    continue
                worst = max(worst, self._burn(
                    series, now, self.spec.page.long_s, obj.budget))
        return round(worst, 6)

    def alert_state(self) -> Dict[str, str]:
        """{'class/objective': state} snapshot, sorted keys."""
        return {f"{cls}/{name}": s.state
                for (cls, name), s in sorted(self._series.items())}
