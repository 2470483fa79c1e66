"""Fleet SLO engine: error budgets and burn-rate alerting (port of
ome_tpu/slo/, the part the router's --slo-spec reaches).

Declarative per-class objectives (config/slo.json) evaluated over
rolling windows by a deterministic engine on an injected clock; the
router ticks a `FleetRollup` on wall time.  docs/slo.md covers the
spec format, the multi-window multi-burn-rate alert policy, and the
fleet rollup.
"""

from .spec import SLOSpec, Objective, BurnWindow, load
from .engine import SLOEngine
from .rollup import FleetRollup

__all__ = [
    "SLOSpec", "Objective", "BurnWindow", "load",
    "SLOEngine", "FleetRollup",
]
