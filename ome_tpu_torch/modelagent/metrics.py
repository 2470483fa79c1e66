"""Model-agent metrics (modelagent/metrics.go:50-160 analog).

Now a thin shim over the shared telemetry registry
(ome_tpu_torch/telemetry/) so the model-agent's exposition gets the same
`# HELP`/`# TYPE` correctness, `_total` counter enforcement, and
naming lint as the engine and router — while gopher/cmd callers keep
the original short-name `Metrics` API (`inc`/`observe`/`get`/
`render`/`snapshot`/`reset`).

Port of ome_tpu/modelagent/metrics.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..telemetry import Counter, Gauge, Registry

PREFIX = "model_agent"


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()  # guards family creation/reset
        self._registry = Registry()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    @property
    def registry(self) -> Registry:
        return self._registry

    def inc(self, name: str, amount: float = 1.0):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._registry.counter(f"{PREFIX}_{name}")
                self._counters[name] = c
        c.inc(amount)

    def observe(self, name: str, value: float):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._registry.gauge(f"{PREFIX}_{name}")
                self._gauges[name] = g
        g.set(value)

    def get(self, name: str) -> float:
        with self._lock:
            fam = self._counters.get(name) or self._gauges.get(name)
        return fam.value if fam is not None else 0.0

    def render(self) -> str:
        """Prometheus exposition format (registry-backed)."""
        return self._registry.render()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {name: fam.value
                    for d in (self._counters, self._gauges)
                    for name, fam in d.items()}

    def reset(self):
        # registries are append-only by design; reset (tests only)
        # swaps in a fresh one
        with self._lock:
            self._registry = Registry()
            self._counters.clear()
            self._gauges.clear()


METRICS = Metrics()
