"""Tick-based hysteresis scaling policy (pure decision logic).

Port of ome_tpu/autoscale/policy.py, line for line: the same pressure
series gives the same decision sequence in both packages.

The controller reduces each pool's scraped signals to one PRESSURE
number: observed/SLO, so 1.0 means "exactly at the objective". The
policy turns the pressure series into size decisions with three
stabilizers (the Autopilot recipe — PAPERS.md: scale up fast, scale
down reluctantly, never flap):

  * consecutive-tick thresholds: pressure must exceed
    ``up_threshold`` for ``up_stable_ticks`` ticks to add capacity,
    and sit below ``down_threshold`` for ``down_stable_ticks`` to
    remove it (down >> up, because a wrong scale-down costs SLO
    while a wrong scale-up costs only machines);
  * a post-action cooldown window in which no further decision fires
    (capacity changes take effect with lag — a second decision made
    from pre-lag metrics double-counts);
  * [min_size, max_size] clamps.

Deliberately clockless: ticks, not seconds, are the unit, so a given
pressure series maps to EXACTLY one decision sequence regardless of
wall-clock jitter — the property the seeded-replay determinism test
asserts. The controller owns the tick cadence.

There is consequently no hidden wall-clock default anywhere in this
module: the optional ``clock`` a PoolPolicy accepts is injection-only
(the controller passes its own — real or virtual — so decisions can
be timestamped), and a policy built without one never reads time at
all. Under the simulator's virtual clock the same pressure series
therefore yields the same decisions AND the same timestamps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class PolicyConfig:
    min_size: int = 1
    max_size: int = 4
    up_threshold: float = 1.0
    down_threshold: float = 0.5
    up_stable_ticks: int = 2
    down_stable_ticks: int = 5
    cooldown_ticks: int = 3
    step: int = 1

    def validate(self) -> "PolicyConfig":
        if self.min_size < 0 or self.max_size < max(1, self.min_size):
            raise ValueError(
                f"bad size bounds [{self.min_size}, {self.max_size}]")
        if self.down_threshold >= self.up_threshold:
            raise ValueError(
                "down_threshold must sit below up_threshold "
                f"({self.down_threshold} >= {self.up_threshold})")
        if min(self.up_stable_ticks, self.down_stable_ticks) < 1:
            raise ValueError("stability windows must be >= 1 tick")
        return self


class PoolPolicy:
    """One pool's decision state. ``decide(size, pressure)`` returns
    the target size for this tick (== size means hold).

    ``clock`` is optional and injection-only (no wall-clock default):
    when present, ``last_action_at`` records the clock reading of the
    most recent scale action — the controller injects its own clock
    so real and simulated runs stamp decisions identically."""

    def __init__(self, config: PolicyConfig,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config.validate()
        self.clock = clock
        self.last_action_at: Optional[float] = None
        self._above = 0      # consecutive ticks at/over up_threshold
        self._below = 0      # consecutive ticks under down_threshold
        self._cooldown = 0   # ticks until the next action may fire

    def decide(self, size: int, pressure: float) -> int:
        cfg = self.config
        if pressure >= cfg.up_threshold:
            self._above += 1
            self._below = 0
        elif pressure < cfg.down_threshold:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return self._clamp(size)
        if self._above >= cfg.up_stable_ticks:
            target = min(size + cfg.step, cfg.max_size)
            if target != size:
                self._arm()
                return target
        elif self._below >= cfg.down_stable_ticks:
            target = max(size - cfg.step, cfg.min_size)
            if target != size:
                self._arm()
                return target
        return self._clamp(size)

    def _arm(self):
        self._above = 0
        self._below = 0
        self._cooldown = self.config.cooldown_ticks
        if self.clock is not None:
            self.last_action_at = self.clock()

    def _clamp(self, size: int) -> int:
        return min(max(size, self.config.min_size),
                   self.config.max_size)
