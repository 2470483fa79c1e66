"""Priority classes for multi-tenant scheduling.

Every request carries one of three classes — ``interactive``,
``standard``, ``batch`` — set via the ``priority`` payload field or
the ``X-OME-Priority`` header (header wins; default ``standard``).
The class drives four decisions end to end:

* **Slot allocation**: the scheduler's weighted deficit round-robin
  picks the next admitted request by class weight (scheduler.py).
* **Admission shedding**: under saturation the per-class queue-wait
  cap sheds the lowest class first — a batch flood 429s batch traffic
  before it can touch interactive admission (scheduler.submit).
* **Preemption**: KV-pressure victim selection ranks slots by class,
  lowest first (core.py `_preempt_victim` via `set_preempt_rank`).
* **Observability**: per-class metrics, reqlog schema v3, journal
  admit records (kill-resume restores the class), router counters,
  and the autoscale pressure signal keyed to the highest class.

This module is dependency-free (no jax, no engine imports) so the
router, chaos harness, and autoscale controller can share the enum
without pulling in the serving stack.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

# Highest-priority first. This tuple is the ONLY legal label set for
# per-class metrics (enforced by the metrics-label-cardinality lint).
PRIORITY_CLASSES = ("interactive", "standard", "batch")

DEFAULT_PRIORITY = "standard"

# WDRR weights: an interactive token-quantum is 8x a batch one. Each
# class still gets a non-zero weight — batch is deprioritized, never
# starved (invariant 5 in the chaos harness).
DEFAULT_CLASS_WEIGHTS: Dict[str, int] = {
    "interactive": 8,
    "standard": 4,
    "batch": 1,
}

# Shedding/preemption order: lower level = victimized/shed first.
CLASS_LEVEL: Dict[str, int] = {
    "batch": 0,
    "standard": 1,
    "interactive": 2,
}

# Per-class queue-wait caps as multipliers of the scheduler's global
# max_queue_wait. standard keeps exactly the historical cap so a
# single-class workload admits identically with priority scheduling
# on or off; interactive is tighter (shed early rather than serve
# late), batch is looser (a deep batch backlog is the point).
DEFAULT_WAIT_CAP_FACTORS: Dict[str, float] = {
    "interactive": 0.25,
    "standard": 1.0,
    "batch": 4.0,
}


def coerce_priority(value: Optional[str],
                    default: str = DEFAULT_PRIORITY) -> str:
    """Validate a user-supplied priority class. None/"" take the
    default; anything outside PRIORITY_CLASSES raises ValueError
    (the server maps that to a 400, never a silent downgrade)."""
    if value is None or value == "":
        return default
    v = str(value).strip().lower()
    if v not in PRIORITY_CLASSES:
        raise ValueError(
            f"unknown priority class {value!r} "
            f"(expected one of {', '.join(PRIORITY_CLASSES)})")
    return v


def class_weights(overrides: Optional[Mapping[str, int]] = None
                  ) -> Dict[str, int]:
    """Full weight table with user overrides folded in; every class
    keeps a weight >= 1 so no class can be configured to starve."""
    w = dict(DEFAULT_CLASS_WEIGHTS)
    for cls, weight in (overrides or {}).items():
        cls = coerce_priority(cls)
        w[cls] = max(1, int(weight))
    return w


def class_wait_caps(max_queue_wait: float,
                    overrides: Optional[Mapping[str, float]] = None
                    ) -> Dict[str, float]:
    """Per-class queue-wait caps in seconds, derived from the global
    cap unless explicitly overridden (seconds, not factors)."""
    caps = {cls: max_queue_wait * DEFAULT_WAIT_CAP_FACTORS[cls]
            for cls in PRIORITY_CLASSES}
    for cls, cap in (overrides or {}).items():
        cls = coerce_priority(cls)
        caps[cls] = float(cap)
    return caps


def highest_class() -> str:
    return PRIORITY_CLASSES[0]


def parse_weight_spec(spec: str) -> Dict[str, int]:
    """Parse a CLI weight spec like ``interactive=8,standard=4,batch=1``
    (partial specs fine — unnamed classes keep defaults)."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad class-weight spec segment {part!r} "
                "(expected class=weight)")
        cls, _, weight = part.partition("=")
        out[coerce_priority(cls)] = int(weight)
    return out
