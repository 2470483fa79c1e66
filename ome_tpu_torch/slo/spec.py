"""Declarative SLO specs: schema-versioned, per-class objectives (port
of ome_tpu/slo/spec.py; its simulator-scaled `sim_spec` is not part of
the port).

The spec file (``config/slo.json``) mirrors the cost-table idiom: a
``schema_version`` gate so stale specs fail loudly, then plain data.
Each priority class carries a list of objectives; each objective is
either a **latency** objective (fraction of requests whose metric is
<= ``threshold_s`` must be >= ``target``) or an **availability**
objective (fraction of non-5xx/non-timeout outcomes >= ``target``).

Burn rate for an objective over a window W is
``bad_fraction(W) / (1 - target)`` — 1.0 means the error budget is
being consumed exactly at the rate that exhausts it over one
compliance window.  The maximum achievable burn is ``1/(1-target)``
(every request bad): a 14.4x page threshold is unreachable when the
target leaves a 5% budget.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..priority import PRIORITY_CLASSES

SLO_SCHEMA_VERSION = 1

# every objective name the evaluator knows how to source; latency
# names map to per-class engine histogram families (docs/slo.md)
OBJECTIVE_NAMES = ("ttft", "tpot", "e2e", "queue_wait", "availability")
OBJECTIVE_KINDS = ("latency", "availability")


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window alert rule: page or warn severity."""
    long_s: float
    short_s: float
    burn_factor: float

    def validate(self, label: str) -> None:
        if not (self.long_s > self.short_s > 0):
            raise ValueError(
                f"slo window {label!r}: need long_s > short_s > 0, "
                f"got {self.long_s}/{self.short_s}")
        if self.burn_factor <= 0:
            raise ValueError(
                f"slo window {label!r}: burn_factor must be > 0")


@dataclass(frozen=True)
class Objective:
    name: str                       # one of OBJECTIVE_NAMES
    kind: str                       # "latency" | "availability"
    target: float                   # good fraction, in (0, 1)
    threshold_s: Optional[float] = None   # latency objectives only

    @property
    def budget(self) -> float:
        """Allowed bad fraction (1 - target)."""
        return 1.0 - self.target

    def validate(self, cls: str) -> None:
        if self.name not in OBJECTIVE_NAMES:
            raise ValueError(
                f"slo class {cls!r}: unknown objective {self.name!r} "
                f"(expected one of {OBJECTIVE_NAMES})")
        if self.kind not in OBJECTIVE_KINDS:
            raise ValueError(
                f"slo class {cls!r}: unknown kind {self.kind!r}")
        if (self.kind == "availability") != (self.name == "availability"):
            raise ValueError(
                f"slo class {cls!r}: objective {self.name!r} has "
                f"mismatched kind {self.kind!r}")
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"slo class {cls!r}/{self.name}: target must be in "
                f"(0, 1), got {self.target}")
        if self.kind == "latency":
            if self.threshold_s is None or self.threshold_s <= 0:
                raise ValueError(
                    f"slo class {cls!r}/{self.name}: latency "
                    "objective needs threshold_s > 0")
        elif self.threshold_s is not None:
            raise ValueError(
                f"slo class {cls!r}/{self.name}: availability "
                "objective takes no threshold_s")


@dataclass(frozen=True)
class SLOSpec:
    compliance_window_s: float
    page: BurnWindow
    warn: BurnWindow
    classes: Dict[str, Tuple[Objective, ...]] = field(
        default_factory=dict)

    def validate(self) -> "SLOSpec":
        if self.compliance_window_s <= 0:
            raise ValueError("slo spec: compliance_window_s must "
                             "be > 0")
        self.page.validate("page")
        self.warn.validate("warn")
        if self.page.burn_factor <= self.warn.burn_factor:
            raise ValueError(
                "slo spec: page burn_factor must exceed warn "
                "burn_factor (page is the faster burn)")
        if not self.classes:
            raise ValueError("slo spec: no classes defined")
        for cls, objectives in self.classes.items():
            if cls not in PRIORITY_CLASSES:
                raise ValueError(
                    f"slo spec: unknown class {cls!r} (expected one "
                    f"of {PRIORITY_CLASSES})")
            if not objectives:
                raise ValueError(
                    f"slo class {cls!r}: no objectives")
            names = [o.name for o in objectives]
            if len(names) != len(set(names)):
                raise ValueError(
                    f"slo class {cls!r}: duplicate objective names")
            for obj in objectives:
                obj.validate(cls)
        return self

    def to_doc(self) -> dict:
        """Plain-JSON echo of the spec (reports embed this)."""
        classes = {}
        for cls in sorted(self.classes):
            objs = []
            for o in self.classes[cls]:
                d = {"name": o.name, "kind": o.kind,
                     "target": o.target}
                if o.threshold_s is not None:
                    d["threshold_s"] = o.threshold_s
                objs.append(d)
            classes[cls] = {"objectives": objs}
        return {
            "schema_version": SLO_SCHEMA_VERSION,
            "compliance_window_s": self.compliance_window_s,
            "windows": {
                "page": {"long_s": self.page.long_s,
                         "short_s": self.page.short_s,
                         "burn_factor": self.page.burn_factor},
                "warn": {"long_s": self.warn.long_s,
                         "short_s": self.warn.short_s,
                         "burn_factor": self.warn.burn_factor},
            },
            "classes": classes,
        }


def _window(doc: dict, label: str) -> BurnWindow:
    try:
        w = doc["windows"][label]
        return BurnWindow(long_s=float(w["long_s"]),
                          short_s=float(w["short_s"]),
                          burn_factor=float(w["burn_factor"]))
    except (KeyError, TypeError) as exc:
        raise ValueError(
            f"slo spec: bad or missing windows.{label}: {exc}")


def from_doc(doc: dict) -> SLOSpec:
    ver = doc.get("schema_version")
    if ver != SLO_SCHEMA_VERSION:
        raise ValueError(
            f"slo spec schema_version {ver!r} != "
            f"{SLO_SCHEMA_VERSION} — regenerate config/slo.json "
            "against the current spec format (docs/slo.md)")
    classes: Dict[str, Tuple[Objective, ...]] = {}
    for cls, body in dict(doc.get("classes") or {}).items():
        objs = []
        for o in (body or {}).get("objectives", []):
            objs.append(Objective(
                name=str(o.get("name")),
                kind=str(o.get("kind")),
                target=float(o.get("target", 0.0)),
                threshold_s=(float(o["threshold_s"])
                             if o.get("threshold_s") is not None
                             else None)))
        classes[cls] = tuple(objs)
    spec = SLOSpec(
        compliance_window_s=float(doc.get("compliance_window_s", 0)),
        page=_window(doc, "page"),
        warn=_window(doc, "warn"),
        classes=classes)
    return spec.validate()


def load(path: str) -> SLOSpec:
    """Load and validate a spec file (``config/slo.json``)."""
    with open(path) as fh:
        return from_doc(json.load(fh))

