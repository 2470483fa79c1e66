"""Labeled metrics registry, Prometheus text exposition format 0.0.4.

The shared observability core every /metrics emitter in the repo sits
on (engine server, router, modelagent — the surfaces the reference's
operator scrapes for KEDA autoscaling and prober health). Zero
dependencies by design: a Registry owns metric FAMILIES (Counter,
Gauge, Histogram), each family owns label-keyed children, and
`render()` produces a scrape body with correct `# HELP`/`# TYPE`
lines, `_total`-suffixed counters, and `_bucket`/`_sum`/`_count`
histogram series.

Concurrency: every family takes its own leaf lock around child
creation and value updates, so callers may hold unrelated locks (the
scheduler's stats lock, the router's selection lock) while bumping a
metric without deadlock risk, and a scrape racing updates always sees
a parseable, internally consistent family.

Naming conventions (enforced here and by scripts/check_metrics.py):
counters end in `_total`; histograms must not claim reserved
suffixes; metric names carry a subsystem prefix (`ome_*` /
`model_agent_*`); label NAMES are declared up front so unbounded
label cardinality has to be introduced deliberately.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

# the Prometheus client-library default latency buckets (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# suffixes a histogram's series claim for themselves; a scalar metric
# ending in one of these would collide with (or masquerade as) them
_RESERVED_SUFFIXES = ("_bucket", "_sum", "_count")


def escape_label_value(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:  # NaN
        return "NaN"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_suffix(labelnames: Sequence[str],
                   labelvalues: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [(n, v) for n, v in zip(labelnames, labelvalues)]
    pairs.extend(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{escape_label_value(v)}"' for n, v in pairs)
    return "{" + inner + "}"


class _Child:
    __slots__ = ("_family", "_labelvalues")

    def __init__(self, family: "MetricFamily",
                 labelvalues: Tuple[str, ...]):
        self._family = family
        self._labelvalues = labelvalues


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self.value = 0.0

    def inc(self, by: float = 1.0):
        if by < 0:
            raise ValueError("counters only go up (use a gauge)")
        with self._family._lock:
            self.value += by


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        self.value = 0.0

    def set(self, value: float):
        with self._family._lock:
            self.value = float(value)

    def inc(self, by: float = 1.0):
        with self._family._lock:
            self.value += by

    def dec(self, by: float = 1.0):
        self.inc(-by)


class _HistogramChild(_Child):
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, family, labelvalues):
        super().__init__(family, labelvalues)
        # one slot per finite bucket + the +Inf catch-all
        self.bucket_counts = [0] * (len(family.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        with self._family._lock:
            self.bucket_counts[bisect.bisect_left(
                self._family.buckets, v)] += 1
            self.sum += v
            self.count += 1


class MetricFamily:
    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple[str, ...], _Child]" = \
            OrderedDict()
        if not self.labelnames:
            self._default = self._make_child(())
        else:
            self._default = None

    def _make_child(self, values: Tuple[str, ...]):
        child = self._child_cls(self, values)
        self._children[values] = child
        return child

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass labels positionally OR by name")
            try:
                values = tuple(str(kw.pop(n)) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
            if kw:
                raise ValueError(
                    f"unexpected labels {sorted(kw)} for {self.name}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
            return child

    def _require_unlabeled(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; "
                "use .labels(...)")
        return self._default

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}"
                 if self.help else f"# HELP {self.name} {self.name}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            lines.extend(self._render_child(values, child))
        return lines

    def _render_child(self, values, child) -> List[str]:
        suffix = _labels_suffix(self.labelnames, values)
        return [f"{self.name}{suffix} {format_value(child.value)}"]

    def samples(self) -> Dict[str, float]:
        """Flat {sample_name: value} view (tests, health bodies)."""
        out: Dict[str, float] = {}
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            suffix = _labels_suffix(self.labelnames, values)
            if isinstance(child, _HistogramChild):
                out[f"{self.name}_count{suffix}"] = child.count
                out[f"{self.name}_sum{suffix}"] = child.sum
            else:
                out[f"{self.name}{suffix}"] = child.value
        return out


class Counter(MetricFamily):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, by: float = 1.0):
        self._require_unlabeled().inc(by)

    @property
    def value(self) -> float:
        return self._require_unlabeled().value


class Gauge(MetricFamily):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float):
        self._require_unlabeled().set(value)

    def inc(self, by: float = 1.0):
        self._require_unlabeled().inc(by)

    def dec(self, by: float = 1.0):
        self._require_unlabeled().dec(by)

    @property
    def value(self) -> float:
        return self._require_unlabeled().value


class Histogram(MetricFamily):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        bl = sorted(float(b) for b in buckets)
        if not bl:
            raise ValueError("histogram needs at least one bucket")
        if len(set(bl)) != len(bl):
            raise ValueError("duplicate histogram buckets")
        if bl and bl[-1] == math.inf:
            bl = bl[:-1]  # +Inf is implicit
        self.buckets: Tuple[float, ...] = tuple(bl)
        super().__init__(name, help, labelnames)

    def observe(self, value: float):
        self._require_unlabeled().observe(value)

    @property
    def count(self) -> int:
        return self._require_unlabeled().count

    @property
    def sum(self) -> float:
        return self._require_unlabeled().sum

    def _render_child(self, values, child) -> List[str]:
        lines = []
        with self._lock:
            counts = list(child.bucket_counts)
            total, s = child.count, child.sum
        acc = 0
        for ub, n in zip(self.buckets, counts):
            acc += n
            suffix = _labels_suffix(self.labelnames, values,
                                    extra=[("le", format_value(ub))])
            lines.append(f"{self.name}_bucket{suffix} {acc}")
        suffix = _labels_suffix(self.labelnames, values,
                                extra=[("le", "+Inf")])
        lines.append(f"{self.name}_bucket{suffix} {total}")
        plain = _labels_suffix(self.labelnames, values)
        lines.append(f"{self.name}_sum{plain} {format_value(s)}")
        lines.append(f"{self.name}_count{plain} {total}")
        return lines


class Registry:
    """Thread-safe collection of metric families.

    Declarations are idempotent: re-declaring the same (name, kind,
    labelnames) returns the existing family, so independent modules
    can share one registry without handing metric objects around; a
    conflicting re-declaration raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, MetricFamily]" = OrderedDict()

    def _declare(self, cls, name: str, help: str,
                 labelnames: Sequence[str], **kw) -> MetricFamily:
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{existing.kind}{existing.labelnames}")
                return existing
            fam = cls(name, help=help, labelnames=labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        if not name.endswith("_total"):
            raise ValueError(
                f"counter {name!r} must end in '_total'")
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        if name.endswith(_RESERVED_SUFFIXES) or \
                name.endswith("_total"):
            raise ValueError(
                f"histogram {name!r} must not end in a reserved "
                f"suffix {_RESERVED_SUFFIXES + ('_total',)}")
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def render(self) -> str:
        with self._lock:
            fams = list(self._families.values())
        lines: List[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            fams = list(self._families.values())
        out: Dict[str, float] = {}
        for fam in fams:
            out.update(fam.samples())
        return out

    def get(self, name: str, **labels) -> Optional[float]:
        """Sample value lookup by family name (+ labels); histograms
        resolve to their _count. None for an undeclared family."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            return None
        child = fam.labels(**labels) if labels or fam.labelnames \
            else fam._default
        if isinstance(child, _HistogramChild):
            return float(child.count)
        return float(child.value)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())
