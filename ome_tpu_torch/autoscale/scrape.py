"""Prometheus text-exposition client for the scaling controller and
the fleet SLO rollup (`SharedScraper`); port of
ome_tpu/autoscale/scrape.py.

The controller decides from the SAME metrics a human would read on a
dashboard — the engines' `ome_engine_ttft_seconds` /
`ome_engine_queue_wait_seconds` histograms, the KV-utilization gauge,
and the router's per-backend gauges — so there is no privileged side
channel to drift from the observable truth.

Histograms are cumulative since process start; a controller wants the
RECENT distribution. ``HistogramWindow`` keeps the previous scrape's
cumulative buckets per (backend, family) and differences them, which
yields the distribution of observations BETWEEN two scrapes; p99 is
estimated by linear interpolation inside the bucket containing the
target rank (the standard histogram_quantile estimator). A counter
reset (engine restart) makes deltas negative — the window discards
that sample and re-bases, same discipline as chaos.MetricsWatch.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Tuple

from ..chaos import _http

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[str, float]:
    """Exposition body -> {'name{labels}': value} (labels verbatim,
    in source order)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = m.group("labels")
        key = m.group("name") + ("{" + labels + "}" if labels else "")
        out[key] = value
    return out


def split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """'name{a="x",b="y"}' -> ('name', {'a': 'x', 'b': 'y'})."""
    name, brace, rest = key.partition("{")
    if not brace:
        return name, {}
    return name, {m.group(1): m.group(2)
                  for m in _LABEL_RE.finditer(rest[:-1])}


def fetch_metrics(url: str, timeout: float = 5.0) -> Dict[str, float]:
    """Scrape ``url``/metrics into a parsed sample dict."""
    status, body = _http(url.rstrip("/") + "/metrics", timeout=timeout)
    if status != 200:
        raise OSError(f"/metrics answered {status} at {url}")
    if isinstance(body, bytes):
        body = body.decode("utf-8", errors="replace")
    elif not isinstance(body, str):
        body = str(body)
    return parse_exposition(body)


def bucket_counts(samples: Dict[str, float], family: str,
                  label_filter: Optional[Dict[str, str]] = None
                  ) -> List[Tuple[float, float]]:
    """Cumulative (upper_bound, count) pairs for one histogram
    family, summed across label children, sorted by bound (+Inf
    last). ``label_filter`` restricts to children matching every
    given label pair (e.g. {"class": "interactive"} narrows a
    per-class histogram to one tenant class)."""
    acc: Dict[float, float] = {}
    prefix = family + "_bucket"
    for key, value in samples.items():
        name, labels = split_key(key)
        if name != prefix or "le" not in labels:
            continue
        if label_filter and any(labels.get(k) != v
                                for k, v in label_filter.items()):
            continue
        le = labels["le"]
        bound = math.inf if le == "+Inf" else float(le)
        acc[bound] = acc.get(bound, 0.0) + value
    return sorted(acc.items(), key=lambda kv: kv[0])


def quantile_from_buckets(buckets: List[Tuple[float, float]],
                          q: float) -> Optional[float]:
    """histogram_quantile over cumulative buckets: find the bucket
    holding rank q*count, interpolate linearly inside it. The +Inf
    bucket clamps to the last finite bound (Prometheus convention).

    Sentinel: returns None — never NaN, never a division error —
    when there is no estimate at all: an empty list, an all-zero
    window (total <= 0), or a +Inf-only window (every observation
    beyond every finite bound, so no finite bound to clamp to)."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in buckets:
        if count >= rank:
            if math.isinf(bound):
                # rank falls beyond every finite bound: clamp to the
                # last finite bound; with no finite bucket at all
                # (+Inf-only window) there is nothing to clamp to
                return prev_bound if len(buckets) > 1 else None
            if count == prev_count:
                return bound
            frac = (rank - prev_count) / (count - prev_count)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_count = (0.0 if math.isinf(bound) else bound,
                                  count)
    return buckets[-1][0] if not math.isinf(buckets[-1][0]) else None


class HistogramWindow:
    """Windowed quantiles for one histogram family across scrapes.

    ``update(source, samples)`` ingests a scrape for one source
    (backend URL); ``quantile(q)`` answers over the observations that
    arrived between the previous update and this one, across ALL
    sources. Counter resets re-base silently. ``labels`` narrows the
    family to matching children (per-class SLO windows).

    ``clock`` is optional and injection-only — the window itself
    keeps NO hidden wall-clock default. When a clock is injected
    (the controller passes its own, real or virtual), every update
    is stamped and ``staleness(source)`` answers how old a source's
    latest scrape is in that clock's units; without one, the window
    is purely scrape-ordered, exactly as before."""

    def __init__(self, family: str,
                 labels: Optional[Dict[str, str]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.family = family
        self.labels = dict(labels) if labels else None
        self.clock = clock
        self._prev: Dict[str, List[Tuple[float, float]]] = {}
        self._window: Dict[str, List[Tuple[float, float]]] = {}
        self._updated_at: Dict[str, float] = {}
        self._incarnation: Dict[str, object] = {}

    def update(self, source: str, samples: Dict[str, float],
               incarnation: Optional[object] = None) -> None:
        """Ingest one scrape. ``incarnation`` (engine restart
        counter, when the source exposes one) forces a re-base when
        it changes: a restarted engine's counters restart from zero
        and can grow PAST the pre-restart values by the next scrape,
        which the counts-went-backwards check alone cannot see — the
        delta would silently mix pre- and post-restart windows."""
        cur = bucket_counts(samples, self.family, self.labels)
        prev = self._prev.get(source)
        self._prev[source] = cur
        if self.clock is not None:
            self._updated_at[source] = self.clock()
        rebased = (incarnation is not None
                   and incarnation != self._incarnation.get(source))
        if incarnation is not None:
            self._incarnation[source] = incarnation
        if prev is None or rebased or len(prev) != len(cur):
            self._window.pop(source, None)
            return
        delta = []
        for (b_cur, c_cur), (b_prev, c_prev) in zip(cur, prev):
            if b_cur != b_prev or c_cur < c_prev:
                self._window.pop(source, None)  # reset/restart
                return
            delta.append((b_cur, c_cur - c_prev))
        self._window[source] = delta

    def forget(self, source: str) -> None:
        self._prev.pop(source, None)
        self._window.pop(source, None)
        self._updated_at.pop(source, None)
        self._incarnation.pop(source, None)

    def staleness(self, source: str) -> Optional[float]:
        """Clock units since ``source`` was last updated; None when
        no clock was injected or the source was never seen."""
        if self.clock is None:
            return None
        at = self._updated_at.get(source)
        return None if at is None else self.clock() - at

    def window_count(self) -> float:
        return sum(d[-1][1] for d in self._window.values() if d)

    def merged(self) -> List[Tuple[float, float]]:
        """Cumulative (bound, count) deltas merged across sources —
        the fleet-wide distribution of observations that arrived
        between the last two scrapes of each source."""
        merged: Dict[float, float] = {}
        for delta in self._window.values():
            for bound, count in delta:
                merged[bound] = merged.get(bound, 0.0) + count
        return sorted(merged.items(), key=lambda kv: kv[0])

    def quantile(self, q: float) -> Optional[float]:
        return quantile_from_buckets(self.merged(), q)


def count_le(buckets: List[Tuple[float, float]],
             threshold: float) -> float:
    """Observations <= ``threshold`` in cumulative (bound, count)
    pairs: exact when the threshold sits on a bucket bound (SLO specs
    pick thresholds on DEFAULT_BUCKETS bounds for exactly this
    reason), linearly interpolated inside the containing bucket
    otherwise."""
    if not buckets:
        return 0.0
    prev_bound, prev_count = 0.0, 0.0
    for bound, count in buckets:
        if math.isinf(bound):
            return count if math.isinf(threshold) else prev_count
        if bound == threshold:
            return count
        if bound > threshold:
            if bound == prev_bound:
                return count
            frac = (threshold - prev_bound) / (bound - prev_bound)
            return prev_count + (count - prev_count) * max(
                0.0, min(1.0, frac))
        prev_bound, prev_count = bound, count
    return buckets[-1][1]


class CounterWindow:
    """Windowed deltas for one counter family across scrapes, with
    the same reset/incarnation re-basing discipline as
    HistogramWindow. ``label_filter`` narrows to matching children;
    ``total()`` sums each source's delta between its last two
    updates."""

    def __init__(self, family: str,
                 label_filter: Optional[Dict[str, str]] = None):
        self.family = family
        self.labels = dict(label_filter) if label_filter else None
        self._prev: Dict[str, float] = {}
        self._delta: Dict[str, float] = {}
        self._incarnation: Dict[str, object] = {}

    def _value(self, samples: Dict[str, float]) -> float:
        tot = 0.0
        for key, value in samples.items():
            name, labels = split_key(key)
            if name != self.family:
                continue
            if self.labels and any(labels.get(k) != v
                                   for k, v in self.labels.items()):
                continue
            tot += value
        return tot

    def update(self, source: str, samples: Dict[str, float],
               incarnation: Optional[object] = None) -> None:
        cur = self._value(samples)
        prev = self._prev.get(source)
        self._prev[source] = cur
        rebased = (incarnation is not None
                   and incarnation != self._incarnation.get(source))
        if incarnation is not None:
            self._incarnation[source] = incarnation
        if prev is None or rebased or cur < prev:
            self._delta.pop(source, None)
            return
        self._delta[source] = cur - prev

    def forget(self, source: str) -> None:
        self._prev.pop(source, None)
        self._delta.pop(source, None)
        self._incarnation.pop(source, None)

    def total(self) -> float:
        return sum(self._delta.values())


class SharedScraper:
    """One /metrics fetch per backend per tick, many consumers.

    The autoscale controller and the fleet SLO rollup both scrape
    every backend each tick; fetching twice not only doubles load,
    it hands the two consumers DIFFERENT cumulative counters for the
    "same" instant. SharedScraper memoizes one result — or one
    raised OSError — per URL, reused while
    ``clock() - fetched_at <= max_age`` (0.0 = same-instant only). Without an injected clock the
    scraper degrades to a counting passthrough: every call fetches.

    ``fetches`` counts underlying HTTP fetches so regression tests
    can assert the one-fetch-per-backend-per-tick contract.
    """

    def __init__(self, fetch_fn: Callable[..., Dict[str, float]]
                 = fetch_metrics,
                 clock: Optional[Callable[[], float]] = None,
                 max_age: float = 0.0):
        self.fetch_fn = fetch_fn
        self.clock = clock
        self.max_age = max_age
        self.fetches = 0
        self._cache: Dict[str, Tuple[
            float, Optional[Dict[str, float]], Optional[OSError]]] = {}

    def fetch(self, url: str) -> Dict[str, float]:
        if self.clock is not None:
            now = self.clock()
            ent = self._cache.get(url)
            if ent is not None and now - ent[0] <= self.max_age:
                if ent[2] is not None:
                    raise ent[2]
                return ent[1]
        self.fetches += 1
        try:
            result = self.fetch_fn(url)
        except OSError as exc:
            if self.clock is not None:
                self._cache[url] = (now, None, exc)
            raise
        if self.clock is not None:
            self._cache[url] = (now, result, None)
        return result

    def forget(self, url: str) -> None:
        self._cache.pop(url, None)
