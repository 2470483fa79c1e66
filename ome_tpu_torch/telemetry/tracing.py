"""Request-lifecycle tracing: trace ids, per-hop span ids, and spans.

The wire format is the W3C `traceparent` header
(`00-<32 hex trace id>-<16 hex span id>-<2 hex flags>`) so traces
originated here interoperate with any surrounding mesh (Istio
sidecars, cloud load balancers) that already speaks it. The router
mints a trace per incoming request (or adopts the caller's), forwards
a CHILD span to the engine, and both ends stamp the ids into their
JSONL request logs — one grep correlates a slow client response with
the exact engine replica, queue wait, and decode phase that produced
it (docs/observability.md).

On top of id propagation, `Span` + `SpanLog` record actual timed
phases (`--span-log`): each span carries a start wall timestamp, a
duration measured on the monotonic clock, the parent span id, and a
bounded attribute dict. One JSONL record per finished span; records
from router, engine, and PD logs merge by trace id into a Chrome
Trace / Perfetto timeline via `scripts/trace_export.py`
(docs/tracing-timeline.md).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from dataclasses import dataclass, replace
from typing import IO, Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

TRACEPARENT_HEADER = "traceparent"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 lowercase hex chars
    span_id: str   # 16 lowercase hex chars
    flags: str = "01"  # sampled

    def child(self) -> "SpanContext":
        """New span in the same trace (one per forwarding hop)."""
        return replace(self, span_id=os.urandom(8).hex())

    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


def new_trace() -> SpanContext:
    return SpanContext(trace_id=os.urandom(16).hex(),
                       span_id=os.urandom(8).hex())


def parse_traceparent(value) -> "SpanContext | None":
    """Strict parse; anything malformed yields None (the caller mints
    a fresh trace rather than propagating garbage ids)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(str(value).strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None  # forbidden version per the spec
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # all-zero ids are invalid
    return SpanContext(trace_id=trace_id, span_id=span_id, flags=flags)


def from_headers(headers) -> SpanContext:
    """Adopt the caller's context from an http.server headers mapping,
    or mint a fresh trace when absent/malformed."""
    ctx = parse_traceparent(headers.get(TRACEPARENT_HEADER))
    return ctx if ctx is not None else new_trace()


# -- spans ---------------------------------------------------------------

# Attribute bounds: spans ride the serving hot path, so an attrs dict
# must never become an unbounded payload (a prompt, a token list).
# Oversize values are truncated, surplus keys dropped — the span stays
# cheap and the log line stays greppable.
MAX_SPAN_ATTRS = 16
MAX_ATTR_CHARS = 256


class Span:
    """One timed phase. Start is captured on BOTH clocks (wall for
    cross-process alignment, monotonic for the duration); `end()`
    computes the duration from the monotonic clock only, so a wall
    clock step mid-span cannot produce a negative or inflated span."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "start_wall", "start_mono", "dur_s", "attrs")

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 start_mono: Optional[float] = None,
                 start_wall: Optional[float] = None):
        self.name = name
        self.trace_id = trace_id or os.urandom(16).hex()
        self.span_id = span_id or os.urandom(8).hex()
        self.parent_id = parent_id
        self.start_mono = (time.monotonic() if start_mono is None
                           else start_mono)
        self.start_wall = time.time() if start_wall is None else start_wall
        self.dur_s: Optional[float] = None
        self.attrs: dict = {}

    @classmethod
    def begin(cls, name: str, ctx: Optional[SpanContext] = None,
              parent_id: Optional[str] = None, **kw) -> "Span":
        """Start a span inside an existing trace context; the context's
        span id becomes the parent unless one is given explicitly."""
        if ctx is not None:
            kw.setdefault("trace_id", ctx.trace_id)
            parent_id = ctx.span_id if parent_id is None else parent_id
        return cls(name, parent_id=parent_id, **kw)

    def set(self, **attrs) -> "Span":
        for key, value in attrs.items():
            if len(self.attrs) >= MAX_SPAN_ATTRS and key not in self.attrs:
                break
            if isinstance(value, str) and len(value) > MAX_ATTR_CHARS:
                value = value[:MAX_ATTR_CHARS]
            self.attrs[key] = value
        return self

    def end(self, end_mono: Optional[float] = None) -> "Span":
        end_mono = time.monotonic() if end_mono is None else end_mono
        # omelint: disable=thread-shared-state -- a span is owned by one thread until end(); readers see it only after the hand-off
        self.dur_s = max(0.0, end_mono - self.start_mono)
        return self

    def record(self) -> dict:
        rec = {"kind": "span", "name": self.name,
               "trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id,
               "t_start": round(self.start_wall, 6),
               "dur_s": (None if self.dur_s is None
                         else round(self.dur_s, 9))}
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec


class SpanLog:
    """Thread-safe JSONL span sink (`--span-log`); a None path makes
    it a no-op so instrumentation sites never branch. Each record is
    stamped with the writing component and pid — the pid is what
    separates incarnations of a restarted process on the exported
    timeline."""

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None,
                 component: str = ""):
        self.path = path
        self.component = component
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = stream
        if path:
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def write(self, span, **extra):
        """Write a finished Span (or a prebuilt record dict). A span
        still open when written is ended at the write timestamp."""
        if self._fh is None:
            return
        if isinstance(span, Span):
            if span.dur_s is None:
                span.end()
            rec = span.record()
        else:
            rec = dict(span)
        rec.setdefault("component", self.component)
        rec.setdefault("pid", os.getpid())
        if extra:
            rec.update(extra)
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None and self.path:
                self._fh.close()
            self._fh = None


def coerce_span_log(value, component: str = "") -> SpanLog:
    """Accept a SpanLog, a path, or None (disabled) — the form every
    server constructor takes for its span_log parameter."""
    if isinstance(value, SpanLog):
        return value
    return SpanLog(path=value, component=component)
