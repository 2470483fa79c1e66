"""Telemetry for the port: metrics, tracing, request logs, flight ring.

Copied from ome_tpu/telemetry (pure Python, no framework): the engine
server and the scheduler emit the same metric names, spans and JSONL
records as the reference, so dashboards and the router read the port
the same way. Four pieces, each usable alone:

  * registry  — labeled Counters/Gauges/Histograms + text 0.0.4
                exposition (`Registry.render()` IS the /metrics body);
  * tracing   — W3C traceparent SpanContext plus Span/SpanLog timed
                phase records (`--span-log`);
  * flight    — bounded in-memory ring of scheduler lifecycle events
                (`GET /debug/events?n=`, crash-dumped on recovery);
  * reqlog    — per-request JSONL records (`--request-log`).

Two more modules are imported on their own: `profiler` (the on-demand
torch.profiler capture behind `POST /debug/profile`) and `export` (span
logs to a Chrome trace, `python -m ome_tpu_torch.telemetry.export`).
"""

from .flight import FlightRecorder
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       MetricFamily, Registry, escape_label_value,
                       format_value)
from .reqlog import RequestLog
from .tracing import (TRACEPARENT_HEADER, Span, SpanContext, SpanLog,
                      coerce_span_log, from_headers, new_trace,
                      parse_traceparent)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "FlightRecorder", "Gauge",
    "Histogram", "MetricFamily", "Registry", "RequestLog", "Span",
    "SpanContext", "SpanLog", "TRACEPARENT_HEADER",
    "coerce_span_log", "escape_label_value", "format_value",
    "from_headers", "new_trace", "parse_traceparent",
]
