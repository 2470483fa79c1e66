"""Structured JSONL request log (`--request-log`).

One JSON object per line per finished request, written append-only
and flushed immediately so a crashed replica's log is still complete
up to the fault. The record carries the trace id minted/adopted by
tracing.py, which is what makes router and engine logs joinable:
`grep <trace_id> router.jsonl engine.jsonl` reconstructs a request's
full path. Schema documented in docs/observability.md.

Schema v2 (the trace-replay contract, docs/autoscaling.md): engine
records additionally carry the ADMIT timestamps — `admit_ts` (wall
clock) and `admit_mono` (the process monotonic clock) — so a replay
harness can reconstruct the original inter-arrival gaps exactly
instead of approximating them from finish times. v1 logs (PRs 2-8)
stay loadable: `admit_times()` derives the admit instant from
`ts - e2e_s` when the explicit fields are absent.

Schema v3 (multi-tenancy, docs/multi-tenancy.md): engine records
carry `class` — the request's priority class (one of the fixed
enum in ome_tpu/priority.py) — so per-class SLO replay and the
fairness invariants read tenancy straight off the log. v1/v2
records stay loadable; readers default a missing `class` to
"standard".
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Optional, Tuple


class RequestLog:
    """Thread-safe JSONL sink; a None path makes it a no-op so call
    sites never need an `if log is not None` dance."""

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO[str]] = None):
        self.path = path
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = stream
        if path:
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def write(self, record: dict):
        if self._fh is None:
            return
        rec = {"ts": round(time.time(), 6)}
        rec.update(record)
        line = json.dumps(rec, separators=(",", ":"),
                          default=str) + "\n"
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


def coerce(value) -> RequestLog:
    """Accept a RequestLog, a path, or None (disabled) — the form
    every server constructor takes for its request_log parameter."""
    if isinstance(value, RequestLog):
        return value
    return RequestLog(path=value)


def admit_times(record: dict) -> Tuple[Optional[float],
                                       Optional[float]]:
    """(admit wall-clock, admit monotonic) for a request record.

    Schema v2 records carry both explicitly (`admit_ts`,
    `admit_mono`). For v1 records — every engine log written before
    the replay subsystem — the wall-clock admit instant is DERIVED
    as `ts - e2e_s` (the sink stamps `ts` at the finish write, and
    `e2e_s` spans admission→finish), and the monotonic half is None.
    Returns (None, None) when the record has neither form (router
    records, torn lines)."""
    wall = record.get("admit_ts")
    mono = record.get("admit_mono")
    if wall is not None:
        return float(wall), (float(mono) if mono is not None
                             else None)
    ts, e2e = record.get("ts"), record.get("e2e_s")
    if ts is not None and e2e is not None:
        return float(ts) - float(e2e), None
    return None, None
