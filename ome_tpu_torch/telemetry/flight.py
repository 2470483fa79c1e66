"""Engine flight recorder: a bounded ring of lifecycle events.

The scheduler narrates what it DID — admissions, slot assignments,
preempt+fold cycles, pipeline drains, speculative accept counts, PD
failovers, crash recoveries, drains, journal compactions — into a
fixed-size in-memory ring (`collections.deque(maxlen=...)`), so a
postmortem can ask "what were the last N decisions before the fault"
without any log volume while healthy. Recording is one short lock +
dict append; eviction is implicit in the deque bound.

Three consumers (docs/tracing-timeline.md):

  * `GET /debug/events?n=` on the engine server serves the tail as
    JSON (guarded: operator opt-in via `--debug-endpoints`);
  * crash recovery (`Scheduler._recover`) auto-dumps the ring to a
    file before rebuilding device state, so the events leading INTO
    the fault survive even if the process never serves again;
  * the chaos harness grabs per-child dumps into the violation replay
    bundle.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional


class FlightRecorder:
    """Lock-cheap bounded event ring. `record()` is safe from any
    thread and never blocks on I/O; `dump()` snapshots under the same
    lock and writes outside it."""

    def __init__(self, capacity: int = 2048, component: str = "engine"):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self.component = component
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0

    def record(self, event: str, **fields) -> int:
        """Append one event; returns its sequence number. Fields must
        be small scalars (ids, counts) — the ring is bookkeeping, not
        a payload store."""
        rec = {"event": event,
               "t_wall": round(time.time(), 6),
               "t_mono": time.monotonic()}
        if fields:
            rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(rec)
            return self._seq

    @property
    def recorded(self) -> int:
        """Total events ever recorded (monotonic, survives eviction)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted from the ring by the capacity bound."""
        with self._lock:
            return self._dropped

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """The most recent `n` events (all, when n is None/<=0),
        oldest first; each is a copy, so callers can serialize without
        racing `record`."""
        with self._lock:
            events = list(self._buf)
        if n is not None and n > 0:
            events = events[-n:]
        return [dict(e) for e in events]

    def state(self) -> dict:
        with self._lock:
            return {"component": self.component,
                    "capacity": self.capacity,
                    "recorded": self._seq,
                    "dropped": self._dropped,
                    "buffered": len(self._buf)}

    def dump(self, path: str, reason: str = "") -> str:
        """Write the whole ring (plus counters) to `path` as one JSON
        document; returns the path. Used by crash recovery and the
        chaos violation bundle."""
        doc = self.state()
        doc["reason"] = reason
        doc["pid"] = os.getpid()
        doc["dumped_at"] = round(time.time(), 6)
        doc["events"] = self.snapshot()
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"), default=str)
            fh.write("\n")
        os.replace(tmp, path)
        return path
