"""Request traces: the replay subsystem's workload representation.

Port of ome_tpu/autoscale/trace.py: the same seeds give the same
traces, and `load_reqlog` reads the port's request logs
(telemetry/reqlog.py).

A trace is an ordered list of (arrival offset, prompt length, output
budget) tuples. Three sources produce one:

  * ``load_reqlog`` — a production engine reqlog JSONL (schema v2
    admit timestamps, or the v1 ``ts - e2e_s`` derivation via
    ``telemetry.reqlog.admit_times``), preserving the ORIGINAL
    inter-arrival gaps;
  * ``synthetic_trace`` — a seeded generator with a deliberate burst
    window, for tests and the autoscale soak;
  * ``load_trace`` — a trace file previously written by
    ``save_trace`` (JSONL round-trip).

Transforms: ``compress`` divides every gap by a factor (replay an
hour of traffic in minutes); ``amplify_bursts`` duplicates the
requests inside the busiest window (what-if: the same trace with a
sharper spike). Both are deterministic.
"""

from __future__ import annotations

import json
import math
import pathlib
import random
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Union

from ..telemetry import reqlog as _reqlog

# ByteTokenizer maps one printable char to ~one token, so prompt TEXT
# of length N reproduces a logged prompt_tokens of N closely enough
# for replay (exactness is not required: the scheduler packs by the
# tokenized length it computes itself)
_PROMPT_ALPHABET = "abcdefgh "


@dataclass
class TraceRequest:
    """One request in a trace. ``arrival`` is seconds after trace
    start; ``prompt`` (explicit text) wins over ``prompt_tokens``
    (synthesized text of that length) when both are set."""

    arrival: float
    prompt_tokens: int
    max_tokens: int
    temperature: float = 0.0
    trace_id: Optional[str] = None
    prompt: Optional[str] = None
    # priority class (priority.py); None replays as the
    # engine default so pre-v3 traces behave unchanged
    priority: Optional[str] = None

    def prompt_text(self, seed: int = 0) -> str:
        if self.prompt is not None:
            return self.prompt
        # deterministic in (seed, prompt_tokens) ONLY — repeated
        # lengths repeat prompts, which keeps greedy byte-comparison
        # oracles cacheable and exercises the prefix cache
        rng = random.Random(f"trace-prompt:{seed}:{self.prompt_tokens}")
        return "".join(rng.choice(_PROMPT_ALPHABET)
                       for _ in range(max(1, self.prompt_tokens)))


def load_reqlog(path: Union[str, pathlib.Path]) -> List[TraceRequest]:
    """Engine reqlog JSONL -> trace, arrivals rebased to the first
    admit. Router records and torn lines are skipped; v1 records
    (no admit fields) fall back to the ``ts - e2e_s`` derivation."""
    raw: List[tuple] = []
    text = pathlib.Path(path).read_text(encoding="utf-8",
                                        errors="replace")
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail, like journal replay
        if rec.get("component") == "router":
            continue
        wall, _ = _reqlog.admit_times(rec)
        if wall is None or rec.get("prompt_tokens") is None:
            continue
        raw.append((wall, rec))
    raw.sort(key=lambda t: t[0])
    if not raw:
        return []
    t0 = raw[0][0]
    out = []
    for wall, rec in raw:
        out.append(TraceRequest(
            arrival=round(wall - t0, 6),
            prompt_tokens=int(rec["prompt_tokens"]),
            max_tokens=max(1, int(rec.get("output_tokens") or 1)),
            temperature=float(rec.get("temperature") or 0.0),
            trace_id=rec.get("trace_id"),
            priority=rec.get("class")))
    return out


def synthetic_trace(seed: int, n: int = 40, base_rate: float = 4.0,
                    burst_start: float = 0.35, burst_end: float = 0.65,
                    burst_factor: float = 4.0,
                    prompt_tokens: Sequence[int] = (4, 12),
                    max_tokens: Sequence[int] = (6, 16),
                    greedy_fraction: float = 1.0
                    ) -> List[TraceRequest]:
    """Seeded bursty workload: exponential inter-arrival gaps at
    ``base_rate`` req/s, multiplied by ``burst_factor`` inside the
    [burst_start, burst_end) fraction of the request sequence. Fully
    deterministic in its arguments — the property the run-to-run
    identical-decisions test leans on."""
    rng = random.Random(f"autoscale-trace:{seed}")
    out: List[TraceRequest] = []
    at = 0.0
    for i in range(n):
        frac = i / max(1, n - 1)
        rate = base_rate * (burst_factor
                            if burst_start <= frac < burst_end else 1.0)
        if i:
            at += rng.expovariate(rate)
        greedy = rng.random() < greedy_fraction
        out.append(TraceRequest(
            arrival=round(at, 6),
            prompt_tokens=rng.randint(*prompt_tokens),
            max_tokens=rng.randint(*max_tokens),
            temperature=0.0 if greedy else 0.7,
            trace_id=f"syn-{seed}-{i}"))
    return out


def diurnal_trace(seed: int, n: int = 500, period_s: float = 120.0,
                  base_rate: float = 2.0, peak_factor: float = 4.0,
                  cycles: float = 2.0,
                  prompt_tokens: Sequence[int] = (4, 12),
                  max_tokens: Sequence[int] = (6, 16)
                  ) -> List[TraceRequest]:
    """Seeded diurnal workload: a sinusoidal arrival rate swinging
    between ``base_rate`` and ``base_rate * peak_factor`` over
    ``cycles`` periods of ``period_s`` seconds — the canonical
    scale-up-by-day / scale-down-by-night shape the autoscaler's
    no-oscillation regression replays. Fully deterministic in its
    arguments (same seeding discipline as synthetic_trace)."""
    if peak_factor < 1.0:
        raise ValueError("peak_factor must be >= 1")
    rng = random.Random(f"autoscale-trace:{seed}")
    out: List[TraceRequest] = []
    at = 0.0
    horizon = period_s * cycles
    for i in range(n):
        # rate at the CURRENT point of the cycle; trough at t=0 so a
        # min-size fleet starts calm and the first peak forces the
        # first scale-up
        phase = 2.0 * math.pi * (at / period_s)
        swing = 0.5 * (1.0 - math.cos(phase))  # 0 at trough, 1 at peak
        rate = base_rate * (1.0 + (peak_factor - 1.0) * swing)
        if i:
            at += rng.expovariate(rate)
        if at > horizon:
            break
        out.append(TraceRequest(
            arrival=round(at, 6),
            prompt_tokens=rng.randint(*prompt_tokens),
            max_tokens=rng.randint(*max_tokens),
            temperature=0.0,
            trace_id=f"diurnal-{seed}-{i}"))
    return out


def flash_crowd_trace(seed: int, n: int = 400,
                      base_rate: float = 2.0,
                      crowd_at: float = 30.0,
                      crowd_duration: float = 10.0,
                      crowd_factor: float = 10.0,
                      prompt_tokens: Sequence[int] = (4, 12),
                      max_tokens: Sequence[int] = (6, 16)
                      ) -> List[TraceRequest]:
    """Seeded flash crowd: steady ``base_rate`` arrivals with a
    ``crowd_factor`` x rate spike in the ``crowd_duration`` seconds
    starting at ``crowd_at`` — a step change, not a ramp, which is
    what stresses the policy's stability windows (react fast, don't
    flap when the crowd leaves). Deterministic in its arguments."""
    if crowd_factor < 1.0:
        raise ValueError("crowd_factor must be >= 1")
    rng = random.Random(f"autoscale-trace:{seed}")
    out: List[TraceRequest] = []
    at = 0.0
    for i in range(n):
        in_crowd = crowd_at <= at < crowd_at + crowd_duration
        rate = base_rate * (crowd_factor if in_crowd else 1.0)
        if i:
            at += rng.expovariate(rate)
        out.append(TraceRequest(
            arrival=round(at, 6),
            prompt_tokens=rng.randint(*prompt_tokens),
            max_tokens=rng.randint(*max_tokens),
            temperature=0.0,
            trace_id=f"flash-{seed}-{i}"))
    return out


def merge_traces(*traces: Sequence[TraceRequest]
                 ) -> List[TraceRequest]:
    """Overlay traces on one timeline, sorted by arrival — e.g. a
    diurnal baseline plus a flash crowd landing mid-cycle."""
    out: List[TraceRequest] = []
    for tr in traces:
        out.extend(tr)
    out.sort(key=lambda r: r.arrival)
    return out


def compress(trace: Sequence[TraceRequest],
             factor: float) -> List[TraceRequest]:
    """Divide every arrival offset by ``factor`` (>1 = faster)."""
    if factor <= 0:
        raise ValueError("compression factor must be > 0")
    return [TraceRequest(arrival=round(r.arrival / factor, 6),
                         prompt_tokens=r.prompt_tokens,
                         max_tokens=r.max_tokens,
                         temperature=r.temperature,
                         trace_id=r.trace_id, prompt=r.prompt,
                         priority=r.priority)
            for r in trace]


def _busiest_window(trace: Sequence[TraceRequest],
                    width: float) -> float:
    """Start of the ``width``-second window holding the most
    arrivals (the trace's burst, whatever produced it)."""
    best_start, best_n = 0.0, -1
    arrivals = [r.arrival for r in trace]
    for i, start in enumerate(arrivals):
        n = sum(1 for a in arrivals[i:] if a < start + width)
        if n > best_n:
            best_start, best_n = start, n
    return best_start


def amplify_bursts(trace: Sequence[TraceRequest], factor: int,
                   seed: int = 0,
                   window: float = 2.0) -> List[TraceRequest]:
    """Duplicate every request inside the busiest ``window`` seconds
    ``factor - 1`` extra times, with small seeded arrival jitter so
    the copies don't land on the same instant. factor=1 is the
    identity."""
    if factor < 1:
        raise ValueError("amplification factor must be >= 1")
    out = list(trace)
    if factor == 1 or not trace:
        return sorted(out, key=lambda r: r.arrival)
    rng = random.Random(f"autoscale-amplify:{seed}")
    start = _busiest_window(trace, window)
    for r in trace:
        if not (start <= r.arrival < start + window):
            continue
        for k in range(factor - 1):
            out.append(TraceRequest(
                arrival=round(r.arrival + rng.uniform(0.0, 0.2), 6),
                prompt_tokens=r.prompt_tokens,
                max_tokens=r.max_tokens,
                temperature=r.temperature,
                trace_id=(f"{r.trace_id}-amp{k}"
                          if r.trace_id else None),
                prompt=r.prompt,
                priority=r.priority))
    out.sort(key=lambda r: r.arrival)
    return out


def save_trace(trace: Sequence[TraceRequest],
               path: Union[str, pathlib.Path]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        for r in trace:
            rec = {k: v for k, v in asdict(r).items() if v is not None}
            fh.write(json.dumps(rec, separators=(",", ":")) + "\n")


def load_trace(path: Union[str, pathlib.Path]) -> List[TraceRequest]:
    out = []
    text = pathlib.Path(path).read_text(encoding="utf-8")
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        out.append(TraceRequest(
            arrival=float(rec["arrival"]),
            prompt_tokens=int(rec["prompt_tokens"]),
            max_tokens=int(rec["max_tokens"]),
            temperature=float(rec.get("temperature", 0.0)),
            trace_id=rec.get("trace_id"), prompt=rec.get("prompt"),
            priority=rec.get("priority")))
    out.sort(key=lambda r: r.arrival)
    return out
