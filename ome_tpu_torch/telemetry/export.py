"""Span-log → Chrome Trace Event JSON (Perfetto) exporter core.

Port of ome_tpu/telemetry/export.py (pure Python, copied whole): the
port's `--span-log` records keep the reference's schema, so the same
exporter reads them. It merges any number of `--span-log` JSONL files
(router, engine replicas, PD prefill peers) — and optionally
flight-recorder dumps — into one Chrome Trace Event document loadable
in Perfetto or `chrome://tracing`. Spans join across processes by
**trace id**; the timeline gets one process track per (component, pid)
— a restarted replica's new incarnation is a new pid and therefore a
new track — and within each process one thread row per trace, so a
request's phases read left-to-right on a single line.

Timestamps: every span record carries `t_start` (epoch seconds,
captured at span start) and `dur_s` (measured on the monotonic clock,
immune to wall steps). The exporter re-bases everything on the
earliest start so the trace opens at t=0; the original epoch lands in
`otherData.epoch_us`.

CLI: `python -m ome_tpu_torch.telemetry.export SPAN_LOG... [-o OUT]`.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, Tuple


def load_spans(paths: Iterable) -> List[dict]:
    """Read span records from JSONL span logs; silently skips blank,
    torn, or non-span lines (a crashed writer's last line may be
    partial — the rest of the log is still good)."""
    out: List[dict] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or rec.get("kind") != "span":
                continue
            if rec.get("t_start") is None or rec.get("dur_s") is None:
                continue
            out.append(rec)
    return out


def load_flight_dumps(paths: Iterable) -> List[dict]:
    out: List[dict] = []
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            out.append(doc)
    return out


def _track_key(rec: dict) -> Tuple[str, int]:
    return (str(rec.get("component") or "unknown"),
            int(rec.get("pid") or 0))


def build_trace(spans: List[dict], flight_docs: Iterable[dict] = (),
                trace_id: Optional[str] = None) -> dict:
    """Assemble the Chrome Trace Event document. `trace_id` filters
    spans to one request; flight events are instant ("i") marks on
    their process's track regardless of trace."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    flight_docs = list(flight_docs)

    # stable integer pid per (component, os pid), ordered by first
    # appearance time so the router lands above the engines it feeds
    tracks: Dict[Tuple[str, int], int] = {}
    for rec in sorted(spans, key=lambda r: r.get("t_start", 0.0)):
        tracks.setdefault(_track_key(rec), len(tracks) + 1)
    for doc in flight_docs:
        key = (str(doc.get("component") or "flight"),
               int(doc.get("pid") or 0))
        tracks.setdefault(key, len(tracks) + 1)

    # one thread row per trace inside each process
    tids: Dict[Tuple[int, str], int] = {}

    starts = [s["t_start"] for s in spans]
    starts += [e.get("t_wall", 0.0) for d in flight_docs
               for e in d["events"]]
    epoch = min(starts) if starts else 0.0

    events: List[dict] = []
    for (component, ospid), pid in sorted(tracks.items(),
                                          key=lambda kv: kv[1]):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{component} (pid {ospid})"}})

    for rec in sorted(spans, key=lambda r: r["t_start"]):
        pid = tracks[_track_key(rec)]
        tkey = (pid, str(rec.get("trace_id") or ""))
        if tkey not in tids:
            tids[tkey] = len([k for k in tids if k[0] == pid]) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tids[tkey],
                "args": {"name": f"trace {tkey[1][:8] or '-'}"}})
        args = {"trace_id": rec.get("trace_id"),
                "span_id": rec.get("span_id"),
                "parent_id": rec.get("parent_id")}
        args.update(rec.get("attrs") or {})
        events.append({
            "name": str(rec.get("name") or "span"),
            "ph": "X",
            "ts": round((rec["t_start"] - epoch) * 1e6, 3),
            "dur": max(1.0, round(rec["dur_s"] * 1e6, 3)),
            "pid": pid,
            "tid": tids[tkey],
            "args": args})

    for doc in flight_docs:
        pid = tracks[(str(doc.get("component") or "flight"),
                      int(doc.get("pid") or 0))]
        for ev in doc["events"]:
            if not isinstance(ev, dict):
                continue
            args = {k: v for k, v in ev.items()
                    if k not in ("event", "t_wall", "t_mono")}
            events.append({
                "name": f"flight:{ev.get('event', '?')}",
                "ph": "i", "s": "p",
                "ts": round((ev.get("t_wall", epoch) - epoch) * 1e6, 3),
                "pid": pid, "tid": 0,
                "args": args})

    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"epoch_us": round(epoch * 1e6, 3),
                          "span_count": len(spans),
                          "trace_filter": trace_id}}


def trace_ids(spans: List[dict]) -> List[str]:
    seen: Dict[str, None] = {}
    for rec in spans:
        tid = rec.get("trace_id")
        if tid and tid not in seen:
            seen[tid] = None
    return list(seen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_export",
        description="Merge --span-log JSONL files (and optional "
                    "flight-recorder dumps) into Chrome Trace Event "
                    "JSON loadable in Perfetto.")
    ap.add_argument("span_logs", nargs="+",
                    help="span-log JSONL files (router/engine/pd)")
    ap.add_argument("--flight", action="append", default=[],
                    help="flight-recorder dump JSON (repeatable)")
    ap.add_argument("--trace", default=None,
                    help="export only this trace id")
    ap.add_argument("--split-by-trace", metavar="DIR", default=None,
                    help="additionally write one trace-<id>.json "
                         "per trace id into DIR")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="merged output path (default: trace.json)")
    args = ap.parse_args(argv)

    spans = load_spans(args.span_logs)
    flights = load_flight_dumps(args.flight)
    doc = build_trace(spans, flights, trace_id=args.trace)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.write("\n")
    print(f"trace_export: {len(spans)} spans, "
          f"{len(flights)} flight dump(s) -> {args.out} "
          f"({len(doc['traceEvents'])} events)")

    if args.split_by_trace:
        import os
        os.makedirs(args.split_by_trace, exist_ok=True)
        for tid in trace_ids(spans):
            per = build_trace(spans, (), trace_id=tid)
            path = f"{args.split_by_trace}/trace-{tid}.json"
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(per, fh, separators=(",", ":"))
                fh.write("\n")
            print(f"trace_export: trace {tid} -> {path}")
    return 0 if spans else 1


if __name__ == "__main__":
    sys.exit(main())
