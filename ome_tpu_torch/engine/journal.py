"""Crash-safe request journal (write-ahead log) for restart resume.

Counterpart of ome_tpu/engine/journal.py, which imports no JAX: the
same records, byte for byte, so a journal either package writes is
replayed by the other's reader.

Durability discipline (docs/durability.md): every admitted request
gets an ``admit`` record (prompt ids, sampling params, absolute
deadline, trace id) before it can occupy a decode slot; as the
scheduler emits tokens, ``prog`` records append the generated-so-far
ids; a normal finish writes a ``fin`` tombstone. On restart, replay
returns every admitted-but-untombstoned request with its accumulated
output, and the scheduler re-admits it with the prompt folded with
those tokens — the same recompute-resume fold paged-KV preemption
uses — so a greedy stream picks up byte-identical to an uninterrupted
run.

Format: one JSON object per line (JSONL), append-only:

    {"t": "admit", "jid": 7, "prompt": [...], "max_new": 64, ...}
    {"t": "prog",  "jid": 7, "toks": [513, 9, ...]}
    {"t": "fin",   "jid": 7, "reason": "stop"}

A crash mid-append leaves a torn tail line; replay drops it (and
repairs the file) rather than refusing to start. Size-triggered
compaction rewrites the file atomically (tmp + fsync + os.replace)
with one admit + one consolidated prog per live request.

Fsync policy (``--journal-fsync``): ``always`` fsyncs after every
append batch (strongest, slowest), ``batch`` (default) fsyncs at most
every ``fsync_interval`` seconds from the scheduler's poll, ``off``
leaves flushing to the OS. Journal I/O failures DEGRADE the journal
(counted, logged once) instead of failing requests: availability wins
over durability for a serving replica.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import faults

log = logging.getLogger("ome.engine.journal")

FILENAME = "requests.jsonl"
FSYNC_POLICIES = ("always", "batch", "off")


@dataclass
class JournalEntry:
    """One unfinished request as reconstructed by replay."""

    jid: int
    prompt_ids: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: List[int] = field(default_factory=list)
    adapter: Optional[str] = None
    # priority class (docs/multi-tenancy.md): restored on resume so a
    # kill -9 cannot launder a batch request into a higher class
    cls: str = "standard"
    # absolute EPOCH seconds (time.time clock): monotonic deadlines do
    # not survive a process restart, so the journal stores wall-clock
    # and the resume path converts back
    deadline_epoch: Optional[float] = None
    trace_id: Optional[str] = None
    output_ids: List[int] = field(default_factory=list)
    # PD provenance stamped by the serving node (e.g. {"mode":
    # "pd-decode", "peers": [...]}): records that this request's
    # prefill came over the PD handoff, so a resumed process knows the
    # replay must re-prefill through its prefill pool (or local
    # fallback) rather than assume local compute produced the KV
    pd: Optional[dict] = None


class _Live:
    """Tracking state for a journaled request still in this process:
    how many of req.output_ids have been written already."""

    __slots__ = ("req", "upto")

    def __init__(self, req):
        self.req = req
        self.upto = len(req.output_ids)


class RequestJournal:
    """Append-only JSONL WAL; thread-safe (scheduler thread appends
    progress, HTTP handler threads append admits and tombstones)."""

    def __init__(self, directory: str, fsync: str = "batch",
                 fsync_interval: float = 0.1,
                 compact_bytes: int = 4 << 20,
                 provenance: Optional[dict] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"journal fsync policy {fsync!r} not in "
                f"{FSYNC_POLICIES}")
        # stamped into every admit record (see JournalEntry.pd); the
        # PD decode role passes its pool topology here
        self.provenance = provenance
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, FILENAME)
        self.fsync = fsync
        self.fsync_interval = fsync_interval
        self.compact_bytes = compact_bytes
        self._lock = threading.RLock()
        # full journal state: jid -> record dict (admit fields +
        # "toks"); finished requests are deleted, so this is exactly
        # what replay returns and what compaction rewrites
        self._state: Dict[int, dict] = {}
        self._live: Dict[int, _Live] = {}
        self._dirty = False          # bytes appended since last fsync
        self._last_fsync = time.monotonic()
        self.degraded = False
        # metrics are optional (bind() wires them); plain ints mirror
        # them so tests can assert without a registry
        self.appends = 0
        self.errors = 0
        self.compactions = 0
        self.replayed = 0
        self._c_appends = self._c_errors = None
        self._c_compactions = self._c_replayed = None
        self._g_bytes = None
        next_jid = self._load()
        self._seq = next_jid
        self._fh = open(self.path, "a", encoding="utf-8")
        self._bytes = os.path.getsize(self.path)

    # -- metrics -------------------------------------------------------

    def bind(self, registry) -> None:
        """Attach journal metrics to the process's shared registry."""
        if registry is None:
            return
        self._c_appends = registry.counter(
            "ome_engine_journal_appends_total",
            "Journal records appended (admit + progress + tombstone)")
        self._c_errors = registry.counter(
            "ome_engine_journal_errors_total",
            "Journal I/O failures (append/fsync/replay); the journal "
            "degrades, serving continues")
        self._c_compactions = registry.counter(
            "ome_engine_journal_compactions_total",
            "Size-triggered journal compactions")
        self._c_replayed = registry.counter(
            "ome_engine_journal_replayed_requests_total",
            "Unfinished requests re-admitted from journal replay")
        self._g_bytes = registry.gauge(
            "ome_engine_journal_bytes",
            "Current journal file size in bytes")
        self._g_bytes.set(self._bytes)

    def _count(self, counter, attr: str, by: int = 1):
        setattr(self, attr, getattr(self, attr) + by)
        if counter is not None:
            counter.inc(by)

    # -- load / replay -------------------------------------------------

    def _load(self) -> int:
        """Scan an existing journal into _state; repair a torn tail
        line (crash mid-append) by truncating it. Returns the next
        free jid."""
        if not os.path.exists(self.path):
            return 0
        max_jid = -1
        good_end = 0
        with open(self.path, "rb") as fh:
            data = fh.read()
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                # no terminating newline: a torn tail from a crash
                # mid-append — drop it
                log.warning("journal: dropping torn tail line "
                            "(%d bytes)", len(data) - pos)
                break
            line = data[pos:nl]
            pos = nl + 1
            if not line.strip():
                good_end = pos
                continue
            try:
                rec = json.loads(line)
                kind = rec["t"]
                jid = int(rec["jid"])
            except (ValueError, KeyError, TypeError):
                if pos >= len(data):
                    # torn-but-newline-terminated tail (crash between
                    # the partial write and the newline of the NEXT
                    # record is impossible, but a truncated filesystem
                    # can produce it): drop, don't keep good_end
                    log.warning("journal: dropping corrupt tail line")
                    break
                # mid-file garbage: skip the record, keep the rest
                log.warning("journal: skipping corrupt mid-file line")
                good_end = pos
                continue
            if kind == "admit":
                rec.setdefault("toks", [])
                self._state[jid] = rec
            elif kind == "prog":
                entry = self._state.get(jid)
                if entry is not None:
                    entry["toks"] = list(entry.get("toks", [])) + [
                        int(t) for t in rec.get("toks", [])]
            elif kind == "fin":
                self._state.pop(jid, None)
            max_jid = max(max_jid, jid)
            good_end = pos
        if good_end < len(data):
            # repair in place so future appends start on a clean line
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)
        return max_jid + 1

    def replay(self) -> List[JournalEntry]:
        """Unfinished requests from the journal this process opened,
        oldest admission first. The caller (Scheduler.resume_from_
        journal) re-submits them with prompt+output folded."""
        faults.fire("journal_replay")
        out = []
        with self._lock:
            for jid in sorted(self._state):
                rec = self._state[jid]
                out.append(JournalEntry(
                    jid=jid,
                    prompt_ids=[int(t) for t in rec.get("prompt", [])],
                    max_new_tokens=int(rec.get("max_new", 64)),
                    temperature=float(rec.get("temp", 0.0)),
                    top_k=int(rec.get("top_k", 0)),
                    top_p=float(rec.get("top_p", 1.0)),
                    stop_ids=[int(t) for t in rec.get("stop", [])],
                    adapter=rec.get("adapter"),
                    cls=rec.get("cls", "standard"),
                    deadline_epoch=rec.get("deadline"),
                    trace_id=rec.get("trace"),
                    output_ids=[int(t) for t in rec.get("toks", [])],
                    pd=rec.get("pd")))
        return out

    def note_replayed(self, n: int):
        self._count(self._c_replayed, "replayed", n)

    # -- append paths --------------------------------------------------

    def _append(self, rec: dict):
        """Append one record; caller holds self._lock. Failures
        degrade the journal instead of propagating into the serving
        path."""
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            faults.fire("journal_append")
            self._fh.write(line)
            self._fh.flush()
        except Exception as e:  # noqa: BLE001 — durability must not
            # take down availability
            self._degrade("append", e)
            return
        self._bytes += len(line)
        self._dirty = True
        self._count(self._c_appends, "appends")
        if self._g_bytes is not None:
            self._g_bytes.set(self._bytes)
        if self.fsync == "always":
            self._fsync()

    def _fsync(self):
        if not self._dirty:
            return
        try:
            faults.fire("journal_fsync")
            os.fsync(self._fh.fileno())
        except Exception as e:  # noqa: BLE001
            self._degrade("fsync", e)
            return
        self._dirty = False
        self._last_fsync = time.monotonic()

    def _degrade(self, op: str, err: Exception):
        self._count(self._c_errors, "errors")
        if not self.degraded:
            self.degraded = True
            log.error("journal %s failed (%s); journal DEGRADED — "
                      "serving continues without durability", op, err)

    # -- request lifecycle ---------------------------------------------

    def admit(self, req) -> None:
        """Durably record an admitted request. A request replayed from
        this journal already carries its jid — it is re-registered for
        progress tracking without a duplicate admit record."""
        with self._lock:
            jid = getattr(req, "journal_id", None)
            if jid is not None and jid in self._state:
                self._live[jid] = _Live(req)
                return
            if jid is None:
                jid = self._seq
                self._seq += 1
                req.journal_id = jid
            deadline_epoch = None
            if req.deadline is not None:
                # convert the scheduler's monotonic deadline to epoch
                # so it survives the restart
                deadline_epoch = time.time() + (
                    req.deadline - time.monotonic())
            rec = {"t": "admit", "jid": jid,
                   "prompt": [int(t) for t in req.prompt_ids],
                   "max_new": int(req.max_new_tokens),
                   "temp": float(req.temperature),
                   "top_k": int(req.top_k),
                   "top_p": float(req.top_p),
                   "stop": [int(t) for t in req.stop_ids],
                   "adapter": req.adapter,
                   "cls": getattr(req, "priority", "standard"),
                   "deadline": deadline_epoch,
                   "trace": getattr(req.trace, "trace_id", None)}
            if self.provenance is not None:
                rec["pd"] = self.provenance
            self._append(rec)
            rec = dict(rec)
            rec["toks"] = []
            self._state[jid] = rec
            self._live[jid] = _Live(req)

    def _flush_one(self, jid: int, live: _Live):
        """Append a prog record for tokens emitted since the last
        flush; caller holds self._lock."""
        toks = live.req.output_ids
        n = len(toks)
        if n <= live.upto:
            return
        fresh = [int(t) for t in toks[live.upto:n]]
        live.upto = n
        self._append({"t": "prog", "jid": jid, "toks": fresh})
        entry = self._state.get(jid)
        if entry is not None:
            entry["toks"] = list(entry.get("toks", [])) + fresh

    def poll(self) -> None:
        """Scheduler-cadence maintenance: flush per-request progress,
        apply the batch fsync policy, compact when oversized. Called
        from the scheduler thread at each step boundary — every token
        a client has seen is journaled by the time the step returns."""
        with self._lock:
            for jid, live in list(self._live.items()):
                self._flush_one(jid, live)
            if self.fsync == "batch" and self._dirty and (
                    time.monotonic() - self._last_fsync
                    >= self.fsync_interval):
                self._fsync()
            if self._bytes > self.compact_bytes:
                self._compact()

    def finish(self, req, resumable: bool = False) -> None:
        """Request reached a terminal state in THIS process.

        ``resumable=False`` (the work is done: stop/length/timeout/
        per-request error) writes a tombstone. ``resumable=True``
        (the PROCESS is going away with the work unfinished — a
        drain-timeout ``shutdown`` eviction, or an ``engine_fault``
        from a dead scheduler about to be replaced) instead flushes
        the final progress and leaves the entry live, so the next
        process replays and resumes it. The scheduler decides which —
        it knows whether the finish was a crash or a completion."""
        jid = getattr(req, "journal_id", None)
        if jid is None:
            return
        with self._lock:
            live = self._live.pop(jid, None)
            if live is not None:
                self._flush_one(jid, live)
            if resumable:
                self._fsync()
                return
            self._append({"t": "fin", "jid": jid,
                          "reason": req.finish_reason})
            self._state.pop(jid, None)

    # -- compaction ----------------------------------------------------

    def _compact(self):
        """Atomically rewrite the journal with one admit + one
        consolidated prog per live entry; caller holds self._lock."""
        tmp = self.path + ".tmp"
        try:
            faults.fire("journal_append")  # compaction is an append path
            with open(tmp, "w", encoding="utf-8") as fh:
                for jid in sorted(self._state):
                    rec = dict(self._state[jid])
                    toks = rec.pop("toks", [])
                    fh.write(json.dumps(rec, separators=(",", ":"))
                             + "\n")
                    if toks:
                        fh.write(json.dumps(
                            {"t": "prog", "jid": jid, "toks": toks},
                            separators=(",", ":")) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self._bytes = os.path.getsize(self.path)
            self._dirty = False
            self._last_fsync = time.monotonic()
            self._count(self._c_compactions, "compactions")
            if self._g_bytes is not None:
                self._g_bytes.set(self._bytes)
        except Exception as e:  # noqa: BLE001
            self._degrade("compact", e)
            try:
                os.remove(tmp)
            except OSError:
                pass

    # -- teardown ------------------------------------------------------

    def flush(self) -> None:
        """Flush all pending progress and fsync regardless of policy
        (drain/shutdown path)."""
        with self._lock:
            for jid, live in list(self._live.items()):
                self._flush_one(jid, live)
            self._fsync()

    def close(self) -> None:
        with self._lock:
            try:
                self.flush()
                self._fh.close()
            except Exception:  # noqa: BLE001 — already shutting down
                pass
