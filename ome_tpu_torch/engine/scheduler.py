"""Continuous-batching scheduler (port of ome_tpu/engine/scheduler.py).

Host-side orchestration around InferenceEngine's ops: admit pending
requests into free slots (prefill + insert), then run decode steps for
the whole batch, streaming tokens out to per-request queues. One
scheduler thread drives decode; request threads (HTTP handlers) only
touch queues.

Prefill/decode overlap: with `overlap` on, prefill runs on a dedicated
admission thread, so the decode cadence never waits for a prefill to
complete; `insert` is the only synchronization point. A slot semaphore
paces admission: the thread holds at most max_slots prefills ahead of
their inserts, and a finished request releases its slot back.

Decode pipelining: with `pipeline_depth` 1 the tokens of step k are read
on the host only after step k+1 was dispatched (the engine queues their
host copy behind the step), hiding the host-side bubble; depth 0 reads
every step synchronously. `_plan_step` / `_execute` keep the reference's
planner/executor shape; in this slice every plan is a plain decode step.

Failure semantics: an engine-step fault fails only the in-flight batch;
queued requests survive, the decode state is rebuilt after an
exponential-backoff pause, and admission resumes — up to `max_restarts`
consecutive attempts, after which the scheduler goes permanently dead.
Status is tri-state: `ok`, `degraded` (recovering — requests queue),
`dead`.

Paged KV: admission checks the block pool before a prefill — a request
whose worst case exceeds the whole pool is refused (`_fits_pool`), one
whose prompt does not fit the free blocks waits in the requeue
(`_pool_ready`), and an insert that still finds the pool short
(KVPoolExhausted) is requeued. Decode-time growth preempts victims
ranked by `_preempt_rank`; their generated tokens fold into the prompt
of the requeued request. `/metrics` carries the pool gauges.

Not in this slice (the serve flags that would need them refuse):
speculative verify, multi-token chunks, grammar masks, the request
journal, PD and cross-replica prefix fetches and the program cost
ledger / HBM accountant gauges.
"""

from __future__ import annotations

import collections
import itertools
import logging
import math
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import faults
from ..priority import CLASS_LEVEL, DEFAULT_PRIORITY, PRIORITY_CLASSES
from ..priority import class_wait_caps as _wait_caps_table
from ..priority import class_weights as _weights_table
from ..telemetry import Registry
from ..telemetry.flight import FlightRecorder
from ..telemetry.tracing import Span, coerce_span_log, new_trace
from .core import (DecodeState, InferenceEngine, KVPoolExhausted,
                   UnknownAdapterError)

_ids = itertools.count()

log = logging.getLogger("ome.engine")

# engine-step latencies cluster well under the Prometheus default
# buckets' floor; extend downward so the histogram resolves per-step
# time instead of lumping everything into the first bucket
STEP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5)

# stats-key -> help text; every counter the scheduler keeps is
# mirrored into the shared registry under ome_engine_<key>
_COUNTER_HELP = {
    "requests_total": "Requests submitted to the scheduler",
    "tokens_generated_total": "Decode tokens emitted across requests",
    "prefill_total": "Prefill forwards executed",
    "decode_steps_total": "Batched decode steps executed",
    "preemptions_total": "Sequences preempted by KV pool pressure",
    "kv_requeues_total": "Requests held back at admission by KV pool "
                         "backpressure (prompt does not fit the free "
                         "blocks, or the insert found the pool short), "
                         "each counted once",
    "timeouts_total": "Requests finished with finish_reason=timeout",
    "rejected_total": "Requests rejected at admission (429)",
    "engine_faults_total": "Engine-step faults (crash recovery runs)",
    "restarts_total": "Successful scheduler crash recoveries",
}


class StepPlan:
    """One scheduler iteration's device work, decided at plan time.
    In this slice the only kind is a plain decode step; `sync` drains
    its tokens right after dispatch."""

    __slots__ = ("kind", "sync")

    def __init__(self, kind: str = "decode", sync: bool = False):
        self.kind = kind
        self.sync = sync


# WDRR quantum: deficit credit per class visit is weight x this many
# tokens — large enough that one visit usually covers a typical head
# request in one accumulation, small enough that a giant
# max_new_tokens request cannot monopolize a rotation
QUANTUM_TOKENS = 64


class ClassQueues:
    """Per-priority-class pending queues with a weighted deficit
    round-robin pick order (Shreedhar & Varghese DRR), presenting the
    queue.Queue surface the scheduler and its callers use: `maxsize`
    (per-class bound), `qsize()`, `empty()`, `put_nowait()` raising
    queue.Full, `get(timeout)`/`get_nowait()` raising queue.Empty, and
    a flat `.queue` snapshot view.

    Each pick visits classes in a fixed rotation; a visit credits the
    class's deficit counter with weight x QUANTUM_TOKENS and the head
    request is served once the deficit covers its cost (its
    max_new_tokens budget), staying on the class while credit lasts. A
    class that empties forfeits its banked deficit. With a single class
    enqueued — or with ``enabled=False`` — every pick degenerates to
    plain FIFO."""

    def __init__(self, maxsize: int, weights=None,
                 enabled: bool = True):
        self.maxsize = maxsize
        self.enabled = bool(enabled)
        self.classes = PRIORITY_CLASSES
        self.weights = _weights_table(weights)
        self._default_class = DEFAULT_PRIORITY
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._q: Dict[str, "collections.deque[Request]"] = {
            c: collections.deque() for c in self.classes}
        self._deficit = {c: 0.0 for c in self.classes}
        self._cursor = 0
        # True when the cursor has just ARRIVED at a class: the quantum
        # is credited once per arrival, not once per pick
        self._fresh = True

    def _cls(self, req) -> str:
        if not self.enabled:
            return self._default_class
        cls = getattr(req, "priority", self._default_class)
        return cls if cls in self._q else self._default_class

    def qsize(self, cls: Optional[str] = None) -> int:
        with self._lock:
            if cls is not None:
                return len(self._q.get(cls, ()))
            return sum(len(d) for d in self._q.values())

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {c: len(d) for c, d in self._q.items()}

    def empty(self) -> bool:
        return self.qsize() == 0

    @property
    def queue(self) -> List["Request"]:
        """Flat snapshot (highest class first, FIFO within class)."""
        with self._lock:
            out: List[Request] = []
            for c in self.classes:
                out.extend(self._q[c])
            return out

    def put_nowait(self, req: "Request") -> None:
        with self._lock:
            dq = self._q[self._cls(req)]
            if self.maxsize and len(dq) >= self.maxsize:
                raise queue.Full
            dq.append(req)
            self._not_empty.notify()

    def _pick_locked(self) -> Optional["Request"]:
        if all(not d for d in self._q.values()):
            return None
        n = len(self.classes)
        while True:
            cls = self.classes[self._cursor % n]
            dq = self._q[cls]
            if not dq:
                # an empty class forfeits banked credit (classic DRR)
                self._deficit[cls] = 0.0
                self._cursor += 1
                self._fresh = True
                continue
            cost = max(int(dq[0].max_new_tokens), 1)
            if self._fresh:
                self._deficit[cls] += (self.weights[cls]
                                       * QUANTUM_TOKENS)
                self._fresh = False
            if self._deficit[cls] >= cost:
                self._deficit[cls] -= cost
                return dq.popleft()
            self._cursor += 1
            self._fresh = True

    def get_nowait(self) -> "Request":
        with self._lock:
            req = self._pick_locked()
        if req is None:
            raise queue.Empty
        return req

    def get(self, timeout: Optional[float] = None) -> "Request":
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._not_empty:
            while True:
                req = self._pick_locked()
                if req is not None:
                    return req
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._not_empty.wait(remaining)


class SchedulerOverloaded(RuntimeError):
    """The pending queue would exceed a bounded wait; the client should
    back off for `retry_after` seconds (HTTP 429/Retry-After)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class SchedulerDraining(RuntimeError):
    """The replica is draining: in-flight work finishes, new admissions
    answer 503 + Retry-After so the client resubmits elsewhere."""

    def __init__(self, msg: str, retry_after: float = 2.0):
        super().__init__(msg)
        self.retry_after = retry_after


@dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_ids: Sequence[int] = ()
    # multi-LoRA adapter name; None = base (the only model served here)
    adapter: Optional[str] = None
    # multi-tenant priority class: drives the WDRR pick order and the
    # per-class admission caps
    priority: str = DEFAULT_PRIORITY
    # absolute time.monotonic() deadline; an expired request is shed at
    # admission or finished mid-decode with finish_reason="timeout"
    deadline: Optional[float] = None
    # request-lifecycle tracing: the SpanContext the HTTP layer adopted
    # (or minted) for this request
    trace: Optional[object] = None
    id: int = field(default_factory=lambda: next(_ids))
    created: float = field(default_factory=time.monotonic)
    # results
    output_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    # phase timestamps (monotonic): created -> scheduled -> first
    # token -> finished
    scheduled_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # set when KV pool backpressure first requeued the request, so the
    # requeue counter counts requests, not admission retries
    pool_requeued: bool = False
    # one-shot observer the scheduler installs at submit(); must not
    # block or take scheduler locks (finish() may run under them)
    on_finish: Optional[object] = None
    done: threading.Event = field(default_factory=threading.Event)
    stream: "queue.Queue[Optional[int]]" = field(
        default_factory=queue.Queue)  # token ids; None = EOS sentinel

    def emit(self, token: int):
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.output_ids.append(token)
        self.stream.put(token)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (time.monotonic() if now is None else now)
                >= self.deadline)

    def finish(self, reason: str):
        # first finish wins: the server may time a request out while
        # the scheduler concurrently finishes it (benign race)
        if self.done.is_set():
            return
        self.finish_reason = reason
        self.finished_at = time.monotonic()
        self.stream.put(None)
        self.done.set()
        cb, self.on_finish = self.on_finish, None
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — telemetry must never
                pass  # turn a finished request into a failure

    def wait_output(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} timed out")
        return self.output_ids


class Scheduler:
    """Drives one InferenceEngine; thread-safe submit()."""

    # overlap is opt-in (serve.py enables it): it needs the admission
    # thread from start(), while tests drive step() synchronously
    def __init__(self, engine: InferenceEngine, max_pending: int = 512,
                 overlap: bool = False, max_restarts: int = 3,
                 restart_backoff: float = 0.05,
                 max_queue_wait: float = 30.0,
                 pipeline_depth: int = 1,
                 registry: Optional[Registry] = None,
                 span_log=None,
                 flight: Optional[FlightRecorder] = None,
                 flight_dump_dir: Optional[str] = None,
                 span_chunk_steps: int = 8,
                 class_weights=None,
                 class_wait_caps=None,
                 priority_scheduling: bool = True,
                 slow_step_factor: float = 4.0):
        self.engine = engine
        # slow-step outlier threshold: a step slower than this factor
        # times the rolling median records a slow_step flight event
        self.slow_step_factor = float(slow_step_factor)
        # span timeline: per-phase spans (queue, prefill, chunked
        # decode) written to the `--span-log` JSONL; a None path is a
        # no-op, so the hot path pays one `enabled` check when off
        self.span_log = coerce_span_log(span_log, component="engine")
        # decode spans are CHUNKED — one span per up-to-N drained steps
        # per request — so span volume scales with N, not every token
        self.span_chunk_steps = max(int(span_chunk_steps), 1)
        self._span_ctx = new_trace()
        # flight recorder: always-on bounded ring of lifecycle events;
        # served at /debug/events, dumped into flight_dump_dir on crash
        # recovery
        self.flight = flight if flight is not None else FlightRecorder()
        self.flight_dump_dir = flight_dump_dir
        self._flight_dumps = 0
        # decode pipelining: number of decode steps dispatched ahead of
        # token emission. 0 = fetch every step synchronously; 1 = step
        # k's tokens are read only after step k+1 was dispatched
        self.pipeline_depth = max(int(pipeline_depth), 0)
        # shared telemetry registry: the EngineServer scrapes it on
        # /metrics; stats-dict counters below are mirrored into it
        self.registry = registry or Registry()
        # crash recovery: consecutive engine-fault restarts tolerated
        # before going permanently dead (0 = first fault is fatal)
        self.max_restarts = max_restarts
        self.restart_backoff = restart_backoff
        # admission control: reject (429) when the estimated queue wait
        # exceeds this many seconds
        self.max_queue_wait = max_queue_wait
        # multi-tenant priority scheduling: per-class WDRR queues and
        # per-class queue-wait caps (standard keeps exactly the global
        # cap). Disabled = every request rides the standard FIFO.
        self.priority_scheduling = bool(priority_scheduling)
        self.class_weights = _weights_table(class_weights)
        self.class_wait_caps = _wait_caps_table(max_queue_wait,
                                               class_wait_caps)
        self.state: DecodeState = engine.new_state()
        self.pending: ClassQueues = ClassQueues(
            max_pending, weights=self.class_weights,
            enabled=self.priority_scheduling)
        # class-aware KV-pressure preemption: the engine picks victims
        # through this rank hook (over-quota classes first, then lowest
        # class; the engine's own least-progress tie-break preserves
        # the single-class victim choice)
        setr = getattr(engine, "set_preempt_rank", None)
        if callable(setr):
            setr(self._preempt_rank)
        self.slots: List[Optional[Request]] = [None] * engine.max_slots
        B = engine.max_slots
        self.overlap = overlap
        # prefilled-and-awaiting-insert items from the admission thread
        self._ready: "queue.Queue[tuple]" = queue.Queue()
        self._free_slots = threading.Semaphore(B)
        self._temp = np.zeros(B, np.float32)
        self._top_k = np.zeros(B, np.int32)
        self._top_p = np.ones(B, np.float32)
        self._true_len = np.zeros(B, np.int32)  # admitted prompt len/slot
        # outputs already present at admission (preempted resumes):
        # capacity accounting must not count them twice
        self._base_out = np.zeros(B, np.int64)
        # preempted mid-stream sequences re-enter HERE, ahead of new
        # arrivals (their generated tokens ride along as prompt)
        self._requeue: "collections.deque[Request]" = \
            collections.deque()
        # pipelined decode: dispatched-but-not-yet-read steps, each a
        # (token handle, slot-occupancy snapshot, generation snapshot)
        # triple; _drain_inflight is the ONLY place these tokens are
        # fetched to the host
        self._inflight: "collections.deque[tuple]" = collections.deque()
        # per-slot occupancy generation: bumped on EVERY occupancy
        # change, so a lagged token is emitted only if its slot still
        # holds the same admission it was sampled for
        self._slot_gen = [0] * B
        # device-resident sampling params (temperature/top_k/top_p
        # tensors on the engine's device), rebuilt only when a slot's
        # occupancy or params change — not three uploads per step
        self._sampling_dev: Optional[tuple] = None
        # monotonic timestamp of the last dispatch RETURN; the gap to
        # the next dispatch START is the host-side bubble pipelining
        # removes (None after idle/recovery)
        self._dispatch_end: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._admit_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards submit-vs-stop + stats
        self._status = "ok"
        # graceful drain: new submissions are rejected with 503 while
        # in-flight and queued work keeps running to completion
        self._draining = False
        # requests the admission thread holds between popping them from
        # a queue and parking them in _ready — drain_idle() must see
        # them as in-flight work
        self._admitting = 0
        self._restarts = 0  # consecutive faults since last good step
        # the admission thread signals a local engine fault here; the
        # scheduler thread owns recovery (one recoverer, no races)
        self._fault_event = threading.Event()
        # EWMAs for the queue-wait estimate (admission control)
        self._ewma_step_s: Optional[float] = None
        self._ewma_req_steps: Optional[float] = None
        self.stats: Dict[str, float] = {
            "requests_total": 0, "tokens_generated_total": 0,
            "prefill_total": 0, "decode_steps_total": 0,
            "queue_depth": 0, "active_slots": 0,
            "preemptions_total": 0, "kv_requeues_total": 0,
            "timeouts_total": 0,
            "rejected_total": 0, "engine_faults_total": 0,
            "restarts_total": 0,
        }
        R = self.registry
        self._counters = {
            key: R.counter(f"ome_engine_{key}", help)
            for key, help in _COUNTER_HELP.items()}
        self._h_queue_wait = R.histogram(
            "ome_engine_queue_wait_seconds",
            "Seconds between admission and first decode slot")
        self._h_prefill = R.histogram(
            "ome_engine_prefill_seconds",
            "Per-request prefill forward seconds", buckets=STEP_BUCKETS)
        self._h_decode_step = R.histogram(
            "ome_engine_decode_step_seconds",
            "Batched decode step seconds (one token per active slot)",
            buckets=STEP_BUCKETS)
        self._h_step_gap = R.histogram(
            "ome_engine_step_gap_seconds",
            "Host-side gap between consecutive decode dispatches (the "
            "bubble decode pipelining hides; idle/recovery pauses are "
            "excluded)", buckets=STEP_BUCKETS)
        self._h_ttft = R.histogram(
            "ome_engine_ttft_seconds",
            "Time to first token (admission to first emit)")
        self._h_tpot = R.histogram(
            "ome_engine_tpot_seconds",
            "Per-request mean time per output token after the first",
            buckets=STEP_BUCKETS)
        self._h_e2e = R.histogram(
            "ome_engine_e2e_seconds",
            "End-to-end request seconds (admission to finish)")
        self._g_queue_depth = R.gauge(
            "ome_engine_queue_depth", "Pending-queue depth")
        self._g_active = R.gauge(
            "ome_engine_active_slots", "Occupied decode slots")
        self._g_occupancy = R.gauge(
            "ome_engine_batch_occupancy_ratio",
            "Occupied decode slots / max_slots")
        self._g_status = R.gauge(
            "ome_engine_status",
            "Scheduler health state", labelnames=("state",))
        # prefix-cache observability (engine counters are plain ints;
        # update_gauges mirrors them by delta so /metrics sees them)
        self._c_pc_hits = R.counter(
            "ome_engine_prefix_cache_hits_total",
            "Prefix-cache hits (prompts that reused cached KV)")
        self._c_pc_misses = R.counter(
            "ome_engine_prefix_cache_misses_total",
            "Prefix-cache misses")
        self._c_pc_evictions = R.counter(
            "ome_engine_prefix_cache_evictions_total",
            "Prefix-cache leaf blocks evicted by the byte budget")
        self._g_pc_bytes = R.gauge(
            "ome_engine_prefix_cache_bytes",
            "Device bytes resident in the prefix cache")
        # step-phase attribution from timestamps the loop already
        # crosses: dispatch (the decode call), device_wait (blocking at
        # the lag-queue read), host_sample (token emit after the read)
        self._h_step_phase = R.histogram(
            "ome_engine_step_phase_seconds",
            "Decode step time attributed by phase (dispatch / "
            "device_wait / host_sample)",
            labelnames=("phase",), buckets=STEP_BUCKETS)
        self._ph_dispatch = self._h_step_phase.labels(phase="dispatch")
        self._ph_wait = self._h_step_phase.labels(phase="device_wait")
        self._ph_sample = self._h_step_phase.labels(phase="host_sample")
        self._c_flight_events = R.counter(
            "ome_engine_flight_events_total",
            "Scheduler lifecycle events recorded by the flight ring")
        self._c_flight_dumps = R.counter(
            "ome_engine_flight_dumps_total",
            "Flight-recorder dumps written on crash recovery")

        # per-class observability: children are pre-created for the
        # fixed class enum ONLY, so label cardinality is bounded
        def _by_class(fam):
            return {c: fam.labels(**{"class": c})
                    for c in PRIORITY_CLASSES}
        self._c_class_requests = _by_class(R.counter(
            "ome_engine_class_requests_total",
            "Requests submitted, by priority class",
            labelnames=("class",)))
        self._c_class_rejected = _by_class(R.counter(
            "ome_engine_class_rejected_total",
            "Admission rejections (429), by priority class",
            labelnames=("class",)))
        self._c_class_preempt = _by_class(R.counter(
            "ome_engine_class_preemptions_total",
            "KV-pressure preemptions, by priority class",
            labelnames=("class",)))
        self._c_class_tokens = _by_class(R.counter(
            "ome_engine_class_tokens_total",
            "Decode tokens emitted, by priority class",
            labelnames=("class",)))
        self._h_class_queue_wait = _by_class(R.histogram(
            "ome_engine_class_queue_wait_seconds",
            "Seconds between admission and first decode slot, by "
            "priority class", labelnames=("class",)))
        self._h_class_ttft = _by_class(R.histogram(
            "ome_engine_class_ttft_seconds",
            "Time to first token by priority class",
            labelnames=("class",)))
        self._h_class_e2e = _by_class(R.histogram(
            "ome_engine_class_e2e_seconds",
            "End-to-end request seconds by priority class",
            labelnames=("class",)))
        self._g_class_depth = _by_class(R.gauge(
            "ome_engine_class_queue_depth",
            "Pending-queue depth by priority class",
            labelnames=("class",)))
        self._c_slow_steps = R.counter(
            "ome_engine_slow_steps_total",
            "Decode steps exceeding slow_step_factor x the rolling "
            "median step time (each also records a slow_step flight "
            "event)")
        # rolling per-step-time window feeding the slow-step detector;
        # only the decode thread touches it
        self._step_window: "collections.deque[float]" = \
            collections.deque(maxlen=64)

    @property
    def status(self) -> str:
        return self._status

    # backward-compat boolean view of the tri-state (degraded still
    # accepts work, so it reads healthy)
    @property
    def healthy(self) -> bool:
        return self._status != "dead"

    @healthy.setter
    def healthy(self, value: bool):
        self._status = "ok" if value else "dead"

    def _inc_locked(self, key: str, by: float = 1):
        """Caller holds self._lock. Mirrors into the registry — the
        counter's own leaf lock nests safely under ours."""
        self.stats[key] += by
        c = self._counters.get(key)
        if c is not None:
            c.inc(by)

    def _inc(self, key: str, by: float = 1):
        with self._lock:
            self._inc_locked(key, by)

    def _class_of(self, req: Request) -> str:
        """The request's priority class, coerced onto the fixed enum."""
        cls = getattr(req, "priority", DEFAULT_PRIORITY)
        return cls if cls in self._c_class_requests else \
            DEFAULT_PRIORITY

    def _preempt_rank(self, slot: int):
        """Victim-ranking hook installed on the engine (lower sorts
        first): over-quota classes — holding more decode slots than
        their weight share of the active batch — are preempted before
        in-quota ones, then lowest class first. The engine breaks the
        remaining tie by least progress. Runs on the scheduler thread
        (inside the decode dispatch that grows KV blocks), so reading
        self.slots needs no lock."""
        if not self.priority_scheduling:
            return (1, 1)
        req = self.slots[slot] if 0 <= slot < len(self.slots) else None
        if req is None:
            return (1, len(PRIORITY_CLASSES))
        cls = self._class_of(req)
        counts: Dict[str, int] = {}
        for r in self.slots:
            if r is not None:
                c = self._class_of(r)
                counts[c] = counts.get(c, 0) + 1
        total = sum(counts.values())
        wsum = sum(self.class_weights[c] for c in counts)
        fair = (total * self.class_weights[cls] / wsum) if wsum \
            else float(total)
        over = counts.get(cls, 0) > fair + 1e-9
        return (0 if over else 1, CLASS_LEVEL.get(cls, 1))

    def _observe_finish(self, req: Request):
        """One-shot per-request latency observations. Runs on whatever
        thread called finish() — touches only leaf-locked histograms."""
        end = req.finished_at if req.finished_at is not None \
            else time.monotonic()
        self._h_e2e.observe(end - req.created)
        self._h_class_e2e[self._class_of(req)].observe(
            end - req.created)
        if req.first_token_at is not None:
            self._h_ttft.observe(req.first_token_at - req.created)
            self._h_class_ttft[self._class_of(req)].observe(
                req.first_token_at - req.created)
            n = len(req.output_ids)
            if n > 1:
                self._h_tpot.observe(
                    (end - req.first_token_at) / (n - 1))

    def _request_finished(self, req: Request):
        """Installed as req.on_finish at submit: latency observations
        plus the request's closing spans."""
        self._observe_finish(req)
        self._flush_decode_chunk(req, final=True)
        span = getattr(req, "_span", None)
        if span is not None and self.span_log.enabled:
            span.end(req.finished_at)
            span.set(request=req.id, finish_reason=req.finish_reason,
                     prompt_tokens=len(req.prompt_ids),
                     output_tokens=len(req.output_ids))
            self.span_log.write(span)

    def _mark_scheduled(self, req: Request):
        """First time a request leaves the queue for a decode slot: the
        queue-wait phase ends here."""
        if req.scheduled_at is None:
            req.scheduled_at = time.monotonic()
            self._h_queue_wait.observe(req.scheduled_at - req.created)
            self._h_class_queue_wait[self._class_of(req)].observe(
                req.scheduled_at - req.created)
            span = getattr(req, "_span", None)
            if span is not None and self.span_log.enabled:
                now_wall = time.time()
                q = Span("engine.queue", trace_id=span.trace_id,
                         parent_id=span.span_id,
                         start_mono=req.created,
                         start_wall=now_wall - (req.scheduled_at
                                                - req.created))
                q.end(req.scheduled_at).set(request=req.id)
                self.span_log.write(q)

    # -- flight recorder + span plumbing -------------------------------

    def _flight_event(self, event: str, **fields):
        self.flight.record(event, **fields)
        self._c_flight_events.inc()

    def _flight_autodump(self, reason: str) -> Optional[str]:
        """Dump the event ring to flight_dump_dir (crash recovery /
        dead transitions). Best-effort: a failed dump never worsens
        recovery."""
        if self.flight_dump_dir is None:
            return None
        self._flight_dumps += 1
        path = os.path.join(
            self.flight_dump_dir,
            f"flight-{os.getpid()}-{self._flight_dumps}.json")
        try:
            os.makedirs(self.flight_dump_dir, exist_ok=True)
            self.flight.dump(path, reason=reason)
        except OSError:
            return None
        self._c_flight_dumps.inc()
        return path

    def _note_slot_assign(self, slot: int, req: Request):
        """Flight event + decode-chunk window start for a request
        entering a decode slot."""
        self._flight_event("slot_assign", slot=slot, request=req.id)
        if self.span_log.enabled and getattr(req, "_span", None) \
                is not None:
            req._chunk = [time.monotonic(), time.time(), 0, 0,
                          getattr(req, "_chunk_base", 0)]

    def _begin_prefill_span(self, req: Request) -> Optional[Span]:
        span = getattr(req, "_span", None)
        if span is None or not self.span_log.enabled:
            return None
        return Span("engine.prefill", trace_id=span.trace_id,
                    parent_id=span.span_id)

    def _end_prefill_span(self, req: Request, pspan: Optional[Span]):
        if pspan is None:
            return
        pspan.end().set(request=req.id,
                        prompt_tokens=len(req.prompt_ids))
        self.span_log.write(pspan)

    def _note_decode_progress(self, req: Request, tokens: int = 1):
        """Advance the request's decode-chunk accounting by one drained
        step; flushes a chunk span every span_chunk_steps."""
        ch = getattr(req, "_chunk", None)
        if ch is None:
            return
        ch[2] += 1
        ch[3] += tokens
        if ch[2] >= self.span_chunk_steps:
            self._flush_decode_chunk(req)

    def _flush_decode_chunk(self, req: Request, final: bool = False):
        """Write the pending decode-chunk span (if any steps were
        drained since the last flush) and roll the window forward."""
        ch = getattr(req, "_chunk", None)
        if ch is None:
            return
        span = getattr(req, "_span", None)
        if ch[2] > 0 and span is not None and self.span_log.enabled:
            end_mono = time.monotonic()
            s = Span("engine.decode", trace_id=span.trace_id,
                     parent_id=span.span_id,
                     start_mono=ch[0], start_wall=ch[1])
            s.end(end_mono)
            s.set(steps=ch[2], tokens=ch[3], chunk=ch[4],
                  request=req.id)
            self.span_log.write(s)
            ch[0] = end_mono
            ch[1] += s.dur_s
            ch[2] = 0
            ch[3] = 0
            ch[4] += 1
        if final:
            req._chunk_base = ch[4]
            req._chunk = None

    def debug_state(self) -> dict:
        """Point-in-time JSON snapshot behind GET /debug/state. Reads
        are lock-free on purpose (the scheduler thread owns the
        structures); a concurrent mutation can skew one field."""
        slots = []
        for slot, req in enumerate(list(self.slots)):
            if req is None:
                continue
            slots.append({"slot": slot, "request": req.id,
                          "prompt_tokens": len(req.prompt_ids),
                          "committed_tokens": len(req.output_ids),
                          "adapter": req.adapter,
                          "class": req.priority})
        state = {
            "status": self._status,
            "draining": self._draining,
            "queue_depth": self.pending.qsize(),
            "queue_depths": self.pending.depths(),
            "priority_scheduling": self.priority_scheduling,
            "requeued": len(self._requeue),
            "ready": self._ready.qsize(),
            "inflight_steps": len(self._inflight),
            "admitting": self._admitting,
            "max_slots": self.engine.max_slots,
            "active_slots": len(slots),
            "slots": slots,
            "flight": self.flight.state(),
        }
        pool = getattr(self.engine, "kv_pool_stats", None)
        if pool and pool.get("kv_block_tokens"):
            state["kv_pool"] = dict(pool)
        return state

    def update_gauges(self):
        """Refresh point-in-time gauges (called by /metrics scrapes)."""
        self._g_queue_depth.set(self.pending.qsize())
        for cls, depth in self.pending.depths().items():
            self._g_class_depth[cls].set(depth)
        active = sum(r is not None for r in self.slots)
        self._g_active.set(active)
        self._g_occupancy.set(active / max(self.engine.max_slots, 1))
        status = self._status
        for state in ("ok", "degraded", "dead"):
            self._g_status.labels(state=state).set(
                1 if state == status else 0)
        pc = getattr(self.engine, "prefix_cache", None)
        if pc is not None:
            for counter, value in ((self._c_pc_hits, pc.hits),
                                   (self._c_pc_misses, pc.misses),
                                   (self._c_pc_evictions,
                                    pc.evictions)):
                delta = value - counter.value
                if delta > 0:
                    counter.inc(delta)
            self._g_pc_bytes.set(pc.bytes)
        pool = getattr(self.engine, "kv_pool_stats", None)
        if pool and pool.get("kv_block_tokens"):  # paged engines only
            total = pool.get("kv_blocks", 0)
            free = pool.get("kv_blocks_free", 0)
            self.registry.gauge(
                "ome_engine_kv_blocks_free",
                "Free paged-KV blocks").set(free)
            self.registry.gauge(
                "ome_engine_kv_block_utilization_ratio",
                "Occupied fraction of the paged-KV pool").set(
                (total - free) / total if total else 0.0)
            ok, owned = self.engine.kv_conservation()
            self.registry.gauge(
                "ome_engine_kv_blocks_owned",
                "Paged-KV blocks held by live slots").set(owned)
            # authoritative at quiescence; a concurrent insert/free can
            # briefly read as 0 mid-scrape
            self.registry.gauge(
                "ome_engine_kv_conservation_ok",
                "1 when free + owned blocks account for the whole pool "
                "(checked per scrape; authoritative when idle)").set(
                1 if ok else 0)

    # -- public --------------------------------------------------------

    def _queue_wait_estimate(self, depth: int) -> Optional[float]:
        """Rough seconds until a newly queued request would start
        decoding: queue depth in batch waves x observed per-request
        decode steps x observed step time. None until both EWMAs have
        samples (cold start admits optimistically)."""
        if depth <= 0 or self._ewma_step_s is None \
                or self._ewma_req_steps is None:
            return None
        waves = math.ceil(depth / self.engine.max_slots)
        return waves * self._ewma_req_steps * self._ewma_step_s

    def _class_wait_estimate(self, cls: str,
                             depth: int) -> Optional[float]:
        """Per-class queue-wait estimate: the class's own backlog
        drains at roughly its weight share of the active classes'
        total weight."""
        base = self._queue_wait_estimate(depth)
        if base is None or not self.priority_scheduling:
            return base
        w = self.class_weights
        active = {c for c in PRIORITY_CLASSES
                  if self.pending.qsize(c) > 0}
        active.add(cls)
        share = sum(w[c] for c in active)
        return base * (share / w[cls]) if share else base

    def retry_after_hint(self, default: float = 1.0) -> int:
        """Seconds a rejected/bounced client should back off, from the
        live queue-wait estimate, clamped to [1, 30]."""
        est = self._queue_wait_estimate(self.pending.qsize() + 1)
        val = est if est is not None else default
        return int(min(max(math.ceil(val), 1), 30))

    def submit(self, req: Request) -> Request:
        # the lock makes submit-vs-stop atomic: a request either gets
        # queued before the shutdown drain, or is rejected here
        with self._lock:
            if self._stop.is_set() or self._status == "dead":
                raise RuntimeError("scheduler unavailable")
            if self._draining:
                raise SchedulerDraining(
                    "scheduler draining (shutdown signal received); "
                    "resubmit to another replica")
            self._inc_locked("requests_total")
            req.on_finish = self._request_finished
            if req.expired():
                # dead on arrival: never queued, never slotted
                self._inc_locked("timeouts_total")
                req.finish("timeout")
                return req
            cls = self._class_of(req)
            self._c_class_requests[cls].inc()
            # per-class admission control: a class sheds on ITS OWN
            # queue depth and wait cap
            if self.priority_scheduling:
                depth = self.pending.qsize(cls)
                cap = self.class_wait_caps.get(cls,
                                               self.max_queue_wait)
            else:
                depth = self.pending.qsize()
                cap = self.max_queue_wait
            est = self._class_wait_estimate(cls, depth + 1)
            if depth >= self.pending.maxsize or \
                    (est is not None and est > cap):
                self._inc_locked("rejected_total")
                self._c_class_rejected[cls].inc()
                retry = min(max(est if est is not None else 1.0, 0.5),
                            30.0)
                raise SchedulerOverloaded(
                    f"{cls} queue saturated (depth {depth}, "
                    f"estimated wait {est if est is not None else '?'}"
                    f"s, cap {cap:g}s)", retry_after=retry)
            if self.span_log.enabled:
                # the engine-side request span, minted BEFORE the queue
                # put — once visible, the admission thread may schedule
                # the request immediately
                req._span = Span.begin("engine.request", ctx=req.trace,
                                       start_mono=req.created)
            try:
                self.pending.put_nowait(req)
            except queue.Full:
                self._inc_locked("rejected_total")
                self._c_class_rejected[cls].inc()
                raise SchedulerOverloaded(
                    f"{cls} pending queue full", retry_after=1.0)
            self._flight_event("admit", request=req.id, cls=cls,
                               depth=depth + 1)
        return req

    def start(self):
        # idempotent: EngineServer.start() also starts its scheduler
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run,
                                        name="ome-scheduler", daemon=True)
        self._thread.start()
        if self.overlap:
            self._admit_thread = threading.Thread(
                target=self._admit_loop, name="ome-admission",
                daemon=True)
            self._admit_thread.start()

    def stop(self):
        with self._lock:
            self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        if self._admit_thread:
            self._admit_thread.join(timeout=10)
        # `shutdown` (vs `engine_fault`): an orderly eviction
        self._fail_all("shutdown")
        self.span_log.close()

    # -- graceful drain -----------------------------------------------

    def begin_drain(self):
        """Stop admitting NEW requests (503 SchedulerDraining) while
        queued and in-flight work keeps running to completion."""
        with self._lock:
            self._draining = True
        self._flight_event("drain_begin",
                           queue_depth=self.pending.qsize(),
                           active=sum(r is not None
                                      for r in self.slots))

    @property
    def draining(self) -> bool:
        return self._draining

    def drain_idle(self) -> bool:
        """True when no admitted work remains anywhere in the
        scheduler."""
        return (self.pending.empty() and not self._requeue
                and self._ready.empty() and not self._inflight
                and self._admitting == 0
                and all(r is None for r in self.slots))

    def _next_pending(self) -> Request:
        """Requeued requests go first; raises queue.Empty like
        pending.get_nowait(). Expired or already-finished requests are
        shed here — they never occupy a decode slot."""
        while True:
            try:
                req = self._requeue.popleft()
            except IndexError:
                req = self.pending.get_nowait()  # Empty propagates
            if self._shed_if_expired(req):
                continue
            return req

    def _shed_if_expired(self, req: Request) -> bool:
        if req.done.is_set():
            return True  # finished elsewhere (server-side timeout)
        if req.expired():
            self._inc("timeouts_total")
            req.finish("timeout")
            return True
        return False

    def _fail_all(self, reason: str):
        self._inflight.clear()  # unread steps die with their batch
        self._dispatch_end = None
        with self._lock:
            while True:
                try:
                    self._requeue.popleft().finish(reason)
                except IndexError:
                    break
            while True:
                try:
                    self.pending.get_nowait().finish(reason)
                except queue.Empty:
                    break
            while True:
                try:
                    item = self._ready.get_nowait()
                except queue.Empty:
                    break
                item[0].finish(reason)
                self._free_slots.release()
            for slot, r in enumerate(self.slots):
                if r is not None:
                    self.slots[slot] = None
                    self._slot_changed(slot)
                    try:
                        self.engine.free_slot(slot)
                    except Exception:  # noqa: BLE001 — draining a
                        pass  # faulted engine must not abort
                    r.finish(reason)
                    if self.overlap:
                        self._free_slots.release()

    # -- core loop -----------------------------------------------------

    def step(self) -> bool:
        """One admission + decode round; returns True if work was done.

        Overlap mode inserts whatever the admission thread finished
        prefilling since the last step. Synchronous mode admits at most
        ONE prefill per decode step while streams are active, so a
        burst of long prompts adds bounded latency instead of stalling
        the batch."""
        if self.overlap:
            admitted = self._insert_ready()
        else:
            active = any(r is not None for r in self.slots)
            admitted = self._admit(limit=1 if active else None)
        decoded = self._decode()
        with self._lock:
            self.stats["queue_depth"] = self.pending.qsize()
            self.stats["active_slots"] = sum(
                r is not None for r in self.slots)
        return admitted or decoded

    # -- overlap mode: admission thread prefills, step() inserts -------

    def _admit_loop(self):
        while not self._stop.is_set() and self._status != "dead":
            if self._status != "ok" or self._fault_event.is_set():
                # recovery in flight: hold admission (requests queue)
                time.sleep(0.005)
                continue
            # slot credit first: at most max_slots prefills in flight
            # ahead of their inserts
            if not self._free_slots.acquire(timeout=0.05):
                continue
            try:
                req = self._requeue.popleft()
            except IndexError:
                try:
                    req = self.pending.get(timeout=0.05)
                except queue.Empty:
                    self._free_slots.release()
                    continue
            self._admitting += 1
            try:
                if self._shed_if_expired(req):
                    self._free_slots.release()
                    continue
                if not self._fits_pool(req):
                    req.finish("error")
                    self._free_slots.release()
                    continue
                if not self._pool_ready(req):
                    # saturated pool: back off instead of re-prefilling
                    self._requeue_for_pool(req)
                    self._free_slots.release()
                    time.sleep(0.01)
                    continue
                self._mark_scheduled(req)
                pspan = self._begin_prefill_span(req)
                t0 = time.monotonic()
                try:
                    tok, kv, true_len, bucket = self._prefill_req(req)
                except UnknownAdapterError as e:
                    # the request's own problem, never an engine fault
                    log.warning("prefill failure for request %s: %s",
                                req.id, e)
                    req.finish("error")
                    self._free_slots.release()
                    continue
                except Exception:  # noqa: BLE001
                    # local engine fault: this request is lost, but the
                    # SCHEDULER thread owns recovery — signal it and
                    # keep the admission thread alive
                    log.exception("prefill failed; requesting engine "
                                  "recovery")
                    req.finish("error")
                    self._free_slots.release()
                    self._fault_event.set()
                    continue
                self._h_prefill.observe(time.monotonic() - t0)
                self._end_prefill_span(req, pspan)
                self._inc("prefill_total")
                # under _lock so a prefill that outlives stop()'s join
                # cannot strand its request in _ready after _fail_all
                # drained it
                with self._lock:
                    if self._stop.is_set() or not self.healthy:
                        req.finish("shutdown" if self._stop.is_set()
                                   else "error")
                        self._free_slots.release()
                        return
                    self._ready.put((req, tok, kv, true_len, bucket))
            finally:
                self._admitting -= 1

    def _arm_slot(self, slot: int, req: Request, tok: int,
                  true_len: int) -> None:
        """A prefilled request has been inserted into `slot`: record
        it, emit its first token."""
        self.slots[slot] = req
        self._slot_changed(slot)
        self._note_slot_assign(slot, req)
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        self._true_len[slot] = true_len
        self._base_out[slot] = len(req.output_ids)
        req.emit(tok)
        self._maybe_finish(slot, tok)

    def _insert_ready(self) -> bool:
        did = False
        while True:
            try:
                req, tok, kv, true_len, bucket = self._ready.get_nowait()
            except queue.Empty:
                break
            slot = self.slots.index(None)  # semaphore guarantees one
            ikw = {} if req.adapter is None else {"adapter": req.adapter}
            try:
                self.state = self.engine.insert(
                    self.state, kv, slot, true_len, tok, bucket, **ikw)
            except KVPoolExhausted:
                # paged-KV backpressure: requeue until running streams
                # free blocks (the prefilled KV is dropped — the
                # request re-prefills on its next turn)
                self._requeue_for_pool(req)
                self._free_slots.release()
                continue
            except UnknownAdapterError:
                req.finish("error")
                self._free_slots.release()
                continue
            except Exception:  # noqa: BLE001
                # engine fault: req is out of every queue so _recover
                # cannot see it — fail it (and return its slot credit)
                # before propagating to the recovery handler in _run
                req.finish("error")
                self._free_slots.release()
                raise
            self._arm_slot(slot, req, tok, true_len)
            did = True
        return did

    def _admit(self, limit: Optional[int] = None) -> bool:
        did = False
        admitted = 0
        for slot, occupant in enumerate(self.slots):
            if occupant is not None:
                continue
            if limit is not None and admitted >= limit:
                break
            try:
                req = self._next_pending()
            except queue.Empty:
                break
            self._admitting += 1
            try:
                if not self._fits_pool(req):
                    req.finish("error")
                    continue
                if not self._pool_ready(req):
                    # pool saturated: retry next step WITHOUT burning a
                    # prefill forward that insert would just bounce
                    self._requeue_for_pool(req)
                    break
                self._mark_scheduled(req)
                pspan = self._begin_prefill_span(req)
                t0 = time.monotonic()
                try:
                    tok, kv, true_len, bucket = self._prefill_req(req)
                    self._h_prefill.observe(time.monotonic() - t0)
                    self._end_prefill_span(req, pspan)
                    ikw = {} if req.adapter is None \
                        else {"adapter": req.adapter}
                    self.state = self.engine.insert(
                        self.state, kv, slot, true_len, tok, bucket,
                        **ikw)
                except KVPoolExhausted:
                    # paged-KV backpressure: retry next step, after
                    # running streams have freed blocks
                    self._requeue_for_pool(req)
                    break
                except UnknownAdapterError:
                    req.finish("error")
                    continue
                except Exception:
                    # req is out of the queue but not yet slotted, so
                    # the recovery handler cannot see it — fail it here
                    req.finish("error")
                    raise
                self._inc("prefill_total")
                self._arm_slot(slot, req, tok, true_len)
                did = True
                admitted += 1
            finally:
                self._admitting -= 1
        return did

    def _slot_changed(self, slot: int):
        """Every slot-occupancy change funnels through here: the
        generation bump retires any in-flight lagged token sampled for
        the previous occupant, and the device sampling cache is
        dropped so the next dispatch re-uploads the new [B] params."""
        self._slot_gen[slot] += 1
        self._sampling_dev = None

    def _sampling(self):
        """Device-resident (temperature, top_k, top_p) for the whole
        batch, re-uploaded only after an occupancy/param change."""
        if self._sampling_dev is None:
            dev = getattr(self.engine, "device", None)
            self._sampling_dev = (torch.tensor(self._temp, device=dev),
                                  torch.tensor(self._top_k, device=dev),
                                  torch.tensor(self._top_p, device=dev))
        return self._sampling_dev

    def _drain_inflight(self, keep: int = 0) -> bool:
        """Read dispatched steps older than the newest `keep`, oldest
        first, emitting each token whose slot still holds the SAME
        admission it was sampled for. This is the decode loop's only
        device->host token fetch — under pipelining it runs AFTER the
        next step was dispatched, and the copy decode() queued is
        usually already complete."""
        did = False
        drained = 0
        while len(self._inflight) > keep:
            toks, snap_slots, snap_gens = self._inflight.popleft()
            t_read = time.monotonic()
            host_toks = np.asarray(toks)
            t_fetched = time.monotonic()
            self._ph_wait.observe(t_fetched - t_read)
            for slot, req in enumerate(snap_slots):
                if (req is None or self.slots[slot] is not req
                        or self._slot_gen[slot] != snap_gens[slot]):
                    continue
                tok = int(host_toks[slot])
                req.emit(tok)
                self._inc("tokens_generated_total")
                self._c_class_tokens[self._class_of(req)].inc()
                self._note_decode_progress(req)
                self._maybe_finish(slot, tok)
            self._ph_sample.observe(time.monotonic() - t_fetched)
            did = True
            drained += 1
        if drained:
            self._flight_event("pipeline_drain", steps=drained,
                               kept=keep)
        return did

    def _decode(self) -> bool:
        if not any(r is not None for r in self.slots):
            # the batch drained while a step was still in flight: read
            # it out (every token discards) so the entry cannot strand
            self._dispatch_end = None
            return self._drain_inflight()
        # deterministic fault injection (tests, chaos drills): only
        # real decode steps count as hits
        faults.fire("engine_step")
        plan = self._plan_step()
        return self._execute(plan)

    def _plan_step(self) -> StepPlan:
        """This iteration's plan: a plain decode step of the whole
        batch, pipelined at the configured depth."""
        return StepPlan("decode")

    def _execute(self, plan: StepPlan) -> bool:
        """Dispatch one StepPlan, feed the lag queue, drain."""
        sampling = self._sampling()
        t0 = time.monotonic()
        gap_s = None
        if self._dispatch_end is not None:
            gap_s = t0 - self._dispatch_end
            self._h_step_gap.observe(gap_s)
        self.state, toks = self.engine.decode(self.state, *sampling)
        self._dispatch_end = time.monotonic()
        dt = self._dispatch_end - t0
        self._ewma_step_s = dt if self._ewma_step_s is None \
            else 0.9 * self._ewma_step_s + 0.1 * dt
        self._h_decode_step.observe(dt)
        self._ph_dispatch.observe(dt)
        self._observe_slow_step(dt, gap_s)
        self._inc("decode_steps_total")
        self._inflight.append(
            (toks, list(self.slots), list(self._slot_gen)))
        depth = 0 if plan.sync else self.pipeline_depth
        # emit steps older than the pipeline window — with the next
        # step now dispatched, reading them costs no dispatch overlap
        self._drain_inflight(keep=max(depth, 1))
        # KV pool pressure may have evicted sequences before the step
        # ran: requeue them without emitting (the generation bump makes
        # the lag queue discard their pending token); generated-so-far
        # tokens ride along as prompt for the re-prefill
        for slot in self.engine.take_preempted():
            req = self.slots[slot]
            if req is None:
                continue
            self.slots[slot] = None
            self._slot_changed(slot)
            self._temp[slot] = 0.0
            req.prompt_ids = list(req.prompt_ids) + list(
                req.output_ids[int(self._base_out[slot]):])
            self._flush_decode_chunk(req, final=True)
            self._flight_event("preempt_fold", slot=slot,
                               request=req.id,
                               folded=len(req.output_ids)
                               - int(self._base_out[slot]))
            self._requeue.appendleft(req)
            self._inc("preemptions_total")
            self._c_class_preempt[self._class_of(req)].inc()
            if self.overlap:
                self._free_slots.release()
        if depth == 0:
            self._drain_inflight()
        return True

    def _observe_slow_step(self, dt: float, gap_s) -> None:
        """Slow-step outlier detection against the rolling median of
        recent step times; warm-up is excluded by requiring a
        half-full window before judging."""
        win = self._step_window
        if len(win) >= win.maxlen // 2:
            med = sorted(win)[len(win) // 2]
            if med > 0 and dt > self.slow_step_factor * med:
                self._c_slow_steps.inc()
                self._flight_event(
                    "slow_step", step_ms=round(dt * 1e3, 3),
                    median_ms=round(med * 1e3, 3),
                    ratio=round(dt / med, 2),
                    gap_ms=round((gap_s or 0.0) * 1e3, 3))
        win.append(dt)

    def _prefill_req(self, req: Request):
        """Engine prefill for one request."""
        kw = {}
        if req.adapter is not None:
            kw["adapter"] = req.adapter
        return self.engine.prefill(req.prompt_ids, req.temperature,
                                   req.top_k, req.top_p, **kw)

    def _requeue_for_pool(self, req: Request) -> None:
        """Put `req` back at the head of the queue until the KV pool
        has room; counted once per request, however many admission
        turns it waits."""
        self._requeue.appendleft(req)
        if not req.pool_requeued:
            req.pool_requeued = True
            self._inc("kv_requeues_total")

    def _fits_pool(self, req: Request) -> bool:
        """Paged KV only: a request whose worst-case footprint exceeds
        the whole pool can never finish — preempting it would livelock
        (it is always its own cheapest victim), so reject upfront. A
        preempted request's generated tokens already moved into
        prompt_ids, so the remaining-output term shrinks by what was
        produced (no double count)."""
        kvb = getattr(self.engine, "kv_block", 0)
        if not kvb:
            return True
        usable = (self.engine.kv_blocks - 1) * kvb
        remaining = max(req.max_new_tokens - len(req.output_ids), 0)
        worst = min(min(len(req.prompt_ids), self.engine.max_seq)
                    + remaining + 1, self.engine.max_seq)
        return worst <= usable

    def _pool_ready(self, req: Request) -> bool:
        """Cheap pre-prefill check: enough free blocks for this
        request's PROMPT — avoids re-running a full prefill forward on
        every retry while the pool is saturated (the insert would just
        bounce with KVPoolExhausted again)."""
        kvb = getattr(self.engine, "kv_block", 0)
        if not kvb:
            return True
        need = self.engine.blocks_needed(
            min(len(req.prompt_ids), self.engine.max_seq))
        return self.engine.kv_pool_stats["kv_blocks_free"] >= need

    def _maybe_finish(self, slot: int, tok: int):
        req = self.slots[slot]
        if tok in req.stop_ids:
            reason = "stop"
        elif req.expired():
            # deadline passed mid-decode: partial output is returned
            # with the honest finish reason
            reason = "timeout"
        elif len(req.output_ids) >= req.max_new_tokens:
            reason = "length"
        elif (int(self._true_len[slot])
              + len(req.output_ids) - int(self._base_out[slot])
              >= self.engine.max_seq):
            # cache capacity: the slot was admitted with true_len rows,
            # +1 row per token generated since admission
            reason = "length"
        else:
            return
        self.slots[slot] = None
        self._slot_changed(slot)
        self._temp[slot] = 0.0
        self.engine.free_slot(slot)
        if reason == "timeout":
            self._inc("timeouts_total")
        n = max(len(req.output_ids), 1)
        self._ewma_req_steps = float(n) if self._ewma_req_steps is None \
            else 0.8 * self._ewma_req_steps + 0.2 * n
        req.finish(reason)
        if self.overlap:
            self._free_slots.release()

    # -- crash recovery ------------------------------------------------

    def _fail_batch(self, reason: str):
        """Fail the in-flight batch ONLY: occupied slots are freed and
        their requests finished; queued work survives the restart."""
        # drop dispatched-but-unread steps WITHOUT fetching: the failed
        # batch's lagged tokens must not be emitted
        self._inflight.clear()
        self._dispatch_end = None
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            self.slots[slot] = None
            self._slot_changed(slot)
            self._temp[slot] = 0.0
            try:
                self.engine.free_slot(slot)
            except Exception:  # noqa: BLE001 — state is rebuilt below
                pass
            r.finish(reason)
            if self.overlap:
                self._free_slots.release()

    def _go_dead(self) -> bool:
        self._flight_event("dead", restarts=self._restarts)
        self._flight_autodump("dead")
        with self._lock:
            self._status = "dead"
        self._fail_all("engine_fault")
        return False

    def _recover(self, err: BaseException) -> bool:
        """Engine-step fault path: fail the in-flight batch, rebuild
        the decode state after an exponential-backoff pause, resume
        admitting. Returns False when the restart budget is exhausted
        (scheduler dead) or the state rebuild itself fails."""
        self._inc("engine_faults_total")
        self._flight_event("crash_recovery",
                           restart=self._restarts + 1,
                           error=str(err)[:160])
        self._flight_autodump("engine_fault")
        with self._lock:
            self._status = "degraded"
        self._restarts += 1
        if self._restarts > self.max_restarts:
            log.error("engine fault (%s); %d consecutive restarts "
                      "exhausted the budget — scheduler dead", err,
                      self._restarts - 1)
            return self._go_dead()
        self._fail_batch("engine_fault")
        delay = min(self.restart_backoff * (2 ** (self._restarts - 1)),
                    5.0)
        log.warning("engine fault (%s); restart %d/%d in %.3fs", err,
                    self._restarts, self.max_restarts, delay)
        if self._stop.wait(delay):
            return True  # shutting down; stop() drains the queues
        try:
            self.state = self.engine.new_state()
        except Exception:  # noqa: BLE001
            log.exception("decode-state rebuild failed; scheduler dead")
            return self._go_dead()
        self._fault_event.clear()
        with self._lock:
            self._status = "ok"
            self._inc_locked("restarts_total")
        return True

    def _run(self):
        while not self._stop.is_set():
            try:
                if self._status == "dead":
                    # no recovery left; fail waiters fast
                    self._fail_all("engine_fault")
                    return
                if self._fault_event.is_set():
                    raise RuntimeError(
                        "admission-thread engine fault")
                did = self.step()
                if did and self._status == "ok":
                    self._restarts = 0  # a good step resets the budget
                elif not did:
                    time.sleep(0.001)
            except Exception as e:  # noqa: BLE001 — a dead loop must
                # not leave waiters hanging or /health lying
                log.exception("scheduler step failed; failing in-flight "
                              "batch")
                if not self._recover(e):
                    return
