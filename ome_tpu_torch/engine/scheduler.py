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

The decode loop is a planner/executor pair, as in the reference:
`_plan_step` decides once per iteration which engine op runs (plain
decode / K-token chunk through `decode_multi` / speculative verify) and
what it carries (grammar masks, chunk budgets, draft tokens); `_execute`
dispatches any plan the same way. Pipelining, multi-token chunks,
speculative verify and structured-output masks compose as plan
features; when the planner cannot meet a plan's precondition it flushes
and counts the cause on `ome_engine_step_degradations_total`.

Decode pipelining: with `pipeline_depth` 1 the tokens of step k are read
on the host only after step k+1 was dispatched (the engine queues their
host copy behind the step), hiding the host-side bubble; depth 0 reads
every step synchronously. A plan marked `sync` (a sampled token the next
plan depends on) drains at once.

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

PD and cross-replica reuse: on a PD decode node (engine/pd.py
RemotePrefillEngine) the prefill is a fetch from the prefill pool, given
the request's deadline, priority and trace; the engine's
`transient_prefill_errors` fail that one request on the admission and
insert paths, never the scheduler. A request that names a prefix peer
(`Request.prefix_peer`, the X-OME-Prefix-Peer header) fetches the
prefix KV from that replica first (engine/peering.py) and falls back to
a local prefill. `/metrics` carries the prefix cache's host-tier
counters and the PD pool's gauges.

Durable requests: with a `journal` (engine/journal.py), every unmasked
admission is journaled with the scheduler lock released, progress
records append at each step boundary, and a `shutdown` eviction (or an
`engine_fault` once the scheduler is dead) leaves the entry live;
`resume_from_journal` re-admits what a killed process left, its
generated tokens folded into the prompt, so a greedy stream continues
byte-identical to an uninterrupted run.

Performance attribution (ome_tpu_torch/perf): the engine's program cost
ledger exports through the scheduler's registry and flight ring, a real
engine gets an HBM accountant refreshed on every /metrics scrape, and
each decode dispatch feeds the online roofline gauges (the ledger's
expected ms and bytes over the measured dispatch time) and the
slow-step detector, whose `slow_step` event names the program.
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults
from ..perf.hbm import HbmAccountant
from ..priority import CLASS_LEVEL, DEFAULT_PRIORITY, PRIORITY_CLASSES
from ..priority import class_wait_caps as _wait_caps_table
from ..priority import class_weights as _weights_table
from ..telemetry import Registry
from ..telemetry.flight import FlightRecorder
from ..telemetry.tracing import (Span, SpanContext, coerce_span_log,
                                 new_trace)
from . import spec as spec_drafter
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
    "spec_steps_total": "Speculative verify steps dispatched",
    "spec_proposed_tokens_total":
        "Draft tokens proposed by the n-gram drafter",
    "spec_accepted_tokens_total":
        "Draft tokens accepted by verify forwards",
}


class _SpecStep:
    """Lag-queue payload of one speculative verify step: the [B, k+1]
    emitted-token matrix and [B] accepted counts (host copies already
    in flight, like plain decode tokens), the host-side draft lengths
    for acceptance accounting and the dispatch timestamp for the
    spec_verify span."""

    __slots__ = ("out", "accepted", "draft_len", "t_dispatch")

    def __init__(self, out, accepted, draft_len, t_dispatch=0.0):
        self.out = out
        self.accepted = accepted
        self.draft_len = draft_len
        self.t_dispatch = t_dispatch


class _MultiStep:
    """Lag-queue payload of one multi-token decode chunk: the [B, k]
    sampled-token matrix and [B] advanced counts (host copies in
    flight), the chunk size and the dispatch timestamp for the
    decode_chunk span."""

    __slots__ = ("out", "advanced", "k", "t_dispatch", "cost")

    def __init__(self, out, advanced, k, t_dispatch, cost=None):
        self.out = out
        self.advanced = advanced
        self.k = k
        self.t_dispatch = t_dispatch
        # the chunk's program ledger entry (None without a ledger)
        self.cost = cost


class StepPlan:
    """One scheduler iteration's device work, decided entirely at plan
    time: which engine op runs (plain decode / K-token chunk / spec
    verify), the per-slot constraints it carries (grammar masks, chunk
    budgets, draft tokens), how many KV rows per slot it may commit,
    and whether its results must drain synchronously because a sampled
    token the next plan depends on cannot be known in advance. The
    executor dispatches every plan the same way; composition decisions
    live only in the planner."""

    __slots__ = ("kind", "k", "sync", "mask", "mask_stack",
                 "mask_idx", "mask_stack_idx", "drafts", "dlen",
                 "budget", "rows", "mask_s")

    def __init__(self, kind, k=1, sync=False, mask=None,
                 mask_stack=None, mask_idx=None, mask_stack_idx=None,
                 drafts=None, dlen=None, budget=None,
                 rows=1, mask_s=0.0):
        self.kind = kind              # "decode" | "chunk" | "verify"
        self.k = k                    # chunk length / max draft tokens
        self.sync = sync              # drain everything after dispatch
        self.mask = mask              # [B, V] allowed-token mask
        self.mask_stack = mask_stack  # [B, k, V] per-iteration masks
        # device mask-table row indices replacing the dense arrays
        # above when every referenced grammar state is resident: row 0
        # is the reserved all-True row unmasked slots point at
        self.mask_idx = mask_idx            # [B] or [B, k+1] int32
        self.mask_stack_idx = mask_stack_idx  # [B, k] int32
        self.drafts = drafts          # [B, k] draft tokens (verify)
        self.dlen = dlen              # [B] draft lengths (verify)
        self.budget = budget          # [B] per-slot chunk budget
        self.rows = rows              # KV rows this plan writes/slot
        self.mask_s = mask_s          # host seconds building masks


# degradation causes the planner can count — a fixed enum so the
# counter's label cardinality is bounded. `masked` counts only a masker
# whose automaton cannot be copied (no grammar walk); `spec_realign` a
# pipeline flush that re-anchors drafts.
DEGRADE_CAUSES = ("masked", "spec_realign")


# fixed width of the per-slot device stop table: stop ids past this
# count are detected on the host only (the device just freezes later —
# overshoot is discarded at the drain, so streams stay identical)
_STOP_TABLE_WIDTH = 4


class ClassQueues:
    """Per-priority-class pending queues served in weighted-fair order
    (start-time fair queueing, Goyal et al.), presenting the
    queue.Queue surface the scheduler and its callers use: `maxsize`
    (per-class bound), `qsize()`, `empty()`, `put_nowait()` raising
    queue.Full, `get(timeout)`/`get_nowait()` raising queue.Empty, and
    a flat `.queue` snapshot view.

    A request's cost is its max_new_tokens budget. On arrival it gets
    a virtual start tag, max(V, F[class]), and advances its class's
    finish tag F[class] by cost / weight; a pick serves the head whose
    start tag is least (ties: the higher class) and sets the virtual
    time V to that tag. While classes contend, served tokens track the
    weights (8 : 4 : 1); no class starves; an idle class forfeits what
    it did not use (its next start is V, never earlier); a single class
    enqueued — or ``enabled=False`` — is plain FIFO; an oversized
    request is deprioritized in proportion to its cost.

    The reference (ome_tpu/engine/scheduler.py) serves the same weights
    by deficit round-robin, which stays on a class while its 64 x
    weight tokens of credit last: an interactive request arriving while
    the cursor sits on batch waits behind up to 64 tokens of batch
    admissions. With two slots that window is long enough for the
    chaos harness's weighted-share invariant (invariant 6) to read the
    queued interactive class as starved; a start tag puts it next in
    line at the first free slot instead (and
    `Scheduler._preempt_for_class` frees one when every slot is busy
    and a lower class holds more than its share of them)."""

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
        # start tags of the queued requests, parallel to _q
        self._tags: Dict[str, "collections.deque[float]"] = {
            c: collections.deque() for c in self.classes}
        self._finish = {c: 0.0 for c in self.classes}
        self._vtime = 0.0

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
            cls = self._cls(req)
            dq = self._q[cls]
            if self.maxsize and len(dq) >= self.maxsize:
                raise queue.Full
            start = max(self._vtime, self._finish[cls])
            self._finish[cls] = start + (max(int(req.max_new_tokens), 1)
                                         / self.weights[cls])
            dq.append(req)
            self._tags[cls].append(start)
            self._not_empty.notify()

    def _pick_locked(self) -> Optional["Request"]:
        best = None
        for cls in self.classes:  # highest class first: it wins ties
            tags = self._tags[cls]
            if tags and (best is None or tags[0] < self._tags[best][0]):
                best = cls
        if best is None:
            return None
        self._vtime = self._tags[best].popleft()
        return self._q[best].popleft()

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
    # structured outputs: a TokenMasker (engine/structured.py)
    # constrains sampling to valid continuations of its grammar
    masker: Optional[object] = None
    # multi-LoRA adapter name (the request's model id when it names a
    # registered adapter); None = the base model
    adapter: Optional[str] = None
    # cross-replica prefix reuse: a peer replica that holds this
    # prompt's prefix (X-OME-Prefix-Peer); admission tries fetching the
    # prefix KV from it before computing the prefill locally
    prefix_peer: Optional[str] = None
    # multi-tenant priority class: drives the WDRR pick order and the
    # per-class admission caps
    priority: str = DEFAULT_PRIORITY
    # absolute time.monotonic() deadline; an expired request is shed at
    # admission or finished mid-decode with finish_reason="timeout"
    deadline: Optional[float] = None
    # request-lifecycle tracing: the SpanContext the HTTP layer adopted
    # (or minted) for this request
    trace: Optional[object] = None
    # durable requests (engine/journal.py): the journal id this request
    # is recorded under; assigned at admit, carried by restart-resumed
    # requests so progress keeps appending to the original entry
    journal_id: Optional[int] = None
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
                 journal=None,
                 span_log=None,
                 flight: Optional[FlightRecorder] = None,
                 flight_dump_dir: Optional[str] = None,
                 span_chunk_steps: int = 8,
                 class_weights=None,
                 class_wait_caps=None,
                 priority_scheduling: bool = True,
                 slow_step_factor: float = 4.0,
                 spec_tokens: int = 0,
                 steps_per_dispatch: int = 1,
                 grammar_table: bool = True):
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
        # cross-replica prefix reuse (engine/peering.py): built on the
        # first X-OME-Prefix-Peer request; holds per-peer breakers
        self._peer_client = None
        # durable requests (engine/journal.py): when set, every unmasked
        # admission is journaled, progress records append at each step
        # boundary, and restart resume replays whatever has no
        # tombstone. Masked (structured-output) requests are NOT
        # journaled — their grammar state is not serializable, so a
        # resumed fold could not rebuild it.
        self.journal = journal
        # decode pipelining: number of decode steps dispatched ahead of
        # token emission. 0 = fetch every step synchronously; 1 = step
        # k's tokens are read only after step k+1 was dispatched
        self.pipeline_depth = max(int(pipeline_depth), 0)
        # speculative decoding: max draft tokens per slot per step
        # proposed by the host-side n-gram drafter (engine/spec.py) and
        # verified in ONE batched forward. 0 = off; steps where no slot
        # drafts, or a slot is near the cache capacity, run plainly, so
        # greedy streams are identical either way
        self.spec_tokens = max(int(spec_tokens), 0)
        # multi-token decode: K decode iterations per engine call
        # (decode_multi), the host syncing once per K-token chunk
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        # per-slot predicted continuation beyond the committed stream:
        # [] = in sync with the device, a token list = exactly what the
        # plans still in flight will emit (forced grammar tokens,
        # full-accept draft predictions), None = unknown until a drain
        # or flush re-anchors it
        self._planned_tail: List[Optional[List[int]]] = \
            [[] for _ in range(engine.max_slots)]
        # shared telemetry registry: the EngineServer scrapes it on
        # /metrics; stats-dict counters below are mirrored into it
        self.registry = registry or Registry()
        if self.journal is not None:
            self.journal.bind(self.registry)
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
        # device-resident [B, NS] per-slot stop table for multi-step
        # chunks, cached on the same invalidation rule
        self._stops_dev: Optional[torch.Tensor] = None
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
            "restarts_total": 0, "spec_steps_total": 0,
            "spec_proposed_tokens_total": 0,
            "spec_accepted_tokens_total": 0,
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
        self._h_spec_accept = R.histogram(
            "ome_engine_spec_accept_rate",
            "Per-verify-step fraction of proposed draft tokens "
            "accepted (steps where at least one slot drafted)",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        self._h_spec_accepted = R.histogram(
            "ome_engine_spec_accepted_tokens_per_step",
            "Accepted draft tokens per drafting slot per verify step",
            buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
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
        # host-memory spill tier (zeros unless --prefix-cache-host-mb)
        self._c_pc_host_hits = R.counter(
            "ome_engine_prefix_host_hits_total",
            "Prefix blocks found host-resident on match (each kicks "
            "an async swap-in; the current request recomputes)")
        self._c_pc_host_swapins = R.counter(
            "ome_engine_prefix_host_swapins_total",
            "Prefix blocks promoted host -> device by the swap thread")
        self._c_pc_host_recomputes = R.counter(
            "ome_engine_prefix_host_recomputes_total",
            "Requests that recomputed a host-resident prefix locally "
            "instead of waiting for the swap-in")
        self._g_pc_host_bytes = R.gauge(
            "ome_engine_prefix_host_bytes",
            "Host bytes resident in the prefix-cache spill tier")
        # engines with metrics of their own (the PD prefill pool) attach
        # them to the shared registry, and log their peer failovers into
        # the same lifecycle ring as the scheduler's events
        bind = getattr(engine, "bind_registry", None)
        if callable(bind):
            bind(self.registry)
        bindf = getattr(engine, "bind_flight", None)
        if callable(bindf):
            bindf(self.flight)
        # performance attribution (ome_tpu_torch/perf): the engine's
        # program cost ledger exports through this registry and flight
        # ring, and a real engine gets an HBM accountant refreshed from
        # update_gauges() (fakes in tests have no cfg -> None)
        led = getattr(engine, "ledger", None)
        if led is not None and callable(getattr(led, "bind", None)):
            led.bind(self.registry, self.flight)
        self.hbm = HbmAccountant.for_engine(engine, self.registry,
                                            self.flight)
        # step-phase attribution from timestamps the loop already
        # crosses: dispatch (the decode call), mask_apply (grammar mask
        # build), device_wait (blocking at the lag-queue read),
        # host_sample (token emit after the read)
        self._h_step_phase = R.histogram(
            "ome_engine_step_phase_seconds",
            "Decode step time attributed by phase (dispatch / "
            "mask_apply / device_wait / host_sample)",
            labelnames=("phase",), buckets=STEP_BUCKETS)
        self._ph_dispatch = self._h_step_phase.labels(phase="dispatch")
        self._ph_mask = self._h_step_phase.labels(phase="mask_apply")
        self._ph_wait = self._h_step_phase.labels(phase="device_wait")
        self._ph_sample = self._h_step_phase.labels(phase="host_sample")
        # multi-step chunks attribute their whole dispatch here (K
        # tokens per observation) instead of `dispatch` (1 token)
        self._ph_device_loop = self._h_step_phase.labels(
            phase="device_loop")
        self._g_steps_per_dispatch = R.gauge(
            "ome_engine_steps_per_dispatch",
            "Decode iterations per engine dispatch (the "
            "--steps-per-dispatch K; 1 = per-token dispatch)")
        self._g_steps_per_dispatch.set(self.steps_per_dispatch)
        self._c_flight_events = R.counter(
            "ome_engine_flight_events_total",
            "Scheduler lifecycle events recorded by the flight ring")
        self._c_flight_dumps = R.counter(
            "ome_engine_flight_dumps_total",
            "Flight-recorder dumps written on crash recovery")
        # step-plan degradations: counted whenever the planner gives up
        # a composition feature (a masker it cannot walk, a pipeline
        # flush to re-anchor drafts); children pre-created for the
        # fixed cause enum so absent causes scrape as explicit zeros
        _deg = R.counter(
            "ome_engine_step_degradations_total",
            "Steps where the planner degraded a composition feature, "
            "by cause (masked / spec_realign)",
            labelnames=("cause",))
        self._c_degrade = {c: _deg.labels(cause=c)
                           for c in DEGRADE_CAUSES}
        # device-resident grammar-mask cache (engine/maskcache.py):
        # compiled automaton-state masks live as rows of the engine's
        # [S, V] device mask table and plans reference them by row index
        # instead of shipping dense [B, K, V] bools. None = dense masks
        # only (grammar_table=False — the dense baseline)
        self._c_gmask_hit = R.counter(
            "ome_engine_grammar_mask_cache_hits_total",
            "Grammar-state mask lookups served by the device-resident "
            "row cache")
        self._c_gmask_miss = R.counter(
            "ome_engine_grammar_mask_cache_misses_total",
            "Grammar-state mask lookups that compiled a fresh mask "
            "(uploading a row when one was free)")
        self._c_gmask_evict = R.counter(
            "ome_engine_grammar_mask_cache_evictions_total",
            "Grammar-state mask rows reused for a new state (LRU; the "
            "overwriting upload is the invalidation)")
        self._g_gmask_resident = R.gauge(
            "ome_engine_grammar_states_resident",
            "Automaton states currently resident in the device mask "
            "table")
        self._gcache = None
        _mrows = int(getattr(engine, "mask_table_rows", 0) or 0)
        if grammar_table and _mrows >= 2 and callable(
                getattr(engine, "set_mask_row", None)):
            from .maskcache import GrammarMaskCache
            self._gcache = GrammarMaskCache(
                _mrows, upload=engine.set_mask_row,
                on_hit=self._c_gmask_hit.inc,
                on_miss=self._c_gmask_miss.inc,
                on_evict=self._c_gmask_evict.inc)

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
        # online roofline: the ledger's bytes-per-dispatch over the
        # measured dispatch time, gauged every step and distributed for
        # the long view; only meaningful when the engine carries a
        # ledger (fakes skip the update path)
        self._g_roofline_eff = R.gauge(
            "ome_engine_roofline_efficiency",
            "Expected-over-measured time of the last decode dispatch "
            "(1.0 = running at the device roofline)")
        self._g_achieved_gbps = R.gauge(
            "ome_engine_step_achieved_gbps",
            "Ledger bytes of the last decode dispatch over its "
            "measured wall time, in GB/s")
        self._h_roofline_eff = R.histogram(
            "ome_engine_roofline_step_efficiency",
            "Per-dispatch roofline efficiency distribution",
            buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                     0.9, 1.0, 1.25, 1.5))
        self._c_slow_steps = R.counter(
            "ome_engine_slow_steps_total",
            "Decode steps exceeding slow_step_factor x the rolling "
            "median step time (each also records a slow_step flight "
            "event)")
        # rolling per-step-time window feeding the slow-step detector;
        # only the decode thread touches it
        self._step_window: "collections.deque[float]" = \
            collections.deque(maxlen=64)
        self._journal_compactions_seen = (
            self.journal.compactions if self.journal is not None else 0)

    @property
    def status(self) -> str:
        return self._status

    @property
    def degradations(self) -> Dict[str, int]:
        """Per-cause degradation counts for /health: every composition
        the planner had to give up."""
        return {c: int(ch.value) for c, ch in self._c_degrade.items()}

    def _degrade(self, cause: str) -> None:
        self._c_degrade[cause].inc()
        self._flight_event("step_degradation", cause=cause)

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
        """Installed as req.on_finish at submit: latency observations,
        the request's closing spans and the journal's terminal record.
        A `shutdown` finish (drain-timeout eviction) or an
        `engine_fault` from a dead scheduler leaves the journal entry
        live — the process is going away and a restart resumes the
        work; every other reason means the request is DONE and
        tombstones it."""
        self._observe_finish(req)
        self._flush_decode_chunk(req, final=True)
        span = getattr(req, "_span", None)
        if span is not None and self.span_log.enabled:
            span.end(req.finished_at)
            span.set(request=req.id, finish_reason=req.finish_reason,
                     prompt_tokens=len(req.prompt_ids),
                     output_tokens=len(req.output_ids))
            self.span_log.write(span)
        if self.journal is not None:
            resumable = req.finish_reason == "shutdown" or (
                req.finish_reason == "engine_fault"
                and self._status == "dead")
            self.journal.finish(req, resumable=resumable)

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
        """Point-in-time JSON snapshot behind GET /debug/state: live
        slots, queue/pool/journal counters, flight-ring state. Reads
        are lock-free on purpose (the scheduler thread owns the
        structures); a concurrent mutation can skew one field."""
        slots = []
        for slot, req in enumerate(list(self.slots)):
            if req is None:
                continue
            slots.append({"slot": slot, "request": req.id,
                          "journal_id": req.journal_id,
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
        j = self.journal
        state["journal"] = None if j is None else {
            "path": j.path, "appends": j.appends, "errors": j.errors,
            "compactions": j.compactions, "replayed": j.replayed,
            "degraded": j.degraded, "bytes": j._bytes}
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
                                    pc.evictions),
                                   (self._c_pc_host_hits, pc.host_hits),
                                   (self._c_pc_host_swapins,
                                    pc.host_swapins),
                                   (self._c_pc_host_recomputes,
                                    pc.host_recomputes)):
                delta = value - counter.value
                if delta > 0:
                    counter.inc(delta)
            self._g_pc_bytes.set(pc.bytes)
            self._g_pc_host_bytes.set(pc.host_bytes)
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
        pd = getattr(self.engine, "update_pd_gauges", None)
        if callable(pd):
            pd()
        # live device-memory partition (perf/hbm.py): refreshed per
        # scrape, not per step
        if self.hbm is not None:
            self.hbm.update(self.engine)

    # -- public --------------------------------------------------------

    def _queue_wait_estimate(self, depth: int) -> Optional[float]:
        """Rough seconds until a newly queued request would start
        decoding: the requests of the queue that a free slot does not
        take at once (depth less the slots free now, none being
        admitted) in batch waves x observed per-request decode steps x
        observed step time; 0.0 when a slot is free for it. None until
        both EWMAs have samples (cold start admits optimistically).

        The reference counts a whole wave for a request that finds a
        slot free, so an idle replica whose step-time EWMA a slow
        stretch raised sheds (429) its next long request; here it
        admits it."""
        if depth <= 0 or self._ewma_step_s is None \
                or self._ewma_req_steps is None:
            return None
        free = sum(1 for s in self.slots if s is None) \
            - self._admitting - self._ready.qsize()
        waiting = depth - max(free, 0)
        if waiting <= 0:
            return 0.0
        waves = math.ceil(waiting / self.engine.max_slots)
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
            journal_it = self.journal is not None and req.masker is None
        # journal the admit with the scheduler lock RELEASED: the append
        # fsyncs (policy "always"), and the decode thread takes
        # self._lock per emitted token. Writing before the queue put
        # also pins the replay ordering: once the request is visible, a
        # fast finish may call journal.finish at once, and the tombstone
        # must land after an admit record, not before one.
        if journal_it:
            self.journal.admit(req)
        reject: Optional[Tuple[str, Exception]] = None
        with self._lock:
            # re-check what can have flipped while the journal synced
            if self._stop.is_set() or self._status == "dead":
                reject = ("shutdown",
                          RuntimeError("scheduler unavailable"))
            elif self._draining:
                reject = ("draining", SchedulerDraining(
                    "scheduler draining (shutdown signal received); "
                    "resubmit to another replica"))
            else:
                depth = self.pending.qsize()
                try:
                    self.pending.put_nowait(req)
                except queue.Full:
                    self._inc_locked("rejected_total")
                    self._c_class_rejected[cls].inc()
                    reject = ("rejected", SchedulerOverloaded(
                        f"{cls} pending queue full", retry_after=1.0))
                else:
                    self._flight_event("admit", request=req.id, cls=cls,
                                       depth=depth + 1)
        if reject is not None:
            # tombstone OUTSIDE the lock too — it appends + fsyncs
            self._journal_tombstone(req, journal_it, reject[0])
            raise reject[1]
        return req

    def _journal_tombstone(self, req: Request, journal_it: bool,
                           reason: str):
        """A request was journaled as admitted but then rejected in the
        re-check window (stop/drain/queue-full raced the journal
        fsync). Without the tombstone the admit record stays live and
        the next process would replay a request the client was told to
        retry elsewhere — a duplicate."""
        if not journal_it:
            return
        if req.finish_reason is None:
            req.finish_reason = reason
        self.journal.finish(req, resumable=False)

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

    # -- restart resume ------------------------------------------------

    def resume_from_journal(self) -> int:
        """Re-admit every unfinished request the journal replays, with
        generated-so-far tokens folded into the prompt — the
        recompute-resume fold paged-KV preemption uses — so a greedy
        stream continues byte-identical to an uninterrupted run.
        Original deadlines are honored (journaled as epoch, converted
        back to this process's monotonic clock); an entry that expired
        while the replica was down finishes `timeout` through the
        normal dead-on-arrival shedding. On a PD decode node the
        resumed prompt re-prefills through the prefill pool like any
        other. Returns the number of requests re-admitted."""
        j = self.journal
        if j is None:
            return 0
        t0_mono = time.monotonic()
        t0_wall = time.time()
        try:
            entries = j.replay()
        except Exception:  # noqa: BLE001 — a corrupt journal must not
            # stop the replica from serving new work
            log.exception("journal replay failed; starting empty")
            j._count(j._c_errors, "errors")
            return 0
        n = 0
        now_mono = time.monotonic()
        now_wall = time.time()
        for e in entries:
            deadline = None
            if e.deadline_epoch is not None:
                deadline = now_mono + (e.deadline_epoch - now_wall)
            req = Request(
                prompt_ids=list(e.prompt_ids) + list(e.output_ids),
                max_new_tokens=e.max_new_tokens,
                temperature=e.temperature, top_k=e.top_k,
                top_p=e.top_p, stop_ids=list(e.stop_ids),
                adapter=e.adapter, deadline=deadline,
                priority=e.cls, journal_id=e.jid,
                output_ids=list(e.output_ids))
            if len(req.output_ids) >= req.max_new_tokens:
                # it had already produced its whole budget; only the
                # tombstone was lost to the crash
                req.finish("length")
                j.finish(req)
                continue
            try:
                self.submit(req)
            except SchedulerOverloaded:
                # more journal than queue: leave the entry live for the
                # next restart rather than dropping it
                log.warning("journal: queue full, request %d not resumed "
                            "(stays journaled)", e.jid)
                continue
            n += 1
        if n:
            j.note_replayed(n)
            log.info("journal: resumed %d unfinished request(s)", n)
        self._flight_event("journal_replay", entries=len(entries),
                           resumed=n)
        if self.span_log.enabled:
            s = Span("engine.journal_replay",
                     trace_id=self._span_ctx.trace_id,
                     parent_id=self._span_ctx.span_id,
                     start_mono=t0_mono, start_wall=t0_wall)
            s.end().set(entries=len(entries), resumed=n)
            self.span_log.write(s)
        return n

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
        if self.priority_scheduling:
            self._preempt_for_class()
        if self.overlap:
            admitted = self._insert_ready()
        else:
            active = any(r is not None for r in self.slots)
            admitted = self._admit(limit=1 if active else None)
        decoded = self._decode()
        if self.journal is not None:
            # progress records cover everything emitted up to this step
            # boundary, so a crash never loses a token a client already
            # saw; the batch fsync policy piggybacks here
            self.journal.poll()
            comp = self.journal.compactions
            if comp > self._journal_compactions_seen:
                self._journal_compactions_seen = comp
                self._flight_event("journal_compaction", count=comp)
        with self._lock:
            self.stats["queue_depth"] = self.pending.qsize()
            self.stats["active_slots"] = sum(
                r is not None for r in self.slots)
        return admitted or decoded

    def _preempt_for_class(self) -> None:
        """Class-aware preemption at admission. When every slot is
        busy, no recompute-requeued request waits, and a class is
        queued above a running request's, one running request of an
        OVER-QUOTA class below the queued one leaves its slot: lowest
        class first, then least progress since its admission. It takes
        the recompute fold of paged-KV preemption and goes back into its
        class queue, so the queued higher class takes the slot at the
        next admission instead of after a whole request.

        A class is over quota when it holds more slots than its weight
        share of all the slots, rounded up, among the classes that hold
        or wait for slots (`_preempt_rank`'s share, with the queued
        classes counted). So a class with demand keeps at least one
        slot, and keeps it while the higher class has a backlog: a
        request that start-time fair queueing admits is not evicted at
        the next step. A departure from the reference, which preempts
        by class only under KV pool pressure: the chaos harness's
        weighted-share invariant reads a queued class as starved while
        it waits for a slot."""
        if self._requeue or any(r is None for r in self.slots):
            return
        depths = self.pending.depths()
        queued = [c for c, n in depths.items() if n]
        if not queued:
            return
        top = max(CLASS_LEVEL.get(c, 1) for c in queued)
        held = collections.Counter(self._class_of(r) for r in self.slots)
        wsum = sum(self.class_weights[c] for c in set(held) | set(queued))
        over = {c for c, n in held.items()
                if n > math.ceil(len(self.slots) * self.class_weights[c]
                                 / wsum - 1e-9)}

        def rank(slot):
            req = self.slots[slot]
            return (CLASS_LEVEL.get(self._class_of(req), 1),
                    len(req.output_ids) - int(self._base_out[slot]))
        victims = [s for s in range(len(self.slots))
                   if self._class_of(self.slots[s]) in over
                   and rank(s)[0] < top]
        if not victims:
            return
        slot = min(victims, key=rank)
        req = self.slots[slot]
        cls = self._class_of(req)
        if self.pending.maxsize and depths.get(cls, 0) >= \
                self.pending.maxsize:
            return
        # settle the lagged steps first: the victim's emitted tokens
        # are final before they are folded into its prompt
        self._flush_inflight()
        if self.slots[slot] is not req or \
                any(r is None for r in self.slots):
            return  # a slot came free while the steps drained
        self.engine.free_slot(slot)
        self._evict_to_recompute(slot, "preempt_class")
        try:
            self.pending.put_nowait(req)
        except queue.Full:  # its class filled up since the check
            self._requeue.append(req)

    def _evict_to_recompute(self, slot: int, event: str) -> Request:
        """Take the request out of `slot` for recompute preemption: the
        tokens generated SINCE this admission fold into its prompt
        (outputs[:base_out] were folded by an earlier preemption and
        already sit inside prompt_ids; re-adding them would corrupt the
        resume prompt), and the caller requeues it for a re-prefill."""
        req = self.slots[slot]
        self.slots[slot] = None
        self._slot_changed(slot)
        self._temp[slot] = 0.0
        base = int(self._base_out[slot])
        req.prompt_ids = list(req.prompt_ids) + list(req.output_ids[base:])
        self._flush_decode_chunk(req, final=True)
        self._flight_event(event, slot=slot, request=req.id,
                           folded=len(req.output_ids) - base)
        self._inc("preemptions_total")
        self._c_class_preempt[self._class_of(req)].inc()
        if self.overlap:
            self._free_slots.release()
        return req

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
                    tok, kv, true_len, bucket = self._prefill_req(
                        req, span=pspan)
                except self._transient_errors() as e:
                    # the request's own problem, never an engine fault:
                    # an unknown adapter, or (PD decode nodes) a peer
                    # fetch that failed over the whole pool
                    log.warning("transient prefill failure for request "
                                "%s: %s", req.id, e)
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
            except self._transient_errors():
                # a PD insert of fetched KV failed: this request fails,
                # the node stays up
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
                    tok, kv, true_len, bucket = self._prefill_req(
                        req, span=pspan)
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
                except self._transient_errors():
                    # an unknown adapter, or a PD fetch/insert failure
                    # on a synchronous-step node: fails ONE request
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
        the previous occupant, the planner's predicted tail resets
        (a new occupant has nothing beyond its committed stream), and
        the device sampling cache is dropped so the next dispatch
        re-uploads the new [B] params."""
        self._slot_gen[slot] += 1
        self._planned_tail[slot] = []
        self._sampling_dev = None
        self._stops_dev = None

    def _sampling(self):
        """Device-resident (temperature, top_k, top_p) for the whole
        batch, re-uploaded only after an occupancy/param change — not
        three fresh host arrays per decode step."""
        if self._sampling_dev is None:
            dev = getattr(self.engine, "device", None)
            self._sampling_dev = (torch.tensor(self._temp, device=dev),
                                  torch.tensor(self._top_k, device=dev),
                                  torch.tensor(self._top_p, device=dev))
        return self._sampling_dev

    def _stop_table(self):
        """Device-resident [B, NS] stop table for multi-step chunks
        (-1 padding never matches a sampled token), cached like the
        sampling params: re-uploaded only on occupancy change. Stop
        ids past the fixed width stay host-detected — the device
        table being a SUBSET of each request's stop set only costs
        discarded overshoot, never a wrong stream."""
        if self._stops_dev is None:
            tab = np.full((self.engine.max_slots, _STOP_TABLE_WIDTH),
                          -1, np.int32)
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                ids = list(req.stop_ids)[:_STOP_TABLE_WIDTH]
                tab[slot, :len(ids)] = ids
            self._stops_dev = torch.tensor(
                tab, device=getattr(self.engine, "device", None))
        return self._stops_dev

    def _multi_budget(self, k: int) -> np.ndarray:
        """Per-slot remaining-token cap for one chunk. Under
        pipelining this over-counts by whatever is still in flight
        (output_ids lags the device) — deliberately: the device may
        only run LONG, and _maybe_finish cuts the stream at the exact
        budget when the chunk drains, so K=1 and K=8 emit identical
        bytes."""
        budget = np.zeros(self.engine.max_slots, np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            budget[slot] = min(
                max(req.max_new_tokens - len(req.output_ids), 0), k)
        return budget

    @staticmethod
    def _flight_rows(payload) -> int:
        """Device KV rows one lag-queue entry may commit per slot —
        the unit the paged reserve / lookahead / spec-headroom
        accounting sums over plans still in flight (shape reads are
        metadata only, never a device sync)."""
        if isinstance(payload, _SpecStep):
            return int(payload.out.shape[1])
        if isinstance(payload, _MultiStep):
            return int(payload.k)
        return 1

    def _inflight_rows(self) -> int:
        """Summed per-slot KV rows of every plan still in flight."""
        return sum(self._flight_rows(p) for p, _, _ in self._inflight)

    def _note_actual(self, slot: int, toks) -> None:
        """Reconcile one drained slot against the planner's predicted
        tail: an exact prefix match consumes it; any divergence marks
        the slot's device-side continuation unknown, and the next plan
        that needs it re-anchors by flushing (docs/step-plan.md)."""
        tail = self._planned_tail[slot]
        if tail is None:
            return
        toks = [int(t) for t in toks]
        n = len(toks)
        if len(tail) >= n and tail[:n] == toks:
            self._planned_tail[slot] = tail[n:]
        else:
            self._planned_tail[slot] = None

    def _flush_inflight(self) -> bool:
        """Drain every lagged step and re-anchor the planner's
        predicted tails at the committed stream (host and device now
        agree). Returns True when the drain finished every slot."""
        self._drain_inflight()
        for s in range(len(self._planned_tail)):
            self._planned_tail[s] = []
        return not any(r is not None for r in self.slots)

    def _drain_inflight(self, keep: int = 0) -> bool:
        """Read dispatched steps older than the newest `keep`, oldest
        first, emitting each token whose slot still holds the SAME
        admission it was sampled for. Slots that finished, preempted,
        failed, or were re-admitted since dispatch had their
        generation bumped, so their speculative token is discarded
        here. This is the decode loop's only device->host token fetch —
        under pipelining it runs AFTER the next step was dispatched, and
        the host copy the engine queued is usually already complete."""
        did = False
        drained = 0
        while len(self._inflight) > keep:
            toks, snap_slots, snap_gens = self._inflight.popleft()
            if isinstance(toks, _SpecStep):
                self._drain_spec(toks, snap_slots, snap_gens)
                did = True
                drained += 1
                continue
            if isinstance(toks, _MultiStep):
                self._drain_multi(toks, snap_slots, snap_gens)
                did = True
                drained += 1
                continue
            # phase attribution: the block below is the lag-queue
            # read — the only point the host waits on the device —
            # and the emit loop after it is host-side sampling/offload
            t_read = time.monotonic()
            host_toks = np.asarray(toks)
            t_fetched = time.monotonic()
            self._ph_wait.observe(t_fetched - t_read)
            for slot, req in enumerate(snap_slots):
                if (req is None or self.slots[slot] is not req
                        or self._slot_gen[slot] != snap_gens[slot]):
                    continue
                tok = int(host_toks[slot])
                self._note_actual(slot, (tok,))
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

    def _drain_spec(self, step: _SpecStep, snap_slots, snap_gens):
        """Emit one drained verify step: slot b produced
        out[b, :accepted[b]+1] (accepted draft prefix + one sampled
        token). Runs only from _drain_inflight — the host fetch below
        completes the async copies verify() started. A slot that
        finishes mid-prefix (stop token / deadline / length) discards
        the rest of its accepted tokens, exactly as those steps would
        never have run without speculation; the usual generation
        check discards whole slots that changed occupant since
        dispatch."""
        t_read = time.monotonic()
        host_out = np.asarray(step.out)
        host_acc = np.asarray(step.accepted)
        t_fetched = time.monotonic()
        self._ph_wait.observe(t_fetched - t_read)
        dlen = step.draft_len
        proposed = int(dlen.sum())
        accepted = 0
        if proposed:
            # acceptance accounting covers every drafting slot, even
            # ones whose tokens are later discarded — the drafter/
            # verify quality signal is about what the model accepted
            accepted = int(host_acc.sum())
            self._h_spec_accept.observe(accepted / proposed)
            for slot in np.nonzero(dlen)[0]:
                self._h_spec_accepted.observe(int(host_acc[slot]))
            self._inc("spec_accepted_tokens_total", accepted)
        self._spec_last = (proposed, accepted)
        self._flight_event("spec_accept", proposed=proposed,
                           accepted=accepted)
        commit = getattr(self.engine, "commit_spec", None)
        # later plans were dispatched against block pre-allocations
        # covering their rows; commit must not trim those
        reserve = self._inflight_rows()
        for slot, req in enumerate(snap_slots):
            if (req is None or self.slots[slot] is not req
                    or self._slot_gen[slot] != snap_gens[slot]):
                continue
            n = int(host_acc[slot]) + 1
            if commit is not None:
                # paged KV: reconcile the host length mirror and
                # return the speculative surplus blocks to the pool
                commit(slot, n, reserve=reserve)
            self._note_actual(slot, host_out[slot, :n])
            self._note_decode_progress(req, tokens=n)
            for tok in host_out[slot, :n]:
                req.emit(int(tok))
                self._inc("tokens_generated_total")
                self._c_class_tokens[self._class_of(req)].inc()
                self._maybe_finish(slot, int(tok))
                if self.slots[slot] is not req:
                    break  # finished mid-prefix: drop the tail
        if self.span_log.enabled and step.t_dispatch:
            # one span per verify round, timed dispatch-to-drain (the
            # lag a pipelined verify rides shows up as span length)
            s = Span("engine.spec_verify",
                     trace_id=self._span_ctx.trace_id,
                     parent_id=self._span_ctx.span_id,
                     start_mono=step.t_dispatch,
                     start_wall=time.time() - (time.monotonic()
                                               - step.t_dispatch))
            s.end().set(proposed=proposed, accepted=accepted)
            self.span_log.write(s)
        self._ph_sample.observe(time.monotonic() - t_fetched)

    def _drain_multi(self, step: _MultiStep, snap_slots, snap_gens):
        """Emit one drained multi-token chunk: slot b produced
        step.out[b, :advanced[b]] (docs/multi-step-decode.md). Runs
        only from _drain_inflight — the host fetch below completes
        the async copies decode_multi() started; it is the chunk's
        single device sync. The overshoot/discard rule: _maybe_finish
        applies every host finish condition (full stop set, deadline,
        exact budget, capacity) token by token, so everything the
        device ran past a host finish is dropped here — including a
        mid-chunk EOS tail — and the usual generation check drops
        whole slots whose occupant changed since dispatch. Paged
        engines reconcile allocator state per slot via commit_spec,
        reserving rows for chunks still in flight."""
        t_read = time.monotonic()
        host_out = np.asarray(step.out)       # [B, k]
        host_adv = np.asarray(step.advanced)  # [B]
        t_fetched = time.monotonic()
        self._ph_wait.observe(t_fetched - t_read)
        commit = getattr(self.engine, "commit_spec", None)
        # later plans were dispatched against block pre-allocations
        # covering their rows; commit must not trim those
        reserve = self._inflight_rows()
        emitted = 0
        for slot, req in enumerate(snap_slots):
            if (req is None or self.slots[slot] is not req
                    or self._slot_gen[slot] != snap_gens[slot]):
                continue
            n = int(host_adv[slot])
            if commit is not None:
                commit(slot, n, reserve=reserve)
            self._note_actual(slot, host_out[slot, :n])
            if n:
                self._note_decode_progress(req, tokens=n)
            for tok in host_out[slot, :n]:
                req.emit(int(tok))
                emitted += 1
                self._inc("tokens_generated_total")
                self._c_class_tokens[self._class_of(req)].inc()
                self._maybe_finish(slot, int(tok))
                if self.slots[slot] is not req:
                    break  # finished mid-chunk: overshoot discarded
        if self.span_log.enabled:
            s = Span("engine.decode_chunk",
                     trace_id=self._span_ctx.trace_id,
                     parent_id=self._span_ctx.span_id,
                     start_mono=step.t_dispatch,
                     start_wall=time.time() - (time.monotonic()
                                               - step.t_dispatch))
            s.end().set(steps_per_dispatch=step.k, tokens=emitted)
            if step.cost is not None:
                # cost attribution from the program ledger: which
                # program this chunk ran and what the roofline said it
                # should have cost
                s.set(program=step.cost["program"],
                      expected_ms=round(step.cost["expected_ms"], 3),
                      program_bytes=step.cost["bytes"])
            self.span_log.write(s)
        self._flight_event("multi_chunk", k=step.k, emitted=emitted)
        self._ph_sample.observe(time.monotonic() - t_fetched)

    def _decode(self) -> bool:
        if not any(r is not None for r in self.slots):
            # the batch drained while a step was still in flight: read
            # it out (every token discards — its slot finished) so the
            # entry cannot strand
            self._dispatch_end = None
            return self._drain_inflight()
        # deterministic fault injection (tests, chaos drills): only
        # real decode steps count as hits. A fault here leaves the
        # lag queue to _recover, which drops it unread — lagged
        # tokens of a failed batch are never emitted.
        faults.fire("engine_step")
        plan = self._plan_step()
        if plan is None:
            return True  # a precondition drain finished every slot
        return self._execute(plan)

    def _plan_step(self) -> Optional[StepPlan]:
        """Build this iteration's StepPlan (docs/step-plan.md).

        Composition is decided here, once: grammar-masked slots are
        walked ahead through forced-token runs so they ride chunks
        and the pipeline; speculative drafts are built over each
        slot's predicted continuation so verify steps pipeline too;
        a plan is marked `sync` only where a sampled token the NEXT
        plan depends on cannot be known in advance (a grammar
        boundary). Preconditions the planner cannot meet are
        re-established by flushing the lag queue — counted in the
        degradation counter, never silently. Returns None when such
        a flush finished every slot."""
        B = self.engine.max_slots
        # with nothing in flight the committed stream IS the device
        # state: re-anchor every predicted tail
        if not self._inflight:
            for s in range(B):
                self._planned_tail[s] = []
        k_steps = self.steps_per_dispatch
        masked_slots = [s for s, r in enumerate(self.slots)
                        if r is not None and r.masker is not None]
        # -- grammar walk: advance a COPY of each masked slot's
        # automaton over its predicted tail, then through enough
        # future positions for whichever plan shape wins (one mask
        # each, jumping ahead through forced tokens). Rows looked up
        # during this plan are pinned until the next one.
        spec_on = self.spec_tokens > 0
        horizon = max(k_steps, self.spec_tokens + 1 if spec_on else 1,
                      1)
        if self._gcache is not None and masked_slots:
            self._gcache.begin_plan()
        tm0 = time.monotonic()
        mask_s = 0.0
        walks: Dict[int, tuple] = {}
        legacy_masked = False
        for s in masked_slots:
            m = self.slots[s].masker
            if (self._planned_tail[s] is None
                    or not callable(getattr(m, "copy", None))):
                legacy_masked = True
                break
            try:
                walks[s] = self._walk_masker(s, horizon)
            except AttributeError:
                # the masker copies but its automaton cannot
                legacy_masked = True
                break
        if legacy_masked:
            # plan precondition re-established by draining: a grammar
            # that cannot be walked ahead is only consistent with the
            # committed stream, so nothing may be in flight when its
            # mask is built — one synchronous masked step, exactly
            # the pre-plan behavior for copyless maskers, and the one
            # case that still counts as a masked degradation
            self._degrade("masked")
            if self._inflight and self._flush_inflight():
                return None
            mask = self._build_mask()
            mask_s = time.monotonic() - tm0
            self._ph_mask.observe(mask_s)
            return StepPlan("decode", sync=True, mask=mask,
                            mask_s=mask_s)
        if masked_slots:
            mask_s = time.monotonic() - tm0
            self._ph_mask.observe(mask_s)
        # -- speculative drafts over predicted continuations. Masked
        # slots draft THROUGH the grammar when their mask rows are
        # device-resident: forced runs verbatim (the masked target
        # distribution accepts them with certainty) plus
        # grammar-screened n-gram proposals past a free boundary —
        # a proposal leaving the grammar just truncates the draft.
        # Without resident rows they ride verify steps at draft
        # length 0 with their position-0 mask applied densely. A
        # batch where any slot is within the in-flight-rows + k+1
        # headroom of cache capacity falls back for the step (the
        # verify write needs that many rows).
        drafts = dlen = None
        vrows = None
        if spec_on:
            k = self.spec_tokens
            drafts, dlen = self._build_drafts(k)
            if dlen.any() and self._inflight and any(
                    dlen[s] and self._planned_tail[s] is None
                    for s in range(B) if self.slots[s] is not None):
                # draft positional alignment is a plan precondition:
                # a drafting slot whose device-side continuation is
                # unpredicted would draft against a stale stream and
                # the verify would reject nearly everything. Flush,
                # re-anchor, re-draft — and count it: realign
                # flushes are the price of a mispredicted pipeline.
                self._degrade("spec_realign")
                if self._flush_inflight():
                    return None
                drafts, dlen = self._build_drafts(k)
            if masked_slots and self._gcache is not None and all(
                    (not walks[s][0]) or walks[s][3][0] is not None
                    for s in masked_slots if s in walks):
                vrows = {}
                for s in masked_slots:
                    if self.slots[s] is None or not walks[s][0]:
                        continue
                    dm = self._draft_masked(s, walks[s], k)
                    if dm is None:
                        vrows = None
                        break
                    vrows[s] = dm
                if vrows is not None:
                    # only now that EVERY masked slot has resident
                    # rows may masked drafts land: a dense fallback
                    # masks position 0 only, so a half-applied plan
                    # would let rejected drafts emit unmasked tokens
                    for s, (rows_s, toks_s, bonus_free) in \
                            vrows.items():
                        if toks_s:
                            drafts[s, :len(toks_s)] = toks_s
                            dlen[s] = len(toks_s)
            if not dlen.any() or not self._spec_headroom(k):
                drafts = dlen = None  # nobody drafted: plain/chunk
                vrows = None
        if drafts is not None:
            # verify plan: a multi-token-shaped dispatch that
            # pipelines like any chunk; sync only when a masked
            # slot's next free sample lands at or before its bonus
            # position (the token only the device can decide)
            mask = None
            mask_idx = None
            sync = False
            if masked_slots:
                V = self.engine.cfg.vocab_size
                if vrows is not None:
                    mask_idx = np.zeros((B, self.spec_tokens + 1),
                                        dtype=np.int32)
                    for s, (rows_s, _toks, bonus_free) in \
                            vrows.items():
                        mask_idx[s, :len(rows_s)] = rows_s
                        if bonus_free:
                            sync = True
                else:
                    mask = np.ones((B, V), dtype=bool)
                    for s in masked_slots:
                        if s not in walks:
                            continue
                        w_masks, w_forced, w_boundary, _ = walks[s]
                        if w_masks:
                            mask[s] = w_masks[0]
                        if w_boundary and not w_forced:
                            sync = True
            plan = StepPlan("verify", k=self.spec_tokens, sync=sync,
                            mask=mask, mask_idx=mask_idx,
                            drafts=drafts, dlen=dlen,
                            rows=self.spec_tokens + 1, mask_s=mask_s)
            self._predict_verify(plan, walks)
            return plan
        # -- chunk length: the device may not run PAST a grammar
        # boundary (the token sampled there decides every later
        # mask), so the nearest boundary clamps K for the whole
        # batch; a boundary inside the chunk also marks it sync
        n = max(k_steps, 1)
        for s in masked_slots:
            w_masks, w_forced, w_boundary, _ = walks[s]
            if w_boundary:
                n = min(n, len(w_forced) + 1)
        sync = any(walks[s][2] and len(walks[s][1]) < n
                   for s in masked_slots)
        if n > 1:
            budget = self._multi_budget(n)
            stack = None
            stack_idx = None
            if masked_slots:
                V = self.engine.cfg.vocab_size
                if self._gcache is not None and all(
                        all(r is not None for r in walks[s][3][:n])
                        for s in masked_slots):
                    stack_idx = np.zeros((B, n), dtype=np.int32)
                    for s in masked_slots:
                        rows_s = walks[s][3][:n]
                        if rows_s:
                            stack_idx[s, :len(rows_s)] = rows_s
                        budget[s] = min(int(budget[s]),
                                        len(walks[s][0]))
                else:
                    stack = np.ones((B, n, V), dtype=bool)
                    for s in masked_slots:
                        w_masks, w_forced, w_boundary, _ = walks[s]
                        for i, row in enumerate(w_masks[:n]):
                            stack[s, i] = row
                        budget[s] = min(int(budget[s]), len(w_masks))
            plan = StepPlan("chunk", k=n, sync=sync,
                            mask_stack=stack,
                            mask_stack_idx=stack_idx, budget=budget,
                            rows=n, mask_s=mask_s)
        else:
            mask = None
            mask_idx = None
            if masked_slots:
                V = self.engine.cfg.vocab_size
                if self._gcache is not None and all(
                        (not walks[s][0]) or walks[s][3][0] is not None
                        for s in masked_slots):
                    mask_idx = np.zeros(B, dtype=np.int32)
                    for s in masked_slots:
                        if walks[s][0]:
                            mask_idx[s] = walks[s][3][0]
                else:
                    mask = np.ones((B, V), dtype=bool)
                    for s in masked_slots:
                        w_masks, w_forced, w_boundary, _ = walks[s]
                        if w_masks:
                            mask[s] = w_masks[0]
            plan = StepPlan("decode", sync=sync, mask=mask,
                            mask_idx=mask_idx, mask_s=mask_s)
        self._predict_step(plan, walks, n)
        return plan

    def _walk_masker(self, slot: int, horizon: int):
        """Advance a COPY of the slot's grammar ahead of its
        committed stream: feed the predicted in-flight tail, then
        walk up to `horizon` future positions, collecting the
        allowed-token mask at each and jumping through forced tokens
        (positions where the grammar allows exactly one — closing
        braces, fixed keys, separators). Returns (masks, forced,
        boundary, rows): one [V] mask per walked position, the
        forced tokens (always a prefix of the walk), whether the
        walk stopped at a boundary — a position whose token only the
        device can decide — and one device mask-table row index per
        position (None where the state is uncacheable or the table
        is exhausted; plans fall back to dense masks around Nones).
        Raises AttributeError when the underlying automaton cannot
        be copied (the caller falls back to one synchronous masked
        step)."""
        req = self.slots[slot]
        walker = req.masker.copy()
        tail = self._planned_tail[slot] or []
        for tok in tail:
            walker.feed(tok)
        V = self.engine.cfg.vocab_size
        masks: list = []
        forced: list = []
        rows: list = []
        boundary = False
        produced = len(req.output_ids) + len(tail)
        for i in range(horizon):
            if walker.done():
                break
            remaining = req.max_new_tokens - produced - i
            if remaining <= 0:
                break
            closing = remaining <= walker.closing_distance() + 4
            row, ridx = self._lookup_mask(walker, V, closing,
                                          remaining)
            masks.append(row)
            rows.append(ridx)
            allowed = np.flatnonzero(row)
            if allowed.size == 1:
                tok = int(allowed[0])
                forced.append(tok)
                walker.feed(tok)
            else:
                boundary = True
                break
        return masks, forced, boundary, rows

    def _lookup_mask(self, walker, V: int, closing: bool,
                     remaining: Optional[int]):
        """One walked position's allowed-token mask, served through
        the device-resident row cache when the automaton state is
        cacheable. A cached entry holds the state's BUDGET-FREE mask
        plus its recorded slack — the worst closing-distance growth
        any accepted token causes — and substitutes for the budgeted
        dense mask exactly when `remaining - 1 >= closing_distance +
        slack` (past that horizon the budget provably bans nothing).
        Everything else — closing masks, tight budgets, automatons
        without a signature, a table exhausted by pinned rows —
        computes the dense mask host-side. Returns (bits, device row
        index or None)."""
        gc = self._gcache
        if gc is not None and not closing:
            key_fn = getattr(walker, "cache_key", None)
            key = key_fn() if key_fn is not None else None
            if key is not None:
                ent = gc.get(key)
                if ent is None:
                    # compile + install the budget-free mask; its
                    # slack is only known after compiling, so even a
                    # position whose budget ends up too tight to use
                    # it installs the entry for future positions
                    bits, slack = walker.mask_with_slack(V)
                    ent = gc.insert(key, bits, slack)
                    self._g_gmask_resident.set(len(gc))
                if ent is not None:
                    bits, ridx, slack = ent
                    if remaining is None or remaining - 1 \
                            >= walker.closing_distance() + slack:
                        return bits, ridx
        return walker.mask(V, closing=closing,
                           remaining=remaining), None

    def _draft_masked(self, slot: int, walk, k: int):
        """Spec through the grammar (docs/structured-outputs.md):
        build a masked slot's draft from its walk. The forced run
        drafts verbatim — the masked target distribution puts
        probability 1 on each forced token at any temperature, so
        those drafts are accepted with certainty. Past a free
        boundary the n-gram drafter proposes and every proposal is
        filtered through the automaton walk: a proposal the grammar
        rejects truncates the draft (a rejected draft, never an
        invalid emission). Returns (rows, draft tokens, bonus_free):
        device mask rows for positions 0..len(drafts) — the verify
        program masks every position so rejection resampling stays
        in-grammar — and whether the position after the draft is a
        free sample (which makes the plan sync). None when position
        0 itself has no resident row."""
        w_masks, w_forced, w_boundary, w_rows = walk
        npos = len(w_masks)
        if npos == 0 or w_rows[0] is None:
            return None
        # longest forced prefix whose positions 0..d all have rows
        d = min(k, len(w_forced), npos - 1)
        while d > 0 and any(w_rows[j] is None for j in range(d + 1)):
            d -= 1
        rows = [w_rows[j] for j in range(d + 1)]
        toks = [int(t) for t in w_forced[:d]]
        bonus_free = d >= len(w_forced) and w_boundary
        if bonus_free and d < k:
            req = self.slots[slot]
            walker = req.masker.copy()
            tail = self._planned_tail[slot] or []
            for t in tail:
                walker.feed(t)
            for t in toks:
                walker.feed(t)
            produced = len(req.output_ids) + len(tail)
            stream = (list(req.prompt_ids)
                      + list(req.output_ids[int(self._base_out[slot]):])
                      + tail + toks)
            V = self.engine.cfg.vocab_size
            state = {"bits": w_masks[d], "d": d}

            def accept(t: int) -> bool:
                if not state["bits"][t]:
                    return False  # proposal exits the grammar
                walker.feed(t)
                rem = (req.max_new_tokens - produced
                       - (state["d"] + 1))
                if rem <= 0 or walker.done():
                    return False
                closing = rem <= walker.closing_distance() + 4
                nbits, nrow = self._lookup_mask(walker, V, closing,
                                                rem)
                if nrow is None:
                    return False  # next position not resident
                toks.append(t)
                rows.append(nrow)
                state["bits"] = nbits
                state["d"] += 1
                return True

            spec_drafter.grammar_prefix(
                spec_drafter.propose(stream, k - d), accept)
        return rows, toks, bonus_free

    def _predict_step(self, plan: StepPlan, walks: Dict[int, tuple],
                      n: int) -> None:
        """Extend each slot's predicted tail with what this
        decode/chunk plan will deterministically emit: forced grammar
        tokens are exact; a freely sampled position makes the slot's
        continuation unknown until the step drains. Sync plans drain
        immediately, so their tails re-anchor at the next plan."""
        if plan.sync:
            return
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            tail = self._planned_tail[s]
            if tail is None:
                continue
            if s in walks:
                self._planned_tail[s] = tail + walks[s][1][:n]
            else:
                self._planned_tail[s] = None

    def _predict_verify(self, plan: StepPlan,
                        walks: Dict[int, tuple]) -> None:
        """Predict each slot's continuation through a verify plan:
        the optimistic outcome is every draft accepted plus the
        drafter's own guess at the bonus token. Wrong predictions
        never emit a wrong byte — the drain reconciles against what
        the device actually produced and the next plan flushes if it
        needs an alignment the prediction lost."""
        if plan.sync:
            return
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            tail = self._planned_tail[s]
            if tail is None:
                continue
            if s in walks:
                # a masked slot advances its forced-run draft plus
                # the bonus: drafted forced tokens are accepted with
                # certainty (the masked target distribution forces
                # them) and a non-sync plan's bonus position is
                # forced too — free-bonus plans are sync and never
                # reach here
                d = int(plan.dlen[s]) if plan.dlen is not None else 0
                self._planned_tail[s] = tail + walks[s][1][:d + 1]
                continue
            d = int(plan.dlen[s])
            if d == 0:
                # a free position-0 sample: unknown until drained
                self._planned_tail[s] = None
                continue
            drafted = [int(t) for t in plan.drafts[s, :d]]
            stream = (list(r.prompt_ids)
                      + list(r.output_ids[int(self._base_out[s]):])
                      + tail + drafted)
            bonus = spec_drafter.propose(stream, 1)
            if bonus.size:
                self._planned_tail[s] = (tail + drafted
                                         + [int(bonus[0])])
            else:
                self._planned_tail[s] = None

    def _execute(self, plan: StepPlan) -> bool:
        """Dispatch one StepPlan, feed the lag queue, drain. Every
        plan takes the same path: one compiled-program call keyed on
        plan.kind, one lag-queue append, one windowed drain — the
        generation-counter discard rules do the rest. The executor
        never decides composition; it only honors plan.sync by
        running this step's window at depth 0."""
        sampling = self._sampling()
        t0 = time.monotonic()
        gap_s = None
        if self._dispatch_end is not None:
            gap_s = t0 - self._dispatch_end
            self._h_step_gap.observe(gap_s)
        n_steps = plan.k if plan.kind == "chunk" else 1
        if plan.kind == "verify":
            kw = {}
            if getattr(self.engine, "kv_block", 0):
                # paged pre-allocation must cover this plan AND every
                # plan still in flight (their commits have not
                # advanced the host length mirror yet)
                kw["lookahead_rows"] = self._inflight_rows() + plan.rows
            if plan.mask_idx is not None:
                kw["mask_idx"] = plan.mask_idx
            elif plan.mask is not None:
                kw["mask"] = plan.mask
            self.state, out, acc = self.engine.verify(
                self.state, plan.drafts, plan.dlen, *sampling, **kw)
            toks = _SpecStep(out, acc, plan.dlen, t0)
        elif plan.kind == "chunk":
            kw = {}
            if plan.mask_stack_idx is not None:
                kw["mask_idx"] = plan.mask_stack_idx
            elif plan.mask_stack is not None:
                kw["mask"] = plan.mask_stack
            self.state, out, adv = self.engine.decode_multi(
                self.state, *sampling, steps=plan.k,
                budget=plan.budget, stop_ids=self._stop_table(),
                lookahead_rows=self._inflight_rows() + plan.rows,
                **kw)
            led = getattr(self.engine, "ledger", None)
            toks = _MultiStep(
                out, adv, plan.k, t0,
                cost=led.last_dispatch() if led is not None else None)
        elif plan.mask_idx is not None:
            self.state, toks = self.engine.decode(
                self.state, *sampling, mask_idx=plan.mask_idx)
        elif plan.mask is not None:
            self.state, toks = self.engine.decode(
                self.state, *sampling, mask=plan.mask)
        else:  # engine wrappers/fakes need no mask kwarg in their API
            self.state, toks = self.engine.decode(
                self.state, *sampling)
        self._dispatch_end = time.monotonic()
        dt = self._dispatch_end - t0
        # per-STEP time (the queue-wait estimator and step histogram
        # stay per-token): a K-chunk dispatch amortizes over K steps
        dt_step = dt / n_steps
        self._ewma_step_s = dt_step if self._ewma_step_s is None \
            else 0.9 * self._ewma_step_s + 0.1 * dt_step
        self._h_decode_step.observe(dt_step)
        if n_steps > 1:
            self._ph_device_loop.observe(dt)
        else:
            self._ph_dispatch.observe(dt)
        self._observe_roofline(dt, dt_step, n_steps, gap_s, plan.mask_s)
        self._inc("decode_steps_total", n_steps)
        if plan.kind == "verify":
            self._inc("spec_steps_total")
            self._inc("spec_proposed_tokens_total",
                      int(plan.dlen.sum()))
        self._inflight.append(
            (toks, list(self.slots), list(self._slot_gen)))
        depth = 0 if plan.sync else self.pipeline_depth
        # emit steps older than the pipeline window — with the next
        # step now dispatched, reading them costs no dispatch overlap
        self._drain_inflight(keep=max(depth, 1))
        # paged-KV pool pressure may have evicted sequences BEFORE the
        # step above ran — the token it samples for them is garbage
        # (their new KV row went to the trash block), so requeue
        # without emitting: the generation bump makes the lag queue
        # discard their pending token, and generated-so-far tokens
        # ride along as prompt for the re-prefill (vLLM recompute
        # preemption). Their PREVIOUS step's token was valid and was
        # emitted by the drain above, before output_ids was folded in.
        take = getattr(self.engine, "take_preempted", None)
        for slot in (take() if take is not None else ()):
            if self.slots[slot] is not None:
                self._requeue.appendleft(
                    self._evict_to_recompute(slot, "preempt_fold"))
        if depth == 0:
            self._drain_inflight()
        return True

    def _observe_roofline(self, dt: float, dt_step: float, k_steps: int,
                          gap_s, mask_s: float) -> None:
        """Per-dispatch online roofline and slow-step outlier
        detection. Both read the ledger entry of the program just
        dispatched — engines without one (fakes, remote wrappers) only
        feed the slow-step window. "Slow" is relative to the rolling
        median of recent per-step times (this batch shape on this
        device); warm-up is excluded by requiring a half-full window
        before judging."""
        led = getattr(self.engine, "ledger", None)
        entry = led.last_dispatch() if led is not None else None
        if entry is not None and dt > 0:
            self._g_achieved_gbps.set(entry["bytes"] / dt / 1e9)
            eff = (entry["expected_ms"] / 1000.0) / dt
            self._g_roofline_eff.set(eff)
            self._h_roofline_eff.observe(eff)
        win = self._step_window
        if len(win) >= win.maxlen // 2:
            med = sorted(win)[len(win) // 2]
            if med > 0 and dt_step > self.slow_step_factor * med:
                self._c_slow_steps.inc()
                fields = dict(
                    step_ms=round(dt_step * 1e3, 3),
                    median_ms=round(med * 1e3, 3),
                    ratio=round(dt_step / med, 2), k_steps=k_steps,
                    mask_ms=round(mask_s * 1e3, 3),
                    gap_ms=round((gap_s or 0.0) * 1e3, 3))
                if entry is not None:
                    fields["program"] = entry["program"]
                    fields["expected_ms"] = round(entry["expected_ms"], 3)
                self._flight_event("slow_step", **fields)
        win.append(dt_step)

    def _spec_headroom(self, k: int) -> bool:
        """True when every active slot has cache headroom for the k+1
        speculative KV rows a verify step writes — plus the exact
        rows every plan still in flight may commit. A near-capacity
        slot makes the whole step fall back to plain decode (it
        finishes with reason=length within a step or two anyway);
        without this, a clamped multi-row cache write would corrupt
        earlier rows."""
        need = self._inflight_rows() + (k + 1)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            used = (int(self._true_len[slot]) + len(req.output_ids)
                    - int(self._base_out[slot]))
            if used + need > self.engine.max_seq:
                return False
        return True

    def _build_drafts(self, k: int):
        """Per-slot n-gram drafts from each request's host-visible
        committed stream (prompt + emitted output) EXTENDED by its
        predicted in-flight tail, so drafts align with where the
        device will be when the verify runs — the precondition that
        lets verify steps pipeline. A slot whose tail is unknown
        drafts from the committed stream alone (the planner flushes
        before dispatching if that draft would be misaligned).
        Masked slots never draft: their continuation belongs to the
        grammar walk, not the n-gram cache. Returns ([B, k] int32
        drafts, [B] int32 draft lengths); a slot with no match
        drafts 0 tokens and degenerates to plain decode inside the
        verify."""
        B = self.engine.max_slots
        drafts = np.zeros((B, k), np.int32)
        dlen = np.zeros((B,), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None or req.masker is not None:
                continue
            # outputs[:base_out] of a resumed request are already
            # folded into prompt_ids — slicing keeps the drafter's
            # view of the stream free of duplicated spans
            d = spec_drafter.propose(
                list(req.prompt_ids)
                + list(req.output_ids[int(self._base_out[slot]):])
                + (self._planned_tail[slot] or []), k)
            if d.size:
                drafts[slot, :d.size] = d
                dlen[slot] = d.size
        return drafts, dlen

    def _transient_errors(self) -> tuple:
        """Errors that fail one request, never the engine: an unknown
        adapter, and what the engine declares transient (a PD decode
        node's peer fetch and insert failures)."""
        return (UnknownAdapterError,) + tuple(
            getattr(self.engine, "transient_prefill_errors", ()))

    def _peer_prefill(self, req: Request, peer: str):
        """Try fetching this prompt's prefix KV from the peer replica
        named by X-OME-Prefix-Peer — an engine.prefill-shaped result, or
        None, and then the caller computes the prefill locally. A fetch
        seeds the LOCAL prefix cache, so the next same-prefix request
        hits on the device without any peer. Runs on the admission path
        (the admission thread under overlap), like a local prefill."""
        if self._peer_client is None:
            from .peering import PrefixPeerClient
            self._peer_client = PrefixPeerClient(registry=self.registry)
        res = self._peer_client.fetch(
            peer, req.prompt_ids, temperature=req.temperature,
            top_k=req.top_k, top_p=req.top_p, deadline=req.deadline,
            priority=req.priority, trace=req.trace)
        if res is None:
            self.flight.record("prefix_peer_fallback", peer=peer,
                               request_id=req.id)
            return None
        token, (k, v), true_len, bucket = res
        from .pd import upload_planes
        eng = self.engine
        k, v = upload_planes(k, v, eng.device, eng.cfg.dtype)
        eng.prefix_cache.put(list(req.prompt_ids)[-true_len:], k, v,
                             true_len, bucket)
        self.flight.record("prefix_peer_fetch", peer=peer,
                           request_id=req.id, prefix_len=true_len)
        return token, (k, v), true_len, bucket

    def _prefill_req(self, req: Request, span: Optional[Span] = None):
        """Engine prefill for one request; constrained requests pass
        the grammar mask for their FIRST sampled token. An eligible
        request (base model, unconstrained, not a PD decode node, not a
        tp group's leader) whose router named a prefix peer tries that
        peer first; any failure falls through to the local prefill. A
        group leader (`multihost.ReplicatedEngine`) prefills locally:
        its followers could not follow a fetch only the leader made (the
        reference's leader fetches, and its followers insert their own
        last prefill instead)."""
        pd_node = getattr(self.engine, "pd_request_context", False)
        if (req.prefix_peer and req.adapter is None and req.masker is None
                and not pd_node
                and not getattr(self.engine, "replicated", False)):
            fetched = self._peer_prefill(req, req.prefix_peer)
            if fetched is not None:
                return fetched
        kw = {}
        if req.adapter is not None:
            kw["adapter"] = req.adapter
        if req.masker is not None:
            kw["first_mask"] = req.masker.mask(
                self.engine.cfg.vocab_size,
                remaining=req.max_new_tokens)
        if pd_node:
            # PD decode nodes cap each fetch attempt at the request's
            # deadline and stamp its traceparent on the wire; the
            # priority class rides along. The prefill span is the
            # context, so per-peer attempt spans nest under it
            kw["deadline"] = req.deadline
            kw["priority"] = req.priority
            trace = req.trace
            if span is not None:
                trace = SpanContext(trace_id=span.trace_id,
                                    span_id=span.span_id)
            kw["trace"] = trace
        return self.engine.prefill(req.prompt_ids, req.temperature,
                                   req.top_k, req.top_p, **kw)

    def _build_mask(self):
        """[B, V] allowed-token mask when any slot is constrained
        (structured outputs); None otherwise so the maskless step keeps
        running."""
        if not any(r is not None and r.masker is not None
                   for r in self.slots):
            return None
        V = self.engine.cfg.vocab_size
        mask = np.ones((self.engine.max_slots, V), dtype=bool)
        for slot, r in enumerate(self.slots):
            if r is not None and r.masker is not None:
                remaining = r.max_new_tokens - len(r.output_ids)
                # switch to close-out masks before the budget can
                # strand an open string/container (valid JSON even at
                # finish_reason=length); `remaining` additionally bans
                # tokens whose completion cost overshoots the budget
                closing = remaining <= r.masker.closing_distance() + 4
                mask[slot] = r.masker.mask(V, closing=closing,
                                           remaining=remaining)
        return mask

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
        if req.masker is not None:
            req.masker.feed(tok)
        if req.masker is not None and req.masker.done():
            reason = "stop"  # the grammar accepted a complete value
        elif tok in req.stop_ids:
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
