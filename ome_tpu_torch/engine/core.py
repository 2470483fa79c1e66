"""Inference engine core: slot-based continuous batching in PyTorch.

Port of the dense subset of ome_tpu/engine/core.py:

  * a fixed decode batch of `max_slots` slots, one sequence each, all
    stepping together whatever mix of requests is in flight;
  * prefill per request at bucketed lengths, producing a KV prefix that
    is *inserted* into a slot; with the prefix cache on, a prompt whose
    leading blocks are cached runs only its suffix, from a nonzero base
    position into a cache seeded with the cached prefix;
  * per-slot cache write positions (lengths [B]) so every slot sits at
    a different sequence length;
  * sampling params as [B] tensors;
  * with `kv_block` > 0, a paged KV cache: a pool of fixed-size blocks
    shared by all slots, with a host-side block allocator (block
    table, owned lists, free list, preemption under pool pressure),
    in bf16/fp32 or, with `kv_dtype="int8"`, int8 with per-(row, head)
    f32 scales (quantize on insert and on append). Decode attention
    then goes through the paged CUDA kernel (ops/paged.py).

The reference jits three programs that donate their state buffers so
XLA updates the cache in place. PyTorch runs eagerly; here the cache
tensors are updated in place directly (`insert` copies a prefill's KV
into its slot or its pool blocks, `decode` writes each new row), which
keeps the same single copy of the cache on the device.

The scheduler's step plans run through the ops below (the reference's
`_decode_multi*` / `_verify*` programs and its host block ops):

  * `decode_multi` runs K decode iterations in one call: a Python loop
    over tensors on the device that samples, appends KV and feeds each
    token back, freezing a slot with `torch.where` on a stop-table
    token, its budget or the cache capacity. Nothing inside the chunk
    reads the device from the host; the outputs' host copies are queued
    behind the chunk, so the caller syncs once per chunk. On a card
    each iteration runs the decode kernel (B1 dense, B3 paged);
  * `verify` scores k drafted tokens plus a bonus position in one
    forward of S = k+1 rows (dense: the prefill kernel B2 from
    base = lengths; paged: the plain `paged_attention_multi`) and
    accepts per slot with `sampling.spec_verify`;
  * a paged chunk or verify pre-allocates the blocks of every row it
    may write (`_grow_blocks_spec`), so the block table is static for
    the call; `commit_spec` reconciles the host length mirror after the
    drain and returns the surplus;
  * grammar masks: `decode`, `decode_multi` and `verify` take a dense
    allowed-token mask or indices into a device-resident mask table
    (`_mask_table`, filled row by row by `set_mask_row`); `prefill`
    takes a `first_mask` for the first sampled token.

The prefix cache keeps its host-memory spill tier (`prefix_host_bytes`,
serve's `--prefix-cache-host-mb`): evicted blocks are copied to host
memory and swapped back in by a background thread on a later hit.
`insert` also takes host planes — a fetched PD or peer KV blob
(engine/pd.py, engine/peering.py) — and carries them to the slot's rows
or pool blocks.

Multi-LoRA serving (`lora_slots` > 0, serve's `--adapter name=DIR`):
per-adapter factor stacks beside the layer leaves, `<leaf>_lora_a`
[L, slots+1, r, K] and `<leaf>_lora_b` [L, slots+1, r, N] in the compute
dtype (slot 0 all zeros = the base model; MoE models take the attention
targets only). Every op that runs the model passes the slots' adapter
ids (`DecodeState.adapters`, a prefill's own id) with the stacks, dense
and paged alike; an op whose batch holds no adapter runs the base
products alone, which a zero delta would leave unchanged.
`register_adapter` writes a slot out of place and swaps the stacks'
reference under `_lora_lock`, so a step already dispatched keeps the
stacks it read; `unregister_adapter` refuses while a decode slot still
holds the adapter. Adapter prefills bypass the prefix cache's tiers.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import itertools
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device, to_device, to_host
from ..models import llama
from ..models.config import ModelConfig
from ..models.lora import _target_dims, load_adapter_matrices
from ..models.params import Params
from ..ops.flash import (check_model_head_dim, check_paged_coverage,
                         quantize_rows)
from ..perf.ledger import ProgramLedger
from .sampling import sample, spec_verify

log = logging.getLogger("ome.engine.core")


@dataclasses.dataclass
class DecodeState:
    """Device-resident state of the decode batch."""

    k: torch.Tensor        # [L, B, Smax, K, Dh], paged: [L, N, bs, K, Dh]
    v: torch.Tensor        # [L, B, Smax, K, Dh], paged: [L, N, bs, K, Dh]
    lengths: torch.Tensor  # [B] int32 — valid kv rows / next write index
    tokens: torch.Tensor   # [B] int32 — last sampled token per slot
    adapters: torch.Tensor  # [B] int32 — LoRA adapter slot (0 = base)
    # int8 paged pools only ([L, N, K, bs] f32): per-(row, head)
    # dequant scales beside the quantized pools; None otherwise
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class UnknownAdapterError(ValueError):
    """Request names a LoRA adapter the engine doesn't have loaded — a
    PER-REQUEST error, never a scheduler fault."""


# the reference engine's refusal of paged KV (ome_tpu/engine/core.py)
PAGED_REFUSAL = ("paged KV supports standard rmsnorm GQA models; "
                 "MLA/MoE/sliding-window/parallel-block/layernorm/sink "
                 "models use the dense cache")


class PagedKVUnsupported(ValueError):
    """The paged KV pool cannot serve this engine: a model family the
    pool does not take, or a shape the CUDA paged decode kernel does
    not cover."""


class KVPoolExhausted(RuntimeError):
    """Paged-KV insert could not allocate blocks for a new sequence —
    BACKPRESSURE, not a fault: the scheduler requeues the request
    until streams finish and free blocks (decode-time growth instead
    preempts a victim sequence, which re-enters the queue)."""


def _bucketize(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _sampling_array(x, dtype, device) -> torch.Tensor:
    """Per-step host inputs (sampling params, budgets, drafts, masks):
    convert to a tensor on the engine's device, but pass tensors
    through untouched — the scheduler caches the sampling params and
    the stop table on the device. On a card the copy goes through
    pinned memory without blocking, so uploading a plan's inputs does
    not wait for the step still in flight."""
    if isinstance(x, torch.Tensor):
        return x
    host = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class TokenHandle:
    """Sampled tokens on their way to the host: the counterpart of the
    reference's device array with `copy_to_host_async` started.

    On a card, a non-blocking copy into pinned host memory is queued
    behind the step that sampled the tokens, with an event recorded
    after it; `np.asarray(handle)` waits on that event only, so a
    pipelined caller can dispatch the next step first."""

    __slots__ = ("_host", "_event")

    def __init__(self, toks: torch.Tensor):
        if toks.is_cuda:
            self._host = torch.empty(toks.shape, dtype=toks.dtype,
                                     pin_memory=True)
            self._host.copy_(toks, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = toks.clone()
            self._event = None

    @property
    def shape(self) -> torch.Size:
        """The tokens' shape (metadata only: no wait on the device)."""
        return self._host.shape

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class PrefixCache:
    """Radix (token-block trie) cache of prompt-prefix KV with a device
    byte budget and an optional host-memory spill tier — port of the
    reference's PrefixCache (ome_tpu/engine/core.py:110-363).

    Prompts are split into fixed token BLOCKS; each trie node owns one
    block's KV ([L, 1, block, K, Dh] tensors, copied out of the prefill
    so a node holds only its own bytes; nothing writes them after
    `put`). Sibling prompts share every common leading block. Eviction
    is byte-accounted LRU over leaf nodes: device bytes never exceed
    `capacity_bytes`. A hit returns the concatenated leading blocks.

    Host tier (`host_capacity_bytes` > 0, serve's
    `--prefix-cache-host-mb`): an evicted leaf is copied to host memory
    (an LRU keyed by the block's full token path) instead of being
    dropped. A match that continues into host-resident blocks only
    ENQUEUES their swap-in and returns the device-resident prefix: the
    admitting request recomputes the rest, and the next same-prefix
    request hits on the device. On a card a spill copies on a side
    stream into pinned memory, after the node's own copy-out and
    nothing else (`ready` event), so it never waits for the decode
    steps queued before it; the swap thread uploads on its own stream
    and attaches the node to the trie only after that copy completed.
    Spills run outside the lock (the nodes are never written after
    `put`), on the thread whose put or swap-in evicted."""

    def __init__(self, capacity_bytes: int = 0, block: int = 32,
                 min_prefix: int = 16, host_capacity_bytes: int = 0,
                 device: Optional[torch.device] = None):
        self.capacity_bytes = capacity_bytes
        # where swapped-in blocks go
        self.device = device or torch.device("cpu")
        self.block = block
        self.min_prefix = min_prefix
        self._root: Dict[tuple, dict] = {}
        self._tick = 0
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.host_capacity_bytes = host_capacity_bytes
        self.host_bytes = 0
        self.host_hits = 0
        self.host_swapins = 0
        self.host_recomputes = 0
        # path -> (host k, host v, nbytes); insertion order = LRU order
        self._host: "collections.OrderedDict" = collections.OrderedDict()
        self._tier_lock = threading.Lock()
        self._swap_q: "queue.Queue" = queue.Queue()
        self._swap_thread: Optional[threading.Thread] = None

    @staticmethod
    def _leaf_bytes(k, v) -> int:
        return k.numel() * k.element_size() + v.numel() * v.element_size()

    def put(self, ids, k, v, true_len: int, bucket: int):
        """Store the KV of `ids[:true_len]` block by block. k/v:
        [L, 1, S >= true_len, K, D] on the cache's device (rows past
        true_len are padding and never stored)."""
        if self.capacity_bytes <= 0 or true_len < self.min_prefix:
            return
        with self._tier_lock:
            node_map = self._root
            self._tick += 1
            made = []
            for off in range(0, (true_len // self.block) * self.block,
                             self.block):
                key = tuple(ids[off:off + self.block])
                node = node_map.get(key)
                if node is None:
                    ks = k[:, :, off:off + self.block].clone()
                    vs = v[:, :, off:off + self.block].clone()
                    node = {"kv": (ks, vs), "children": {},
                            "last": self._tick, "ready": None}
                    node_map[key] = node
                    made.append(node)
                    self.bytes += self._leaf_bytes(ks, vs)
                    # the device copy is authoritative again: a stale
                    # host copy of the same path only wastes host budget
                    ent = self._host.pop(tuple(ids[:off + self.block]),
                                         None)
                    if ent is not None:
                        self.host_bytes -= ent[2]
                node["last"] = self._tick
                node_map = node["children"]
            if made and k.is_cuda and self.host_capacity_bytes > 0:
                # what a later spill of these nodes waits for: their
                # copy-out, not the decode steps queued after it
                ev = torch.cuda.Event()
                ev.record()
                for node in made:
                    node["ready"] = ev
            spills = self._evict_locked()
        self._spill(spills)

    def _evict_locked(self):
        """Drop least-recently-used LEAF nodes until within budget
        (parents stay useful for the prompts that still share them).
        A parent that an eviction leaves childless becomes a candidate
        at its own tick, so the order is LRU over the leaves of the
        moment: a chain just put outlives an older one whole. (The
        reference evicts every leaf of one pass in tick order before it
        looks at the parents that pass exposed, the leaf just put
        among them: a put of n blocks into a full tier that holds one
        older chain dropped the tail of both.)
        With the host tier on, an evicted leaf is returned as
        (path, node) for the caller to spill AFTER releasing the lock —
        the device-to-host copy waits, and a lock region must never
        reach a wait."""
        spills = []
        if self.bytes <= self.capacity_bytes:
            return spills
        # (last, order, (parent map, key, node, path, parent's entry))
        heap, order = [], itertools.count()
        stack = [(self._root, (), None)]
        while stack:
            node_map, path, up = stack.pop()
            for key, node in node_map.items():
                entry = (node_map, key, node, path + key, up)
                if node["children"]:
                    stack.append((node["children"], path + key, entry))
                else:
                    heap.append((node["last"], next(order), entry))
        heapq.heapify(heap)
        while self.bytes > self.capacity_bytes and heap:
            _, _, (parent_map, key, node, path, up) = heapq.heappop(heap)
            self.bytes -= self._leaf_bytes(*node["kv"])
            self.evictions += 1
            if self.host_capacity_bytes > 0:
                spills.append((path, node))
            del parent_map[key]
            if up is not None and not up[2]["children"]:
                heapq.heappush(heap, (up[2]["last"], next(order), up))
        return spills

    def _spill(self, spills) -> None:
        """Copy evicted blocks' KV to the host tier, outside the lock,
        re-acquiring it only for the dict edits. A put() that re-created
        the same path while the copy ran wins — its device copy is
        authoritative, so the stale spill is dropped."""
        for path, node in spills:
            ks, vs = (to_host(x, after=node["ready"]) for x in node["kv"])
            nbytes = self._leaf_bytes(ks, vs)
            with self._tier_lock:
                parent = self._parent_map_locked(path)
                if parent is not None and path[-self.block:] in parent:
                    continue  # device-resident again
                old = self._host.pop(path, None)
                if old is not None:
                    self.host_bytes -= old[2]
                self._host[path] = (ks, vs, nbytes)
                self.host_bytes += nbytes
                while self.host_bytes > self.host_capacity_bytes \
                        and self._host:
                    _, (_, _, nb) = self._host.popitem(last=False)
                    self.host_bytes -= nb

    def _request_swapin(self, ids, eff: int) -> bool:
        """Queue every consecutive host-resident continuation block past
        the device hit for swap-in (called under the lock; the upload
        runs on the swap thread, so admission never waits on it).
        Returns whether anything was queued."""
        paths = []
        while eff + self.block <= len(ids) - 1:
            path = tuple(ids[:eff + self.block])
            if path not in self._host:
                break
            self._host.move_to_end(path)  # refresh the host LRU
            paths.append(path)
            eff += self.block
        if not paths:
            return False
        self.host_hits += len(paths)
        # this request cannot use host blocks (the swap must never gate
        # admission): it recomputes the remainder
        self.host_recomputes += 1
        for path in paths:
            self._swap_q.put(path)
        return True

    def _ensure_swap_thread(self) -> None:
        if self._swap_thread is not None and self._swap_thread.is_alive():
            return
        self._swap_thread = threading.Thread(
            target=self._swap_loop, name="prefix-swap", daemon=True)
        self._swap_thread.start()

    def _swap_loop(self) -> None:
        """Swap-in worker: re-attach host-tier blocks to the device
        trie. A block whose parent chain was evicted in the meantime
        stays in the host tier (a later deeper hit re-queues it)."""
        while True:
            path = self._swap_q.get()
            try:
                self._swapin_one(path)
            except Exception:  # noqa: BLE001 — a failed swap-in only
                log.exception("prefix swap-in failed")  # costs a recompute
            finally:
                self._swap_q.task_done()

    def _parent_map_locked(self, path: tuple):
        """The children map the block at `path` hangs from, or None when
        its parent chain is not device-resident."""
        node_map = self._root
        for off in range(0, len(path) - self.block, self.block):
            node = node_map.get(path[off:off + self.block])
            if node is None:
                return None
            node_map = node["children"]
        return node_map

    def _swapin_one(self, path: tuple) -> None:
        with self._tier_lock:
            ent = self._host.get(path)
            parent = self._parent_map_locked(path)
            if ent is None or parent is None \
                    or path[-self.block:] in parent:
                return
            ks, vs, _ = ent
        # the upload runs outside the lock: the host copy stays in the
        # tier (and counted) until the node is attached below
        kd, vd = self._upload(ks, vs)
        with self._tier_lock:
            key = path[-self.block:]
            parent = self._parent_map_locked(path)
            if self._host.get(path) is not ent or parent is None \
                    or key in parent:
                return  # evicted, re-put or swapped in meanwhile
            del self._host[path]
            self.host_bytes -= ent[2]
            self._tick += 1
            parent[key] = {"kv": (kd, vd), "children": {},
                           "last": self._tick, "ready": None}
            self.bytes += self._leaf_bytes(kd, vd)
            self.host_swapins += 1
            spills = self._evict_locked()
        self._spill(spills)

    def _upload(self, ks: torch.Tensor, vs: torch.Tensor):
        """A host block on the cache's device, complete on return."""
        return to_device(ks, self.device), to_device(vs, self.device)

    def drain_swapins(self, timeout: float = 5.0) -> None:
        """Block until every queued swap-in has been applied — a test
        and smoke-run hook, never called from the serving path."""
        deadline = time.monotonic() + timeout
        while self._swap_q.unfinished_tasks:
            if time.monotonic() >= deadline:
                return
            time.sleep(0.005)

    def tier_conservation(self) -> Tuple[bool, int, int]:
        """Two-tier accounting: recounted device-trie bytes and host-tier
        bytes equal the running counters, no block is resident in both
        tiers, and the host tier is within its budget. Returns (ok,
        device_blocks, host_blocks)."""
        with self._tier_lock:
            dev_bytes = dev_blocks = 0
            overlap = False
            stack = [(self._root, ())]
            while stack:
                node_map, path = stack.pop()
                for key, node in node_map.items():
                    dev_blocks += 1
                    dev_bytes += self._leaf_bytes(*node["kv"])
                    if path + key in self._host:
                        overlap = True
                    stack.append((node["children"], path + key))
            host_bytes = sum(e[2] for e in self._host.values())
            ok = (dev_bytes == self.bytes and host_bytes == self.host_bytes
                  and not overlap
                  and host_bytes <= max(self.host_capacity_bytes, 0))
            return ok, dev_blocks, len(self._host)

    def match(self, ids, usable=None) -> Optional[tuple]:
        """Longest cached STRICT prefix of `ids` in whole blocks (the
        last prompt token must re-run so its logits exist for
        sampling). Returns (k, v, eff, eff) with k/v concatenated over
        the matched blocks. `usable(eff) -> bool` vetoes prefix lengths
        the caller's budget cannot use before the hit is counted.
        Host-tier blocks never serve the current request: a match that
        continues into the host tier queues their swap-in and returns
        the device-resident prefix only (possibly None)."""
        if self.capacity_bytes <= 0:
            return None
        queued = False
        try:
            with self._tier_lock:
                limit = len(ids) - 1
                node_map = self._root
                slices = []
                eff = 0
                self._tick += 1
                while eff + self.block <= limit:
                    node = node_map.get(tuple(ids[eff:eff + self.block]))
                    if node is None:
                        break
                    node["last"] = self._tick
                    slices.append(node["kv"])
                    eff += self.block
                    node_map = node["children"]
                if self.host_capacity_bytes > 0:
                    queued = self._request_swapin(ids, eff)
                while slices and usable is not None and not usable(eff):
                    slices.pop()
                    eff -= self.block
                if eff < self.min_prefix:
                    self.misses += 1
                    return None
                self.hits += 1
                k = torch.cat([s[0] for s in slices], dim=2)
                v = torch.cat([s[1] for s in slices], dim=2)
                return (k, v, eff, eff)
        finally:
            # the thread starts outside the lock region
            if queued:
                self._ensure_swap_thread()


class InferenceEngine:
    """Prefill / insert / decode (and the step-plan ops decode_multi /
    verify) over one dense Llama model on one device, with a dense or a
    paged KV cache."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 max_slots: int = 8, max_seq: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 prefix_cache_bytes: int = 0,
                 prefix_host_bytes: int = 0,
                 kv_block: int = 0, kv_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, mask_table_rows: int = 64,
                 lora_slots: int = 0, lora_rank: int = 16,
                 ledger=None):
        self.device = resolve_device(device)
        # every attention step on a card runs the CUDA kernels (MLA's
        # plain products excepted): refuse a head_dim they do not take
        # here, not at the first prefill
        check_model_head_dim(cfg, self.device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq or cfg.max_seq_len
        # paged KV (kv_block > 0): the decode cache is a POOL of
        # `kv_blocks` fixed-size blocks + a per-slot block table
        # instead of the dense [L, B, Smax, ...] worst-case slab, so
        # device memory is sized by tokens in flight
        self.kv_block = int(kv_block)
        # int8 pools store 1 byte/element + a per-(row, head) f32 scale
        # plane: quantized on insert and append, dequantized inside the
        # paged attention kernel
        kv_dtype = (kv_dtype or "").replace("bfloat16", "bf16")
        if kv_dtype not in ("", "bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be bf16 or int8, got {kv_dtype!r}")
        self.kv_quantized = kv_dtype == "int8"
        if self.kv_quantized and not self.kv_block:
            raise ValueError(
                "--kv-dtype int8 quantizes the paged block pool; "
                "enable paged KV (--kv-block) to use it")
        # victim-ranking hook of the scheduler (set_preempt_rank) and the
        # slot whose block growth started a preemption scan
        self._preempt_rank_fn = None
        self._growing_slot: Optional[int] = None
        if self.kv_block:
            # a model-wide sliding window is served paged (the decode
            # kernel's window start is lo), where the reference refuses
            # it; alternating windows are not
            refused = [name for name, on in (
                ("MLA", cfg.mla), ("MoE", cfg.is_moe or cfg.first_k_dense),
                ("alternating sliding windows", cfg.alt_sliding_window),
                (f"norm_type {cfg.norm_type!r}",
                 cfg.norm_type != "rmsnorm"),
                ("parallel blocks", cfg.parallel_block),
                ("attention sinks", cfg.attn_sinks)) if on]
            if refused:
                # the reference's sentence word for word, then what this
                # model has (the port also serves one model-wide window)
                raise PagedKVUnsupported(
                    f"{PAGED_REFUSAL}; this model has "
                    f"{', '.join(refused)}: serve it from the dense cache "
                    "(one model-wide sliding window is served paged)")
            if self.device.type == "cuda":
                # every paged decode step runs the CUDA kernel; refuse a
                # shape it does not take here rather than at the first
                # step
                try:
                    check_paged_coverage(self.kv_block, cfg.head_dim,
                                         cfg.num_heads, cfg.num_kv_heads)
                except ValueError as e:
                    raise PagedKVUnsupported(str(e)) from None
            self.max_blocks = -(-self.max_seq // self.kv_block)
            # default pool = dense-equivalent capacity (+1: block 0 is
            # the reserved trash block, never allocated, never read by
            # a live slot)
            self.kv_blocks = kv_blocks or (
                max_slots * self.max_blocks + 1)
            self._table = np.zeros((max_slots, self.max_blocks),
                                   np.int32)
            self._owned: List[List[int]] = [[] for _ in
                                            range(max_slots)]
            self._free_blocks = list(range(self.kv_blocks - 1, 0, -1))
            self._host_len = np.zeros(max_slots, np.int64)
            self._preempted: List[int] = []
            # device copy of the block table, re-uploaded only when the
            # host table changed (insert / free_slot / a _grow_blocks
            # block append)
            self._table_dirty = True
            self._table_dev: Optional[torch.Tensor] = None
        self.model = llama.Llama(cfg, params).to(self.device)
        if prefill_buckets is None:
            prefill_buckets, b = [], 64
            while b < self.max_seq:
                prefill_buckets.append(b)
                b *= 2
            prefill_buckets.append(self.max_seq)
        self.prefill_buckets = prefill_buckets
        self.prefix_cache = PrefixCache(
            prefix_cache_bytes, host_capacity_bytes=prefix_host_bytes,
            device=self.device)
        # multi-LoRA serving: `lora_slots` zeroed factor stacks beside
        # the layer leaves ([L, slots+1, r, K] / [L, slots+1, r, N], in
        # the compute dtype, never quantized); slot 0 stays all zeros
        # (the base model). register_adapter replaces the dict whole,
        # so an op reads one consistent set of stacks
        self.lora_slots = int(lora_slots)
        self.lora_rank = int(lora_rank)
        self._lora_names: Dict[str, int] = {}
        self._lora: Dict[str, torch.Tensor] = {}
        # which adapter id each DECODE slot decodes with:
        # unregister_adapter refuses while any slot references it (a
        # freed id reused mid-stream would silently flip in-flight
        # sequences to another adapter)
        self._slot_adapters = np.zeros(max_slots, np.int32)
        self._lora_lock = threading.Lock()
        if self.lora_slots > 0:
            if cfg.is_moe and cfg.first_k_dense:
                raise ValueError("multi-LoRA does not support "
                                 "first_k_dense models yet")
            n, r, L = self.lora_slots + 1, self.lora_rank, cfg.num_layers
            for leaf, (K, N) in _target_dims(cfg).items():
                if leaf not in self.model.layer_names:
                    continue  # MoE models: attention targets only
                for suffix, width in (("_lora_a", K), ("_lora_b", N)):
                    self._lora[leaf + suffix] = torch.zeros(
                        (L, n, r, width), dtype=cfg.dtype,
                        device=self.device)
        # one generator for the admission thread's prefills and the
        # scheduler thread's decodes; the lock keeps each draw's
        # offset bump atomic (the reference's _next_key counter lock)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._rng_lock = threading.Lock()
        # device-resident grammar mask table [rows, V] bool, created
        # all-True on first touch; row 0 stays all-True (the unmasked
        # sentinel every index array defaults to)
        self.mask_table_rows = int(mask_table_rows)
        self._mask_table_dev: Optional[torch.Tensor] = None
        # program cost ledger (perf/ledger.py): every op below runs its
        # dispatch through _ledger_capture, so each program key gets one
        # cost entry; the default is mode "auto" (counted on a card, the
        # analytic model elsewhere)
        if ledger is None:
            ledger = ProgramLedger()
        if ledger.device is None:
            ledger.device = self.device
        ledger.prepare()
        self.ledger = ledger
        self._weight_bytes: Optional[int] = None
        self._param_count: Optional[int] = None

    def _sample(self, logits, temperature, top_k, top_p) -> torch.Tensor:
        with self._rng_lock:
            return sample(logits, self._gen, temperature, top_k, top_p)

    def _spec_verify(self, logits, drafts, draft_len, temperature, top_k,
                     top_p):
        with self._rng_lock:
            return spec_verify(logits, drafts, draft_len, self._gen,
                               temperature, top_k, top_p)

    # -- state ---------------------------------------------------------

    def kv_row_bytes(self) -> int:
        """Device bytes one cached KV row (all layers, all heads)
        costs. int8 pools store 1 byte/element plus two f32 scales per
        (layer, head) row."""
        cfg = self.cfg
        if self.kv_quantized:
            return cfg.num_layers * cfg.kv_cache_heads * (
                cfg.kv_cache_k_dim + cfg.kv_cache_v_dim + 2 * 4)
        itemsize = cfg.dtype.itemsize
        return (cfg.num_layers * cfg.kv_cache_heads
                * (cfg.kv_cache_k_dim + cfg.kv_cache_v_dim) * itemsize)

    # -- cost model (perf ledger and HBM accountant) --------------------

    def weight_bytes(self) -> int:
        """Device bytes of one full weight read: the quantizer's byte
        model over the model's leaves and the LoRA stacks (which the
        reference keeps among its params) — shared by the cost ledger
        and the HbmAccountant's weights tenant (perf/hbm.py)."""
        if self._weight_bytes is None:
            from ..models.quant import QTensor, _leaves, quantized_bytes
            tree = {"model": self.model.params, "lora": dict(self._lora)}
            count = 0
            for leaf in _leaves(tree):
                count += (leaf.q.numel() + leaf.s.numel()
                          if isinstance(leaf, QTensor) else leaf.numel())
            self._param_count = count
            self._weight_bytes = quantized_bytes(tree)
        return self._weight_bytes

    def _cost_model(self, tokens: int, kv_rows: int,
                    weight_passes: int = 1) -> Dict[str, float]:
        """Analytic {flops, bytes} for a program moving the whole
        weight set `weight_passes` times while processing `tokens`
        positions against `kv_rows` cached KV rows (the reference's
        model, at the port's byte counts)."""
        wb = self.weight_bytes()
        return {
            "bytes": float(weight_passes * wb
                           + kv_rows * self.kv_row_bytes()),
            "flops": 2.0 * self._param_count * max(tokens, 1),
        }

    def _kv_capacity_rows(self) -> int:
        """KV rows the decode cache can address — the bytes a decode
        step's attention streams in the worst case."""
        if self.kv_block:
            return self.kv_blocks * self.kv_block
        return self.max_slots * self.max_seq

    def _ledger_capture(self, name: str, static_desc: str, fn, args, *,
                        tokens: int, kv_rows: int,
                        weight_passes: int = 1):
        """Run the dispatch `fn()` of program `name` through the ledger
        and return its result; `args` are the tensors it reads. The
        ledger's own failures never reach the caller."""
        led = self.ledger
        if led.mode == "off":
            return fn()
        try:
            model = self._cost_model(tokens, kv_rows, weight_passes)
        except Exception:  # noqa: BLE001 - observability only
            log.debug("ledger cost model failed for %s", name,
                      exc_info=True)
            return fn()
        return led.capture(name, static_desc, fn, (self.model,) + args,
                           model)

    def _program(self, base: str, mask, mask_idx) -> str:
        """The reference's program name of a decode-batch op:
        `base` + _masked_idx / _masked + _paged."""
        masked = ("_masked_idx" if mask_idx is not None
                  else "_masked" if mask is not None else "")
        return base + masked + ("_paged" if self.kv_block else "")

    @torch.no_grad()
    def new_state(self) -> DecodeState:
        cfg = self.cfg
        L, B = cfg.num_layers, self.max_slots

        def ints():
            return torch.zeros((B,), dtype=torch.int32, device=self.device)
        if self.kv_block:
            self._table[:] = 0
            self._owned = [[] for _ in range(B)]
            self._free_blocks = list(range(self.kv_blocks - 1, 0, -1))
            self._host_len[:] = 0
            self._preempted = []
            self._table_dirty = True
            self._table_dev = None
            pool = llama.PagedKVCache.create(
                cfg, B, self.kv_blocks, self.kv_block, self.max_blocks,
                dtype=torch.int8 if self.kv_quantized else cfg.dtype,
                device=self.device)
            return DecodeState(k=pool.k, v=pool.v, lengths=ints(),
                               tokens=ints(), adapters=ints(),
                               k_scale=pool.k_scale, v_scale=pool.v_scale)
        base = (L, B, self.max_seq, cfg.kv_cache_heads)
        return DecodeState(
            k=torch.zeros(base + (cfg.kv_cache_k_dim,), dtype=cfg.dtype,
                          device=self.device),
            v=torch.zeros(base + (cfg.kv_cache_v_dim,), dtype=cfg.dtype,
                          device=self.device),
            lengths=ints(), tokens=ints(), adapters=ints())

    # -- paged-pool block allocator ------------------------------------

    def free_slot(self, slot: int) -> None:
        """Release a finished slot: its adapter reference always, its
        KV blocks in paged mode (the scheduler calls this; insert()
        also frees implicitly on slot reuse)."""
        self._slot_adapters[slot] = 0
        if not self.kv_block:
            return
        self._free_blocks.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self._table[slot] = 0
        self._table_dirty = True
        self._host_len[slot] = 0

    def take_preempted(self) -> List[int]:
        """Slots whose sequences were evicted by pool pressure since
        the last call; the scheduler requeues their requests (their
        generated-so-far tokens become part of the re-prefill
        prompt)."""
        if not self.kv_block:
            return []
        out, self._preempted = list(self._preempted), []
        return out

    def set_preempt_rank(self, fn) -> None:
        """Install a victim-ranking hook: fn(slot) -> sortable key,
        lower = preempt first. The scheduler uses it to rank by
        (quota overage, priority class); ties and the no-hook case
        fall back to least progress (cheapest to re-prefill)."""
        self._preempt_rank_fn = fn

    def _preempt_victim(self) -> bool:
        """Free the blocks of one active sequence to relieve pool
        pressure; False when none remain. Victim order: the installed
        rank hook first (class-aware), then least progress. The slot
        whose growth started the scan (`_growing_slot`) is only
        eligible when it is the sole candidate — otherwise a request
        near pool size could repeatedly evict itself (livelock)."""
        cands = [b for b in range(self.max_slots)
                 if self._owned[b] and b not in self._preempted]
        if not cands:
            return False
        if (self._growing_slot in cands and len(cands) > 1):
            cands = [b for b in cands if b != self._growing_slot]
        rank = self._preempt_rank_fn
        if rank is not None:
            victim = min(cands, key=lambda b: (rank(b),
                                               int(self._host_len[b])))
        else:
            victim = min(cands, key=lambda b: int(self._host_len[b]))
        self._preempted.append(victim)
        self.free_slot(victim)
        return True

    def _grow_blocks(self) -> None:
        """Pre-allocate the block each active slot's NEXT write needs
        (called before every paged decode step, which writes at
        index = length). Pool pressure preempts victims instead of
        failing the node (recompute preemption)."""
        for b in range(self.max_slots):
            if not self._owned[b]:
                continue
            w = int(self._host_len[b])
            if w >= self.max_seq:
                continue
            j = w // self.kv_block
            if j >= len(self._owned[b]) and j < self.max_blocks:
                self._growing_slot = b
                while not self._free_blocks:
                    if not self._preempt_victim():
                        break
                self._growing_slot = None
                if not self._owned[b]:
                    continue  # b itself was the victim
                if not self._free_blocks:
                    # nothing evictable and no block for b's next write:
                    # preempt b EXPLICITLY rather than letting its
                    # writes land in the trash block
                    self._preempted.append(b)
                    self.free_slot(b)
                    continue
                nid = self._free_blocks.pop()
                self._owned[b].append(nid)
                self._table[b, j] = nid
                self._table_dirty = True
            self._host_len[b] = w + 1  # mirror of the device +1

    def _grow_blocks_spec(self, rows: int) -> None:
        """Pre-allocate blocks covering each active slot's next `rows`
        writes (a verify step writes k+1 rows at once, a K-step chunk up
        to K) WITHOUT advancing the host length mirror: how far the
        device advanced is known only after the drain, when
        commit_spec() reconciles and returns the surplus. Pool pressure
        preempts victims exactly like _grow_blocks."""
        for b in range(self.max_slots):
            if not self._owned[b]:
                continue
            w = int(self._host_len[b])
            top = min(w + rows, self.max_seq)  # write rows [w, top)
            need = min(-(-top // self.kv_block), self.max_blocks)
            while len(self._owned[b]) < need:
                j = len(self._owned[b])
                self._growing_slot = b
                while not self._free_blocks:
                    if not self._preempt_victim():
                        break
                self._growing_slot = None
                if not self._owned[b]:
                    break  # b itself was the victim
                if not self._free_blocks:
                    # never let a live slot write into the trash block
                    self._preempted.append(b)
                    self.free_slot(b)
                    break
                nid = self._free_blocks.pop()
                self._owned[b].append(nid)
                self._table[b, j] = nid
                self._table_dirty = True

    def commit_spec(self, slot: int, advance: int,
                    reserve: int = 0) -> None:
        """Reconcile a slot's host length mirror after a drained verify
        (or multi-token decode) step advanced its device length by
        `advance`, and return the blocks allocated past the new length
        to the pool — the paged rollback of rejected draft rows.
        `reserve` keeps blocks covering that many rows PAST the new
        length: chunks already dispatched behind this one will write
        rows [len, len + reserve), and an insert must not take those
        blocks first."""
        if not self.kv_block or not self._owned[slot]:
            return
        self._host_len[slot] = min(
            int(self._host_len[slot]) + advance, self.max_seq)
        need = self.blocks_needed(min(
            int(self._host_len[slot]) + max(int(reserve), 0),
            self.max_seq))
        while len(self._owned[slot]) > need:
            nid = self._owned[slot].pop()
            self._table[slot, len(self._owned[slot])] = 0
            self._free_blocks.append(nid)
            self._table_dirty = True

    @property
    def kv_pool_stats(self) -> Dict[str, int]:
        return {"kv_blocks": getattr(self, "kv_blocks", 0),
                "kv_blocks_free": len(getattr(self, "_free_blocks",
                                              ())),
                "kv_block_tokens": self.kv_block}

    def kv_conservation(self) -> Tuple[bool, int]:
        """Block-pool conservation check: free + owned must account for
        every allocatable block (kv_blocks - 1; block 0 is the reserved
        trash block), no block may appear twice, block 0 may never be
        owned, and the block table must mirror the host owned lists.
        Returns (ok, owned_count). Authoritative at quiescence; a
        concurrent insert can make a mid-step scrape read False. The
        prefix cache's tier check applies to the dense cache too (the
        reference checks it for paged engines only)."""
        if not self.kv_block:
            return self.prefix_cache.tier_conservation()[0], 0
        free = list(self._free_blocks)
        owned_all: List[int] = []
        for slot in range(self.max_slots):
            owned = [int(b) for b in self._owned[slot]]
            owned_all.extend(owned)
            row = [int(x) for x in
                   np.asarray(self._table[slot, :len(owned)])]
            if row != owned:
                return False, len(owned_all)
        blocks = [int(b) for b in free] + owned_all
        ok = (len(blocks) == self.kv_blocks - 1
              and len(set(blocks)) == len(blocks)
              and 0 not in blocks)
        # the prefix cache's two tiers must account exactly too (device
        # trie + host LRU, no block in both): one check for the whole
        # KV hierarchy, as in the reference
        return ok and self.prefix_cache.tier_conservation()[0], \
            len(owned_all)

    def blocks_needed(self, n_tokens: int) -> int:
        """Pool blocks covering `n_tokens` KV rows + the next write —
        the single accounting used by insert() AND the scheduler's
        pre-prefill pool check (they must not drift)."""
        return min(-(-(n_tokens + 1) // self.kv_block),
                   self.max_blocks)

    # -- multi-LoRA registry -------------------------------------------

    @property
    def adapter_names(self) -> List[str]:
        return sorted(self._lora_names)

    def adapter_id(self, name: Optional[str]) -> int:
        """Resolve an adapter name to its slot id (0/None = base)."""
        if not name:
            return 0
        try:
            return self._lora_names[name]
        except KeyError:
            raise UnknownAdapterError(
                f"unknown adapter {name!r} (loaded: "
                f"{self.adapter_names or 'none'})") from None

    def _with_slot(self, stacks: Dict[str, torch.Tensor], idx: int,
                   mats: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """New stacks equal to `stacks` but with slot `idx` holding
        `mats` ({leaf: (A [L, r, K], B [L, r, N]) float32 numpy}, cast
        to the compute dtype) and zeros for every target `mats` lacks.
        Written out of place on the stream the steps run on, so a step
        already queued reads the old tensors."""
        for leaf in mats:
            if leaf + "_lora_a" not in stacks:
                raise ValueError(f"model has no target {leaf}")
        ctx = (torch.cuda.stream(torch.cuda.default_stream(self.device))
               if self.device.type == "cuda" else contextlib.nullcontext())
        out = {}
        with ctx, torch.no_grad():
            for key, t in stacks.items():
                leaf, ab = key[:-len("_lora_a")], key[-1]
                t = t.clone()
                if leaf in mats:
                    src = mats[leaf][0 if ab == "a" else 1]
                    t[:, idx] = torch.from_numpy(src).to(self.device,
                                                          t.dtype)
                else:
                    t[:, idx] = 0
                out[key] = t
        return out

    def register_adapter(self, name: str, adapter_dir: str) -> int:
        """Load a PEFT adapter dir into a free LoRA slot (hot: the
        stacks keep their shapes). Re-registering a name overwrites its
        slot (adapter update): every target, those the new adapter
        lacks set to zero."""
        if self.lora_slots <= 0:
            raise ValueError("engine started without LoRA slots "
                             "(--lora-slots)")
        mats = load_adapter_matrices(adapter_dir, self.cfg,
                                     rank_pad=self.lora_rank)
        with self._lora_lock:
            idx = self._lora_names.get(name)
            if idx is None:
                used = set(self._lora_names.values())
                free = [i for i in range(1, self.lora_slots + 1)
                        if i not in used]
                if not free:
                    raise ValueError(
                        f"all {self.lora_slots} LoRA slots in use")
                idx = free[0]
            # reference swap: in-flight steps keep the old stacks
            self._lora = self._with_slot(self._lora, idx, mats)
            self._lora_names[name] = idx
        return idx

    def unregister_adapter(self, name: str) -> None:
        with self._lora_lock:
            idx = self._lora_names.get(name)
            if idx is None:
                return
            if (self._slot_adapters == idx).any():
                raise ValueError(
                    f"adapter {name!r} is decoding in-flight "
                    f"sequences; retry after they finish")
            self._lora_names.pop(name)
            self._lora = self._with_slot(self._lora, idx, {})

    def _batch_lora(self):
        """The adapter stacks a decode-batch op runs with, read once per
        op; None while no armed slot holds an adapter."""
        lora = self._lora
        return lora if lora and self._slot_adapters.any() else None

    # -- ops -----------------------------------------------------------

    def _sampling(self, temperature, top_k, top_p):
        dev = self.device
        return (_sampling_array(temperature, torch.float32, dev),
                _sampling_array(top_k, torch.int32, dev),
                _sampling_array(top_p, torch.float32, dev))

    @torch.no_grad()
    def prefill(self, prompt_ids: List[int], temperature: float = 0.0,
                top_k: int = 0, top_p: float = 1.0,
                adapter: Optional[str] = None,
                first_mask: Optional[np.ndarray] = None):
        """Returns (first_token: int, kv pair, true_len, bucket).

        With the prefix cache on, a prompt whose leading token blocks
        were cached by an earlier request runs only its suffix through
        the model: positions continue at the cached prefix length and
        attention reaches into a cache seeded with the cached KV.
        `first_mask` ([V] bool) constrains the first sampled token
        (structured outputs) and bypasses the prefix-cache suffix path,
        as in the reference (the prompt still seeds the cache)."""
        # leave room for one generated token; cap at the largest bucket
        max_prompt = min(self.max_seq - 1, self.prefill_buckets[-1])
        ids = list(prompt_ids)[-max_prompt:]
        sampling = self._sampling([temperature], [top_k], [top_p])
        cfg, dev = self.cfg, self.device

        def _pow2_keep(plen: int) -> int:
            # the reused prefix is cut to a power of two, as in the
            # reference (where it bounds the compiled variants), so the
            # two engines reuse the same prefix lengths
            return 1 << (max(plen, 1).bit_length() - 1)

        def _usable(plen: int) -> bool:
            k = _pow2_keep(plen)
            return (k >= self.prefix_cache.min_prefix
                    and k + _bucketize(len(ids) - k, self.prefill_buckets)
                    <= self.prefill_buckets[-1])

        aid = self.adapter_id(adapter)
        # adapter prefills bypass the prefix cache entirely: cached KV
        # was computed with (some) adapter's projections, so sharing
        # across adapters, or with the base, would be silently wrong
        hit = None if (first_mask is not None or aid != 0) \
            else self.prefix_cache.match(ids, usable=_usable)
        prefix = None
        if hit is not None:
            pk, pv, plen, _ = hit
            plen = _pow2_keep(plen)  # discard the ragged tail blocks
            suffix = ids[plen:]
            sbucket = _bucketize(len(suffix), self.prefill_buckets)
            bucket = _bucketize(plen + sbucket, self.prefill_buckets)
            keep = min(plen, bucket)
            prefix = (pk[:, :, :keep], pv[:, :, :keep], plen)
            padded = torch.tensor([suffix + [0] * (sbucket - len(suffix))],
                                  dtype=torch.int32, device=dev)
            last = torch.tensor([len(suffix) - 1], device=dev)
            name, desc = "prefill_suffix", f"total={bucket},keep={keep}"
            tokens = sbucket
        else:
            bucket = _bucketize(len(ids), self.prefill_buckets)
            padded = torch.tensor([ids + [0] * (bucket - len(ids))],
                                  dtype=torch.int32, device=dev)
            last = torch.tensor([len(ids) - 1], device=dev)
            name = "prefill" if first_mask is None else "prefill_masked"
            desc, tokens = f"bucket={bucket}", bucket
        lora = {}
        if aid:
            lora = dict(lora=self._lora, adapter_ids=torch.tensor(
                [aid], dtype=torch.int32, device=dev))
        allowed = None
        if first_mask is not None:
            allowed = _sampling_array(np.asarray(first_mask, bool)[None],
                                      torch.bool, dev)

        def run():
            cache = llama.KVCache.create(cfg, 1, bucket, device=dev)
            if prefix is not None:
                pk, pv, cache.index = prefix
                cache.k[:, :, :pk.shape[2]] = pk
                cache.v[:, :, :pv.shape[2]] = pv
            logits, new_cache = self.model(padded, cache=cache, rows=last,
                                           **lora)
            last_logits = logits[:, 0]
            if allowed is not None:
                last_logits = torch.where(allowed, last_logits, -torch.inf)
            return (self._sample(last_logits, *sampling), new_cache.k,
                    new_cache.v)
        tok, k, v = self._ledger_capture(
            name, desc, run, (padded, prefix, sampling, allowed, lora),
            tokens=tokens, kv_rows=bucket)
        if aid == 0:
            self.prefix_cache.put(ids, k, v, len(ids), bucket)
        return int(tok[0]), (k, v), len(ids), bucket

    @torch.no_grad()
    def insert(self, state: DecodeState, kv, slot: int, true_len: int,
               token: int, bucket: int,
               adapter: Optional[str] = None) -> DecodeState:
        """Copy a prefill's KV [L, 1, bucket, ...] into `slot` of the
        decode cache, in place, and arm the slot at `true_len`. Paged:
        allocate the slot's blocks first (KVPoolExhausted when the pool
        cannot cover the prompt and the next write); an int8 pool
        quantizes the rows on the way in. `kv` is a local prefill's
        device tensors or host planes (a fetched PD or peer blob: CPU
        tensors or float numpy arrays), which are copied to the device
        in the cache's dtype first."""
        if self.kv_block:
            with self._lora_lock:
                # fail fast BEFORE the allocator touches any blocks
                self.adapter_id(adapter)
        kv = self.device_kv(kv)
        if self.kv_block:
            self.free_slot(slot)  # BEFORE recording the adapter ref
            need = self.blocks_needed(true_len)
            if len(self._free_blocks) < need:
                # backpressure, not a fault: the scheduler requeues
                # this request until running streams free blocks
                raise KVPoolExhausted(
                    f"need {need} KV blocks, {len(self._free_blocks)} "
                    f"free (pool {self.kv_blocks} x {self.kv_block} "
                    f"tokens)")
            ids = [self._free_blocks.pop() for _ in range(need)]
            self._owned[slot] = ids
            self._table[slot, :need] = ids
            self._table_dirty = True
            self._host_len[slot] = true_len
        # re-resolve and record under the adapter lock: an unregister
        # between resolution and recording would zero the stacks this
        # sequence is about to decode with; if it slipped in, return
        # the freshly allocated blocks instead of orphaning them
        try:
            with self._lora_lock:
                aid = self.adapter_id(adapter)
                self._slot_adapters[slot] = aid
        except UnknownAdapterError:
            if self.kv_block:
                self.free_slot(slot)
            raise
        if self.kv_block:
            self._insert_paged(state, kv, ids, bucket)
        else:
            keep = min(bucket, self.max_seq)
            state.k[:, slot, :keep] = kv[0][:, 0, :keep]
            state.v[:, slot, :keep] = kv[1][:, 0, :keep]
        state.lengths[slot] = true_len
        state.tokens[slot] = token
        state.adapters[slot] = aid
        return state

    def device_kv(self, kv):
        """The (k, v) planes of a prefill on the engine's device in the
        cache dtype: tensors already there pass through untouched, host
        planes (CPU tensors, numpy arrays) are copied over."""
        out = []
        for x in kv:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            out.append(x.to(device=self.device, dtype=self.cfg.dtype))
        return tuple(out)

    def _insert_paged(self, state: DecodeState, kv, ids: List[int],
                      bucket: int) -> None:
        """Copy a prefilled [L, 1, bucket, K, D] KV slab into the pool
        blocks `ids` (block i takes rows [i*bs, (i+1)*bs)), in place.
        int8 pools quantize the slab per (layer, row, head) on the way
        in — prefill computes at the model dtype, so the quantization
        cost rides the insert, never the decode loop. Chunks past the
        slot's blocks hold only prompt padding; the reference writes
        them into the trash block, which no live slot reads, so they
        are skipped here."""
        bs = self.kv_block
        kv_k, kv_v = kv[0][:, 0], kv[1][:, 0]       # [L, bucket, K, D]
        if self.kv_quantized:
            kv_k, ks = quantize_rows(kv_k)           # ks [L, bucket, K]
            kv_v, vs = quantize_rows(kv_v)
            ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
        for i, blk in enumerate(ids[:-(-bucket // bs)]):
            lo, hi = i * bs, min((i + 1) * bs, bucket)
            state.k[:, blk, :hi - lo] = kv_k[:, lo:hi]
            state.v[:, blk, :hi - lo] = kv_v[:, lo:hi]
            if self.kv_quantized:
                state.k_scale[:, blk, :, :hi - lo] = ks[:, :, lo:hi]
                state.v_scale[:, blk, :, :hi - lo] = vs[:, :, lo:hi]

    def _device_table(self) -> torch.Tensor:
        """The block table on the device, uploaded again only after the
        host table changed. The upload copies a fresh snapshot (pinned,
        on a card), so a later host edit cannot race the asynchronous
        copy and the copy does not wait for the step in flight."""
        if self._table_dirty or self._table_dev is None:
            host = torch.from_numpy(self._table.copy())
            if self.device.type == "cuda":
                host = host.pin_memory()
            self._table_dev = host.to(self.device, non_blocking=True)
            self._table_dirty = False
        return self._table_dev

    # -- grammar mask table --------------------------------------------

    def _mask_table(self) -> torch.Tensor:
        """The device-resident [mask_table_rows, V] grammar mask table,
        created all-True on first touch. Row 0 stays all-True forever —
        the sentinel unmasked slots index."""
        if self._mask_table_dev is None:
            self._mask_table_dev = torch.ones(
                (self.mask_table_rows, self.cfg.vocab_size),
                dtype=torch.bool, device=self.device)
        return self._mask_table_dev

    def set_mask_row(self, row: int, bits: np.ndarray) -> None:
        """Upload one grammar-state mask as row `row` (>= 1; row 0 is
        the reserved all-True sentinel) of the device mask table. The
        write is queued on the device stream after every step already
        dispatched, so a plan in flight gathers the row it was planned
        with."""
        row = int(row)
        if not 1 <= row < self.mask_table_rows:
            raise ValueError(f"mask row {row} out of range "
                             f"[1, {self.mask_table_rows})")
        tab = self._mask_table()
        tab[row] = _sampling_array(np.asarray(bits, bool), torch.bool,
                                   self.device)

    def _masks(self, mask, mask_idx) -> Optional[torch.Tensor]:
        """The allowed-token mask a step samples under: rows of the
        device table gathered by `mask_idx` (int32 indices, any shape)
        when given, else the dense `mask` uploaded, else None."""
        if mask_idx is not None:
            idx = _sampling_array(mask_idx, torch.long, self.device)
            return self._mask_table()[idx.long()]
        if mask is not None:
            return _sampling_array(mask, torch.bool, self.device)
        return None

    # -- decode ops ----------------------------------------------------

    def _forward_step(self, state: DecodeState, tokens: torch.Tensor,
                      lora=None):
        """One forward of `tokens` [B, S] over the decode cache at the
        slots' lengths, writing their K/V rows in place; with `lora`
        (the op's `_batch_lora`) each slot adds its adapter's deltas
        (`state.adapters`). Returns (logits [B, S, V], new lengths
        [B])."""
        kw = {} if lora is None else dict(lora=lora,
                                          adapter_ids=state.adapters)
        if self.kv_block:
            cache = llama.PagedKVCache(
                k=state.k, v=state.v, index=state.lengths,
                table=self._device_table(), k_scale=state.k_scale,
                v_scale=state.v_scale)
            logits, nc = self.model.forward_paged(tokens, cache, **kw)
        else:
            cache = llama.KVCache(k=state.k, v=state.v,
                                  index=state.lengths)
            logits, nc = self.model(tokens, cache=cache, **kw)
        return logits, nc.index

    @torch.no_grad()
    def decode(self, state: DecodeState, temperature, top_k, top_p,
               mask: Optional[np.ndarray] = None,
               mask_idx: Optional[np.ndarray] = None,
               ) -> Tuple[DecodeState, TokenHandle]:
        """One decode step for ALL slots. Sampling params: [B] host
        arrays or device tensors (the scheduler's cache). Free slots
        decode too, on whatever their cache holds; their tokens are
        discarded by the caller. `mask` ([B, V] bool) constrains
        sampling (structured outputs); `mask_idx` ([B] int32, wins over
        `mask`) instead gathers each slot's row of the device mask
        table — B ints of transfer instead of B*V bools (0 = the
        all-True row).

        Returns the state (updated in place) and a TokenHandle whose
        host copy is already queued, so a pipelined caller can dispatch
        the next step before reading the tokens."""
        sampling = self._sampling(temperature, top_k, top_p)
        allowed = self._masks(mask, mask_idx)
        if self.kv_block:
            self._grow_blocks()
        lora = self._batch_lora()

        def run():
            logits, lengths = self._forward_step(
                state, state.tokens[:, None], lora)
            last = logits[:, -1]
            if allowed is not None:
                last = torch.where(allowed, last, -torch.inf)
            toks = self._sample(last, *sampling)
            state.lengths = lengths
            state.tokens = toks
            return toks
        toks = self._ledger_capture(
            self._program("decode", mask, mask_idx), "", run,
            (state, sampling, allowed, lora), tokens=self.max_slots,
            kv_rows=self._kv_capacity_rows())
        return state, TokenHandle(toks)

    @torch.no_grad()
    def decode_multi(self, state: DecodeState, temperature, top_k, top_p,
                     steps: int, budget, stop_ids,
                     lookahead_rows: Optional[int] = None,
                     mask: Optional[np.ndarray] = None,
                     mask_idx: Optional[np.ndarray] = None,
                     ) -> Tuple[DecodeState, TokenHandle, TokenHandle]:
        """`steps` decode iterations for ALL slots in one call, with one
        host sync per chunk instead of per token (the reference's
        `_multi_body` / `_multi_loop`).

        budget: [B] int32 per-slot remaining-token cap (0 freezes the
        slot for the chunk); stop_ids: [B, NS] int32 stop table, -1
        padding. Both may be host arrays or device tensors. A slot
        freezes — its token and length held, on the device — once it
        sampled a stop-table token, spent its budget or reached the
        cache capacity, and a slot whose input token is already a stop
        freezes for the whole chunk. The freeze rules are a subset of
        the host's finish rules: the device may run long (the host
        discards the overshoot at the drain), never short.
        lookahead_rows (paged only): rows to pre-allocate per slot,
        covering every plan still in flight plus this one (default
        `steps`). mask ([B, steps, V] bool) / mask_idx ([B, steps]
        int32 table rows, wins) constrain iteration i to mask[:, i].

        Returns (state, tokens [B, steps], advanced [B]) as TokenHandles
        with their host copies queued: slot b produced
        tokens[b, :advanced[b]]; paged callers reconcile each drained
        chunk with commit_spec(slot, advanced, reserve=...)."""
        sampling = self._sampling(temperature, top_k, top_p)
        dev = self.device
        budget = _sampling_array(budget, torch.int32, dev)
        stop_ids = _sampling_array(stop_ids, torch.int32, dev)
        allowed = self._masks(mask, mask_idx)
        n = int(steps)
        if self.kv_block:
            self._grow_blocks_spec(n if lookahead_rows is None
                                   else int(lookahead_rows))
        B = self.max_slots
        lora = self._batch_lora()  # one set of stacks for the chunk

        def run():
            done = (budget <= 0) | (state.tokens[:, None]
                                    == stop_ids).any(dim=1)
            acc = torch.zeros((B, n), dtype=torch.int32, device=dev)
            adv = torch.zeros((B,), dtype=torch.int32, device=dev)
            for i in range(n):
                active = (~done) & (budget > i) & (state.lengths
                                                   < self.max_seq)
                logits, lengths = self._forward_step(
                    state, state.tokens[:, None], lora)
                last = logits[:, -1]
                if allowed is not None:
                    last = torch.where(allowed[:, i], last, -torch.inf)
                toks = torch.where(active, self._sample(last, *sampling),
                                   state.tokens)
                done = done | (toks[:, None] == stop_ids).any(dim=1)
                acc[:, i] = toks
                adv += active.to(torch.int32)
                state.lengths = torch.where(active, lengths, state.lengths)
                state.tokens = toks
            return acc, adv
        cap = self._kv_capacity_rows()
        acc, adv = self._ledger_capture(
            self._program("decode_multi", mask, mask_idx), f"n={n}", run,
            (state, sampling, budget, stop_ids, allowed, lora),
            tokens=B * n, kv_rows=n * cap, weight_passes=n)
        return state, TokenHandle(acc), TokenHandle(adv)

    @torch.no_grad()
    def verify(self, state: DecodeState, drafts, draft_len, temperature,
               top_k, top_p, lookahead_rows: Optional[int] = None,
               mask: Optional[np.ndarray] = None,
               mask_idx: Optional[np.ndarray] = None,
               ) -> Tuple[DecodeState, TokenHandle, TokenHandle]:
        """One speculative verify step for ALL slots: score the k
        drafted tokens plus one bonus position in a single forward of
        [last token, d_0 .. d_{k-1}] per slot, and accept per slot the
        longest valid prefix (`sampling.spec_verify`). A slot with
        draft_len 0 is a plain decode step. The K/V of all k+1 rows are
        written at the slot's length; the rollback of rejected rows is
        just the length update (rows past lengths + accepted + 1 are
        never read and are overwritten later).

        drafts: [B, k] int32 (garbage past draft_len); draft_len: [B]
        in [0, k]. mask ([B, V] bool) constrains position 0 — how masked
        slots ride a verify plan at draft_len 0; mask_idx ([B, k+1]
        int32 table rows, wins) masks every position. Paged callers
        pass lookahead_rows (the rows of every plan in flight plus this
        one's k+1, default k+1) and commit each drained step with
        commit_spec(slot, accepted + 1, reserve=...).

        Returns (state, out_tokens [B, k+1], accepted [B]) as
        TokenHandles with their host copies queued: slot b emits
        out_tokens[b, :accepted[b]+1]."""
        sampling = self._sampling(temperature, top_k, top_p)
        dev = self.device
        drafts = _sampling_array(drafts, torch.int32, dev)
        draft_len = _sampling_array(draft_len, torch.int32, dev)
        k = int(drafts.shape[1])
        if self.kv_block:
            self._grow_blocks_spec(k + 1 if lookahead_rows is None
                                   else int(lookahead_rows))
        allowed = self._masks(mask, mask_idx)
        lora = self._batch_lora()

        def run():
            toks = torch.cat([state.tokens[:, None], drafts], dim=1)
            logits, _ = self._forward_step(state, toks, lora)
            if mask_idx is not None:
                logits = torch.where(allowed, logits, -torch.inf)
            elif mask is not None:
                logits[:, 0] = torch.where(allowed, logits[:, 0],
                                           -torch.inf)
            out, accepted = self._spec_verify(logits, drafts, draft_len,
                                              *sampling)
            state.lengths = state.lengths + accepted + 1
            state.tokens = torch.gather(out, 1,
                                        accepted.long()[:, None])[:, 0]
            return out, accepted
        rows = self.max_slots * (k + 1)
        out, accepted = self._ledger_capture(
            self._program("verify", mask, mask_idx), f"k={k}", run,
            (state, drafts, draft_len, sampling, allowed, lora),
            tokens=rows, kv_rows=self._kv_capacity_rows() + rows)
        return state, TokenHandle(out), TokenHandle(accepted)
