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

Multi-LoRA adapters, grammar masks, multi-step decode, speculative
verify (and with it `_grow_blocks_spec` / `commit_spec`) and the
prefix cache's host tier are not ported yet: the serve flags that would
ask for them refuse (engine/serve.py).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.params import Params
from ..ops.flash import check_paged_coverage, quantize_rows
from .sampling import sample


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
    """Per-step sampling params: convert host inputs to a tensor on the
    engine's device, but pass tensors through untouched — the
    scheduler caches them on the device so a decode step uploads
    nothing."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


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

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class PrefixCache:
    """Radix (token-block trie) cache of prompt-prefix KV with a device
    byte budget — the device tier of the reference's PrefixCache (the
    host-memory spill tier is not ported yet).

    Prompts are split into fixed token BLOCKS; each trie node owns one
    block's KV ([L, 1, block, K, Dh] tensors, copied out of the prefill
    so a node holds only its own bytes). Sibling prompts share every
    common leading block. Eviction is byte-accounted LRU over leaf
    nodes: device bytes never exceed `capacity_bytes`. A hit returns
    the concatenated leading blocks."""

    def __init__(self, capacity_bytes: int = 0, block: int = 32,
                 min_prefix: int = 16):
        self.capacity_bytes = capacity_bytes
        self.block = block
        self.min_prefix = min_prefix
        self._root: Dict[tuple, dict] = {}
        self._tick = 0
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.Lock()

    @staticmethod
    def _leaf_bytes(k, v) -> int:
        return k.numel() * k.element_size() + v.numel() * v.element_size()

    def put(self, ids, k, v, true_len: int, bucket: int):
        """Store the KV of `ids[:true_len]` block by block. k/v:
        [L, 1, S >= true_len, K, D] (rows past true_len are padding and
        never stored)."""
        if self.capacity_bytes <= 0 or true_len < self.min_prefix:
            return
        with self._lock:
            node_map = self._root
            self._tick += 1
            for off in range(0, (true_len // self.block) * self.block,
                             self.block):
                key = tuple(ids[off:off + self.block])
                node = node_map.get(key)
                if node is None:
                    ks = k[:, :, off:off + self.block].clone()
                    vs = v[:, :, off:off + self.block].clone()
                    node = {"kv": (ks, vs), "children": {},
                            "last": self._tick}
                    node_map[key] = node
                    self.bytes += self._leaf_bytes(ks, vs)
                node["last"] = self._tick
                node_map = node["children"]
            self._evict_locked()

    def _evict_locked(self) -> None:
        """Drop least-recently-used LEAF nodes until within budget
        (parents stay useful for the prompts that still share them)."""
        while self.bytes > self.capacity_bytes:
            leaves = []
            stack = [self._root]
            while stack:
                node_map = stack.pop()
                for key, node in node_map.items():
                    if node["children"]:
                        stack.append(node["children"])
                    else:
                        leaves.append((node["last"], node_map, key, node))
            if not leaves:
                return
            leaves.sort(key=lambda t: t[0])
            for _, parent_map, key, node in leaves:
                if self.bytes <= self.capacity_bytes:
                    return
                self.bytes -= self._leaf_bytes(*node["kv"])
                self.evictions += 1
                del parent_map[key]

    def match(self, ids, usable=None) -> Optional[tuple]:
        """Longest cached STRICT prefix of `ids` in whole blocks (the
        last prompt token must re-run so its logits exist for
        sampling). Returns (k, v, eff, eff) with k/v concatenated over
        the matched blocks. `usable(eff) -> bool` vetoes prefix lengths
        the caller's budget cannot use before the hit is counted."""
        if self.capacity_bytes <= 0:
            return None
        with self._lock:
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


class InferenceEngine:
    """Prefill / insert / decode over one dense Llama model on one
    device, with a dense or a paged KV cache."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 max_slots: int = 8, max_seq: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 prefix_cache_bytes: int = 0,
                 kv_block: int = 0, kv_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
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
            if (cfg.mla or cfg.is_moe or cfg.first_k_dense
                    or cfg.sliding_window or cfg.alt_sliding_window
                    or cfg.norm_type != "rmsnorm" or cfg.parallel_block
                    or cfg.attn_sinks):
                raise PagedKVUnsupported(
                    "paged KV supports standard rmsnorm GQA models; "
                    "MLA/MoE/sliding-window/parallel-block/layernorm/"
                    "sink models use the dense cache")
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
        self.prefix_cache = PrefixCache(prefix_cache_bytes)
        # adapter id each decode slot decodes with (always 0, the base
        # model: multi-LoRA is not in this slice)
        self._slot_adapters = np.zeros(max_slots, np.int32)
        # one generator for the admission thread's prefills and the
        # scheduler thread's decodes; the lock keeps each draw's
        # offset bump atomic (the reference's _next_key counter lock)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._rng_lock = threading.Lock()

    def _sample(self, logits, temperature, top_k, top_p) -> torch.Tensor:
        with self._rng_lock:
            return sample(logits, self._gen, temperature, top_k, top_p)

    # -- state ---------------------------------------------------------

    def kv_row_bytes(self) -> int:
        """Device bytes one cached KV row (all layers, all heads)
        costs. int8 pools store 1 byte/element plus two f32 scales per
        (layer, head) row."""
        cfg = self.cfg
        if self.kv_quantized:
            return cfg.num_layers * cfg.kv_cache_heads * (
                cfg.kv_cache_k_dim + cfg.kv_cache_v_dim + 2 * 4)
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return (cfg.num_layers * cfg.kv_cache_heads
                * (cfg.kv_cache_k_dim + cfg.kv_cache_v_dim) * itemsize)

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
        concurrent insert can make a mid-step scrape read False."""
        if not self.kv_block:
            return True, 0
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
        return ok, len(owned_all)

    def blocks_needed(self, n_tokens: int) -> int:
        """Pool blocks covering `n_tokens` KV rows + the next write —
        the single accounting used by insert() AND the scheduler's
        pre-prefill pool check (they must not drift)."""
        return min(-(-(n_tokens + 1) // self.kv_block),
                   self.max_blocks)

    # -- adapters (base model only) --------------------------------------

    @property
    def adapter_names(self) -> List[str]:
        return []

    def adapter_id(self, name: Optional[str]) -> int:
        """Resolve an adapter name to its slot id (0/None = base)."""
        if not name:
            return 0
        raise UnknownAdapterError(
            f"unknown adapter {name!r} (loaded: none; multi-LoRA is not "
            "ported yet)")

    # -- ops -----------------------------------------------------------

    def _sampling(self, temperature, top_k, top_p):
        dev = self.device
        return (_sampling_array(temperature, torch.float32, dev),
                _sampling_array(top_k, torch.int32, dev),
                _sampling_array(top_p, torch.float32, dev))

    @torch.no_grad()
    def prefill(self, prompt_ids: List[int], temperature: float = 0.0,
                top_k: int = 0, top_p: float = 1.0,
                adapter: Optional[str] = None):
        """Returns (first_token: int, kv pair, true_len, bucket).

        With the prefix cache on, a prompt whose leading token blocks
        were cached by an earlier request runs only its suffix through
        the model: positions continue at the cached prefix length and
        attention reaches into a cache seeded with the cached KV."""
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
        hit = None if aid != 0 else self.prefix_cache.match(
            ids, usable=_usable)
        if hit is not None:
            pk, pv, plen, _ = hit
            plen = _pow2_keep(plen)  # discard the ragged tail blocks
            suffix = ids[plen:]
            sbucket = _bucketize(len(suffix), self.prefill_buckets)
            bucket = _bucketize(plen + sbucket, self.prefill_buckets)
            keep = min(plen, bucket)
            cache = llama.KVCache.create(cfg, 1, bucket, device=dev)
            cache.k[:, :, :keep] = pk[:, :, :keep]
            cache.v[:, :, :keep] = pv[:, :, :keep]
            cache.index = plen
            padded = torch.tensor([suffix + [0] * (sbucket - len(suffix))],
                                  dtype=torch.int32, device=dev)
            last = torch.tensor([len(suffix) - 1], device=dev)
        else:
            bucket = _bucketize(len(ids), self.prefill_buckets)
            cache = llama.KVCache.create(cfg, 1, bucket, device=dev)
            padded = torch.tensor([ids + [0] * (bucket - len(ids))],
                                  dtype=torch.int32, device=dev)
            last = torch.tensor([len(ids) - 1], device=dev)
        logits, new_cache = self.model(padded, cache=cache, rows=last)
        tok = self._sample(logits[:, 0], *sampling)
        k, v = new_cache.k, new_cache.v
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
        cannot cover the prompt and the next write)."""
        aid = self.adapter_id(adapter)
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
            self._insert_paged(state, kv, ids, bucket)
        else:
            keep = min(bucket, self.max_seq)
            state.k[:, slot, :keep] = kv[0][:, 0, :keep]
            state.v[:, slot, :keep] = kv[1][:, 0, :keep]
        self._slot_adapters[slot] = aid
        state.lengths[slot] = true_len
        state.tokens[slot] = token
        state.adapters[slot] = aid
        return state

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

    @torch.no_grad()
    def decode(self, state: DecodeState, temperature, top_k, top_p
               ) -> Tuple[DecodeState, TokenHandle]:
        """One decode step for ALL slots. Sampling params: [B] host
        arrays or device tensors (the scheduler's cache). Free slots
        decode too, on whatever their cache holds; their tokens are
        discarded by the caller.

        Returns the state (updated in place) and a TokenHandle whose
        host copy is already queued, so a pipelined caller can dispatch
        the next step before reading the tokens."""
        sampling = self._sampling(temperature, top_k, top_p)
        if self.kv_block:
            self._grow_blocks()
            cache = llama.PagedKVCache(
                k=state.k, v=state.v, index=state.lengths,
                table=self._device_table(), k_scale=state.k_scale,
                v_scale=state.v_scale)
            logits, new_cache = self.model.forward_paged(
                state.tokens[:, None], cache)
        else:
            cache = llama.KVCache(k=state.k, v=state.v,
                                  index=state.lengths)
            logits, new_cache = self.model(state.tokens[:, None],
                                           cache=cache)
        toks = self._sample(logits[:, -1], *sampling)
        state.lengths = new_cache.index
        state.tokens = toks
        return state, TokenHandle(toks)
