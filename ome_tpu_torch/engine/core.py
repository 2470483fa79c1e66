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
  * sampling params as [B] tensors.

The reference jits three programs that donate their state buffers so
XLA updates the cache in place. PyTorch runs eagerly; here the cache
tensors are updated in place directly (`insert` copies a prefill's KV
into its slot, `decode` writes each new row), which keeps the same
single copy of the cache on the device.

Paged KV, int8 KV, multi-LoRA adapters, grammar masks, multi-step
decode and speculative verify are not in this slice: the serve flags
that would ask for them refuse (engine/serve.py).
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
from .sampling import sample


@dataclasses.dataclass
class DecodeState:
    """Device-resident state of the decode batch."""

    k: torch.Tensor        # [L, B, Smax, K, Dh]
    v: torch.Tensor        # [L, B, Smax, K, Dh]
    lengths: torch.Tensor  # [B] int32 — valid kv rows / next write index
    tokens: torch.Tensor   # [B] int32 — last sampled token per slot
    adapters: torch.Tensor  # [B] int32 — LoRA adapter slot (0 = base)


class UnknownAdapterError(ValueError):
    """Request names a LoRA adapter the engine doesn't have loaded — a
    PER-REQUEST error, never a scheduler fault."""


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
    device."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 max_slots: int = 8, max_seq: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 prefix_cache_bytes: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = llama.Llama(cfg, params).to(self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq or cfg.max_seq_len
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

    @torch.no_grad()
    def new_state(self) -> DecodeState:
        cfg = self.cfg
        base = (cfg.num_layers, self.max_slots, self.max_seq,
                cfg.kv_cache_heads)

        def ints():
            return torch.zeros((self.max_slots,), dtype=torch.int32,
                               device=self.device)
        return DecodeState(
            k=torch.zeros(base + (cfg.kv_cache_k_dim,), dtype=cfg.dtype,
                          device=self.device),
            v=torch.zeros(base + (cfg.kv_cache_v_dim,), dtype=cfg.dtype,
                          device=self.device),
            lengths=ints(), tokens=ints(), adapters=ints())

    def free_slot(self, slot: int) -> None:
        """Release a finished slot's adapter reference (the dense cache
        has no blocks to return)."""
        self._slot_adapters[slot] = 0

    def take_preempted(self) -> List[int]:
        """Slots evicted by KV pool pressure since the last call: none,
        as the dense cache never preempts."""
        return []

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
        decode cache, in place, and arm the slot at `true_len`."""
        aid = self.adapter_id(adapter)
        self._slot_adapters[slot] = aid
        keep = min(bucket, self.max_seq)
        state.k[:, slot, :keep] = kv[0][:, 0, :keep]
        state.v[:, slot, :keep] = kv[1][:, 0, :keep]
        state.lengths[slot] = true_len
        state.tokens[slot] = token
        state.adapters[slot] = aid
        return state

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
        cache = llama.KVCache(k=state.k, v=state.v, index=state.lengths)
        logits, new_cache = self.model(state.tokens[:, None], cache=cache)
        toks = self._sample(logits[:, -1], *sampling)
        state.lengths = new_cache.index
        state.tokens = toks
        return state, TokenHandle(toks)
