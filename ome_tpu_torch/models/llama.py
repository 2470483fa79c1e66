"""Llama-family decoder in PyTorch (port of ome_tpu/models/llama.py).

The GQA RMSNorm subset of the reference: RMSNorm in fp32, rotate-half
RoPE with default/linear/llama3 frequency scaling, the SiLU gated MLP,
GQA attention through `ops.attention`, and fp32 logits; with the Qwen2
q/k/v (and o) projection biases, the Qwen3 per-head q/k RMSNorm and the
Mixtral top-k MoE MLP (`moe_mlp`: the reference's dense impl and its
ragged dispatch, grouped products through `torch._grouped_mm` on the
card).

Layout follows the reference so the tests compare like with like:
parameters are a nested dict with the reference's leaf names and the
layer tensors stacked on a leading [L, ...] axis; activations are
[B, S, ...]; the dense KV cache is [L, B, S_max, K, Dh] and the paged
one a block pool [L, N, block, K, Dh] with a block table (`forward_paged`,
the engine's `--kv-block` decode). Ops are plain
functions on tensors. `lax.scan` over the stacked layers becomes a
Python loop over layer indices. `Llama` is the nn.Module that holds one
model's stacked tensors and its RoPE table on a device.

The reference's jitted programs donate the cache buffers so XLA updates
them in place; here the forward writes the new K/V rows into the cache
tensors in place (`_write_rows`, `_append`), which is the same memory
behaviour without the donation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.flash import quantize_rows
from ..ops.int4_matmul import int4_eligible, int4_matmul
from ..ops.paged import paged_attention, paged_attention_multi
from .config import ModelConfig
from .params import Params, check_supported
from .quant import QTensor

IndexLike = Union[int, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity per-layer KV cache (counterpart of llama.KVCache).

    k, v: [L, B, S_max, K, Dh]; index: next write position — a Python
    int shared by the whole batch (chunked prefill) or a [B] int tensor
    of per-slot write positions (the serving engine's decode, where
    every slot is at a different length)."""

    k: torch.Tensor
    v: torch.Tensor
    index: IndexLike

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int,
               max_seq: Optional[int] = None, dtype=None, *,
               device: Union[str, torch.device]) -> "KVCache":
        S = max_seq or cfg.max_seq_len
        dtype = dtype or cfg.dtype
        shape = (cfg.num_layers, batch, S, cfg.kv_cache_heads)
        return cls(k=torch.zeros(shape + (cfg.kv_cache_k_dim,),
                                 dtype=dtype, device=device),
                   v=torch.zeros(shape + (cfg.kv_cache_v_dim,),
                                 dtype=dtype, device=device),
                   index=0)


@dataclasses.dataclass
class PagedKVCache:
    """Block-pool KV cache for the engine's paged decode (counterpart of
    llama.PagedKVCache).

    k, v: [L, N, block, K, Dh] POOLS of N fixed-size blocks shared by
    every decode slot; `table`: [B, M] int32 block table mapping each
    slot's sequence block j to a pool block id (0 is the reserved trash
    block: unallocated entries point there and kv_len masking keeps it
    out of every live slot's window); `index`: [B] per-slot lengths.
    int8 pools carry per-(row, head) f32 scales `k_scale`, `v_scale`
    [L, N, K, block] (S-minor); None for bf16/fp32 pools."""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    table: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, n_blocks: int,
               block: int, max_blocks: int, dtype=None, *,
               device: Union[str, torch.device]) -> "PagedKVCache":
        dtype = dtype or cfg.dtype
        K, Dk, Dv = (cfg.kv_cache_heads, cfg.kv_cache_k_dim,
                     cfg.kv_cache_v_dim)
        L = cfg.num_layers

        def scale():
            # one buffer per plane: the two are written independently
            return (torch.zeros((L, n_blocks, K, block),
                                dtype=torch.float32, device=device)
                    if dtype == torch.int8 else None)
        return cls(k=torch.zeros((L, n_blocks, block, K, Dk), dtype=dtype,
                                 device=device),
                   v=torch.zeros((L, n_blocks, block, K, Dv), dtype=dtype,
                                 device=device),
                   index=torch.zeros((batch,), dtype=torch.int32,
                                     device=device),
                   table=torch.zeros((batch, max_blocks), dtype=torch.int32,
                                     device=device),
                   k_scale=scale(), v_scale=scale())


# -- building blocks -------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(cfg: ModelConfig,
                     device: Union[str, torch.device]) -> torch.Tensor:
    """[head_dim / 2] fp32 inverse frequencies (reference
    `_rope_frequencies`), with linear and llama3 (Llama-3.1 NTK-by-parts)
    scaling."""
    half = cfg.head_dim // 2
    freqs = 1.0 / cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=device) / half)
    sc = cfg.rope_scaling
    rtype = sc.get("rope_type", sc.get("type")) if sc else None
    if rtype not in (None, "default", "llama3", "linear"):
        raise NotImplementedError(
            f"rope_scaling type {rtype!r} is not ported yet")
    if rtype == "linear":
        freqs = freqs / sc.get("factor", 1.0)
    if rtype == "llama3":
        factor = sc.get("factor", 8.0)
        lo = sc.get("low_freq_factor", 1.0)
        hi = sc.get("high_freq_factor", 4.0)
        orig = sc.get("original_max_position_embeddings", 8192)
        wavelen = 2 * math.pi / freqs
        ramp = ((orig / wavelen - lo) / (hi - lo)).clamp(0.0, 1.0)
        smoothed = freqs * (ramp + (1 - ramp) / factor)
        freqs = torch.where(wavelen < orig / hi, freqs,
                            torch.where(wavelen > orig / lo,
                                        freqs / factor, smoothed))
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE (HF Llama convention). x: [B, S, N, Dh];
    positions: [B, S]."""
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _proj(x: torch.Tensor, w, dtype, out_dims=None,
          flatten: int = 1) -> torch.Tensor:
    """Contract x's trailing `flatten` dims with weight `w` (reference
    `_proj`). A plain tensor multiplies in the weights' dtype (bf16
    weights: bf16 product, fp32 accumulation). A QTensor that
    `int4_eligible` takes (int4, at most 256 flattened rows) goes
    through the int4 kernel (B4) in the compute dtype `dtype`; every
    other QTensor (int8, fp8, wo's flatten=2 layout, a prefill of more
    than 256 rows) is dequantized to `dtype` and multiplied — the
    reference's own dispatch (ome_tpu/models/llama.py:59-65)."""
    lead = x.shape[:x.dim() - flatten]
    K = math.prod(x.shape[len(lead):])
    x2 = x.reshape(*lead, K)
    if not isinstance(w, QTensor):
        y = x2 @ w.reshape(K, -1)
    elif w.bits == 4 and int4_eligible(tuple(x2.shape), w):
        y = int4_matmul(x2, w, dtype)
    else:
        y = x2 @ w.dequant(dtype).reshape(K, -1)
    if out_dims:
        y = y.reshape(*y.shape[:-1], *out_dims)
    return y


def dense_mlp(x: torch.Tensor, p, dtype) -> torch.Tensor:
    gate = _proj(x, p["w_gate"], dtype)
    up = _proj(x, p["w_up"], dtype)
    return _proj(F.silu(gate) * up, p["w_down"], dtype)


# -- mixture of experts (Mixtral) ------------------------------------------


def _w(w, dtype) -> torch.Tensor:
    """An expert-stacked weight in the compute dtype: a QTensor is
    dequantized whole at use (reference `_w`)."""
    return w.dequant(dtype) if isinstance(w, QTensor) else w


def _route(x: torch.Tensor, p, cfg: ModelConfig):
    """Mixtral router (reference `_route`, router_scoring "mixtral"):
    the router product in x's dtype, widened to fp32 logits; the top k
    by a stable descending sort, so that tied logits are taken lower
    expert id first, as `lax.top_k` takes them; then a softmax over the
    k picked logits. Returns (weights [B, S, k] fp32, ids [B, S, k])."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def _moe_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def moe_mlp_dense(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE computing every expert for every token and mixing by
    router weight (reference `moe_mlp_dense`): O(E) products, static
    shapes; the fp32 cross-check of the ragged dispatch."""
    weights, idx = _route(x, p, cfg)
    gate = torch.einsum("bsd,edf->bsef", x, _w(p["we_gate"], cfg.dtype))
    up = torch.einsum("bsd,edf->bsef", x, _w(p["we_up"], cfg.dtype))
    expert_out = torch.einsum("bsef,efd->bsed", _moe_act(gate, up),
                              _w(p["we_down"], cfg.dtype))
    onehot = F.one_hot(idx, cfg.num_experts).to(weights.dtype)
    mix = torch.einsum("bske,bsk->bse", onehot, weights)
    return torch.einsum("bsed,bse->bsd", expert_out,
                        mix.to(expert_out.dtype))


def grouped_ref(xs: torch.Tensor, w: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped product: each expert's product for
    every row, in expert order, keeping that expert's rows (`ids` [R]
    the rows' experts). No host read."""
    out = xs.new_zeros(xs.shape[0], w.shape[-1])
    for e in range(w.shape[0]):
        out = torch.where((ids == e)[:, None], xs @ w[e], out)
    return out


def _grouped(xs: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
             offs: torch.Tensor) -> torch.Tensor:
    """Rows xs [R, K] sorted by expert (expert ids `ids` [R], group ends
    `offs` [E] int32) times their expert's w[e] [K, N]: the reference's
    `lax.ragged_dot`, which is XLA there, not Pallas. bf16 on the card
    runs `torch._grouped_mm` with the offsets on the device; elsewhere
    (the CPU, fp32) `grouped_ref`. Neither reads anything back to the
    host."""
    if xs.is_cuda and xs.dtype == torch.bfloat16:
        return torch._grouped_mm(xs, w, offs=offs)
    return grouped_ref(xs, w, ids)


def moe_mlp_ragged(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Dropless ragged dispatch (reference `moe_mlp_ragged`): sort the
    T k (token, expert) pairs by expert with a stable sort (as
    `jnp.argsort`), run the grouped products, weight each row, put the
    rows back in (token, pick) order and add each token's k rows in pick
    order in the rows' dtype, then cast to x's dtype. Static shapes and
    no host read, so a `decode_multi` chunk stays free of syncs."""
    B, S, D = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    T = B * S
    weights, idx = _route(x, p, cfg)
    expert_ids = idx.reshape(T * k)
    order = torch.argsort(expert_ids, stable=True)
    sorted_ids = expert_ids[order]
    xs = x.reshape(T, D)[order // k]
    offs = (expert_ids[:, None] == torch.arange(E, device=x.device)
            ).sum(0).cumsum(0).to(torch.int32)
    gate = _grouped(xs, _w(p["we_gate"], cfg.dtype), sorted_ids, offs)
    up = _grouped(xs, _w(p["we_up"], cfg.dtype), sorted_ids, offs)
    out_sorted = _grouped(_moe_act(gate, up), _w(p["we_down"], cfg.dtype),
                          sorted_ids, offs)
    w_sorted = weights.reshape(T * k)[order]
    contrib = out_sorted * w_sorted[:, None].to(out_sorted.dtype)
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)
    rows = rows.reshape(T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out.reshape(B, S, D).to(x.dtype)


def moe_mlp(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE block (reference `moe_mlp`; shared experts are not
    ported and `params.check_supported` refuses them)."""
    if cfg.moe_impl == "ragged":
        return moe_mlp_ragged(x, p, cfg)
    return moe_mlp_dense(x, p, cfg)


# -- forward ---------------------------------------------------------------


def _embed(emb, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding lookup in the compute dtype; a quantized table
    dequantizes only the rows it gathers (`QTensor.take`)."""
    if isinstance(emb, QTensor):
        return emb.take(tokens, dtype)
    return emb[tokens.long()].to(dtype)


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                index: IndexLike) -> None:
    """Write new rows [B, U, K, D] into cache [B, S_max, K, D] in place
    at `index` (int, or [B] per-slot). Like the reference's
    dynamic_update_slice, a start past S_max - U is clamped so the write
    stays inside the cache."""
    S, U = cache.shape[1], new.shape[1]
    new = new.to(cache.dtype)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        start = index.to(torch.long).clamp(min=0, max=S - U)
        rows = start[:, None] + torch.arange(U, device=cache.device)
        batch = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[batch, rows] = new
    else:
        start = min(max(int(index), 0), S - U)
        cache[:, start:start + U] = new


def _qkv(h: torch.Tensor, lp, cfg: ModelConfig, freqs: torch.Tensor,
         positions: torch.Tensor):
    """Projected, biased (Qwen2), per-head RMS-normed (Qwen3) and roped
    q/k/v, in the reference's order; shared by the dense and paged
    paths."""
    q = _proj(h, lp["wq"], cfg.dtype,
              out_dims=(cfg.num_heads, cfg.head_dim))
    k = _proj(h, lp["wk"], cfg.dtype,
              out_dims=(cfg.num_kv_heads, cfg.head_dim))
    v = _proj(h, lp["wv"], cfg.dtype,
              out_dims=(cfg.num_kv_heads, cfg.head_dim))
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return (apply_rope(q, positions, freqs),
            apply_rope(k, positions, freqs), v)


def _out_proj(attn: torch.Tensor, lp, cfg: ModelConfig) -> torch.Tensor:
    """o_proj, plus its bias where the checkpoint carries one."""
    a = _proj(attn, lp["wo"], cfg.dtype, flatten=2)
    if "bo" in lp:
        a = a + lp["bo"]
    return a


def _mha(h: torch.Tensor, lp, cfg: ModelConfig, freqs: torch.Tensor,
         positions: torch.Tensor, kv_len: Optional[torch.Tensor],
         cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
         cache_index: Optional[IndexLike]) -> torch.Tensor:
    """GQA attention on the pre-normed input; with a cache the new K/V
    rows are written into it in place and attention spans the cache."""
    q, k, v = _qkv(h, lp, cfg, freqs, positions)
    if cache_kv is not None:
        ck, cv = cache_kv
        _write_rows(ck, k, cache_index)
        _write_rows(cv, v, cache_index)
        k, v = ck, cv
    attn = attention(q, k, v, positions=positions, kv_len=kv_len,
                     sliding_window=cfg.sliding_window,
                     scale=cfg.query_scale,
                     logit_softcap=cfg.attn_logit_softcap)
    return _out_proj(attn, lp, cfg)


def _layer(x: torch.Tensor, lp, cfg: ModelConfig, freqs, positions,
           kv_len, cache_kv, cache_index) -> torch.Tensor:
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    x = x + _mha(h, lp, cfg, freqs, positions, kv_len, cache_kv,
                 cache_index)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    mlp_out = moe_mlp(h, lp, cfg) if cfg.is_moe \
        else dense_mlp(h, lp, cfg.dtype)
    return x + mlp_out


def _final_logits(params: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head with fp32 logits (the reference's einsum
    with preferred_element_type=float32): on a card the bf16 product
    writes fp32 directly; elsewhere the product runs in fp32."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    tied = "lm_head" not in params
    head = params["embed" if tied else "lm_head"]
    if isinstance(head, QTensor):  # int8 (or fp8) head: dequantized
        head = head.dequant(cfg.dtype)
    if tied:
        head = head.t()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype != torch.float32:
        logits = torch.mm(x2, head, out_dtype=torch.float32)
    else:
        logits = x2.float() @ head.float()
    return logits.reshape(*lead, -1)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            rows: Optional[torch.Tensor] = None,
            freqs: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder.

    tokens: [B, S] int. positions: [B, S] (defaults to arange, offset by
    cache.index). With `cache`, K/V are written into it in place at
    cache.index and attention spans the cache; without, plain causal
    prefill. `rows` ([B] int) computes the logits of one position per
    sequence only (a prefill needs just its last real token's).
    Returns (logits [B, S or 1, vocab] fp32, cache with index + S, or
    None)."""
    B, S = tokens.shape
    dev = tokens.device
    index = cache.index if cache is not None else None
    if positions is None:
        base = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        if cache is not None:
            base = base + (index[:, None] if isinstance(index, torch.Tensor)
                           and index.dim() == 1 else index)
        positions = base.expand(B, S)
    if freqs is None:
        freqs = rope_frequencies(cfg, dev)
    x = _embed(params["embed"], tokens, cfg.dtype)
    kv_len = None
    if cache is not None:
        if isinstance(index, torch.Tensor):
            kv_len = torch.broadcast_to(index + S, (B,))
        else:
            kv_len = torch.full((B,), index + S, dtype=torch.int32,
                                device=dev)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: t[i] for name, t in layers.items()}
        cache_kv = (cache.k[i], cache.v[i]) if cache is not None else None
        x = _layer(x, lp, cfg, freqs, positions, kv_len, cache_kv, index)
    if rows is not None:
        x = x[torch.arange(B, device=dev), rows.to(dev).long()][:, None]
    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v, index=index + S)
    return _final_logits(params, cfg, x), new_cache


def _append(pool: torch.Tensor, scale_pool: Optional[torch.Tensor],
            rows: torch.Tensor, blk: torch.Tensor, off: torch.Tensor
            ) -> None:
    """Write fresh rows [B, S, K, D] into `pool` [N, bs, K, D] at
    (blk[b, s], off[b, s]), in place: one advanced-index assignment per
    pool, which replaces the reference's scatter into a donated buffer.
    A slot's S rows land on consecutive sequence positions, distinct
    (block, offset) pairs. int8 pools quantize per (row, head) on the
    way in (`flash.quantize_rows`, the reference's amax/127 rule) and
    store the f32 scale at the same (block, offset) of `scale_pool`
    [N, K, bs]. Free slots all write into the trash block; which
    duplicate lands is unordered, and harmless because no live slot's
    window reads it."""
    if scale_pool is not None:
        rows, sc = quantize_rows(rows)
        scale_pool[blk, :, off] = sc
    pool[blk, off] = rows.to(pool.dtype)


def forward_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: PagedKVCache,
                  freqs: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Short-sequence decode over a paged (block-pool) KV cache.

    tokens: [B, S] with small S — 1 for plain decode, k+1 for a
    speculative verify step. Slot b writes its S new K/V rows into pool
    blocks `table[b, (index[b]+s) // block]` at offsets
    `(index[b]+s) % block` (the engine allocates the covering blocks
    beforehand), then attends its block chain: S == 1 through
    `ops.paged.paged_attention` (the paged CUDA kernel on a card), S > 1
    through the plain `paged_attention_multi` with per-query causal
    masking, as in the reference; both under the model's sliding window,
    if it has one. Dense-MLP GQA models only (the engine refuses paged
    KV for MoE, as the reference's does). Returns
    (logits [B, S, vocab] fp32, cache with index + S); the pools are
    updated in place."""
    B, S = tokens.shape
    dev = tokens.device
    bs = cache.k.shape[2]
    M = cache.table.shape[1]
    if freqs is None:
        freqs = rope_frequencies(cfg, dev)
    positions = (cache.index[:, None]
                 + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
                 ).to(torch.int32)                          # [B, S]
    kv_len = cache.index + 1
    rows = torch.arange(B, device=dev)[:, None]
    pos = positions.long()
    # the clamp keeps a free slot whose length outgrew its table row
    # inside the pool: its row points at the trash block by then
    blk = cache.table[rows, (pos // bs).clamp(max=M - 1)].long()
    off = pos % bs
    quantized = cache.k_scale is not None
    x = _embed(params["embed"], tokens, cfg.dtype)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {name: t[i] for name, t in layers.items()}
        h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, freqs, positions)
        ksp = cache.k_scale[i] if quantized else None
        vsp = cache.v_scale[i] if quantized else None
        _append(cache.k[i], ksp, k, blk, off)
        _append(cache.v[i], vsp, v, blk, off)
        if S == 1:
            attn = paged_attention(q, cache.k[i], cache.v[i], cache.table,
                                   kv_len, scale=cfg.query_scale,
                                   logit_softcap=cfg.attn_logit_softcap,
                                   k_scale=ksp, v_scale=vsp,
                                   sliding_window=cfg.sliding_window)
        else:
            attn = paged_attention_multi(
                q, cache.k[i], cache.v[i], cache.table, positions,
                scale=cfg.query_scale,
                logit_softcap=cfg.attn_logit_softcap,
                k_scale=ksp, v_scale=vsp,
                sliding_window=cfg.sliding_window)
        x = x + _out_proj(attn, lp, cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + dense_mlp(h, lp, cfg.dtype)
    new_cache = dataclasses.replace(cache, index=cache.index + S)
    return _final_logits(params, cfg, x), new_cache


def _put(module: nn.Module, name: str, t) -> None:
    """Register leaf `t` as buffer(s) of `module`: a QTensor as its two
    planes `<name>_q` and `<name>_s`, its bits and axis in
    `module.qmeta`."""
    if isinstance(t, QTensor):
        module.register_buffer(f"{name}_q", t.q)
        module.register_buffer(f"{name}_s", t.s)
        module.qmeta[name] = (t.bits, t.axis)
    else:
        module.register_buffer(name, t)


def _get(module: nn.Module, name: str):
    if name in module.qmeta:
        bits, axis = module.qmeta[name]
        return QTensor(q=getattr(module, f"{name}_q"),
                       s=getattr(module, f"{name}_s"), bits=bits, axis=axis)
    return getattr(module, name)


class Llama(nn.Module):
    """One model's stacked [L, ...] weights and RoPE table on a device.

    Buffers mirror the parameter tree: `embed`, `final_norm`,
    `lm_head` and `layers.<leaf>`; a quantized leaf is two buffers,
    `<leaf>_q` and `<leaf>_s`, so `.to(device)` moves both planes.
    `params` gives the tree back, QTensor leaves included, for the
    plain functions above."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.qmeta: Dict[str, Tuple[int, int]] = {}
        self.layers = nn.Module()
        self.layers.qmeta = {}
        self.layer_names = list(params["layers"])
        self.top_names = [n for n in ("embed", "final_norm", "lm_head")
                          if n in params]
        for name in self.layer_names:
            _put(self.layers, name, params["layers"][name])
        for name in self.top_names:
            _put(self, name, params[name])
        self.register_buffer("freqs", rope_frequencies(
            cfg, params["embed"].device), persistent=False)

    @property
    def params(self) -> Params:
        tree = {name: _get(self, name) for name in self.top_names}
        tree["layers"] = {name: _get(self.layers, name)
                          for name in self.layer_names}
        return tree

    def forward(self, tokens, positions=None, cache=None, rows=None):
        return forward(self.params, self.cfg, tokens, positions, cache,
                       rows, freqs=self.freqs)

    def forward_paged(self, tokens, cache: PagedKVCache):
        return forward_paged(self.params, self.cfg, tokens, cache,
                             freqs=self.freqs)
