"""Llama-family decoder in PyTorch (port of ome_tpu/models/llama.py).

Every family of the reference: RMSNorm (with Gemma's unit
offset) or mean-centered LayerNorm (with bias: Phi-3.5-MoE; weight
only: command-r) through `block_norm`; rotate-half or interleaved
(command-r) RoPE with default, linear, llama3, yarn and longrope
frequencies; the SiLU or tanh-GELU (Gemma 2) gated MLP; GQA attention
through `ops.attention` with a per-layer sliding window (alternating
sliding and global layers: Gemma 2, Cohere2, gpt-oss; Cohere2's global
layers skip RoPE), a logit softcap and gpt-oss's sink logits; the
command-r parallel block and Gemma's post-block norms; the Qwen2
q/k/v (and o) projection biases and per-head q/k norms; the top-k MoE
MLP (`moe_mlp`: Mixtral's router, gpt-oss's biased router with its
clamped GLU and expert biases, Phi-3.5-MoE's sparsemixer; the
reference's dense impl and its ragged dispatch, grouped products
through `torch._grouped_mm` on the card); fp32 logits with a bias, a
scale and a final softcap; and the multi-LoRA deltas of the engine's
adapter stacks (`_proj_lora`: plain batched products beside each
projection, as the reference's einsums sit outside its kernels). And
the DeepSeek family (DeepSeek-V2, V2-Lite, V3, Kimi-K2): MLA attention
(models/mla.py) over a latent cache, DeepSeek's routers (`_route`'s
softmax_v2 with group-limited greedy, sigmoid_v3 with its selection
bias and top-2-sum group scores), the always-active shared experts
(`_shared_mlp`) and the leading dense-MLP layers (`first_k_dense`), a
`dense_layers` block run before `layers`.

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
from ..parallel import comm
from ..ops.flash import quantize_rows
from ..ops.int4_matmul import int4_eligible, int4_matmul
from ..ops.paged import paged_attention, paged_attention_multi
from .config import ModelConfig
from .mla import mla_attention
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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in fp32; `unit_offset` is Gemma's convention of storing
    the scale as (scale - 1)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    w = scale.float()
    if unit_offset:
        w = 1.0 + w
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """Mean-centered LayerNorm in fp32. bias=None is command-r's
    weight-only form; with a bias it is torch's LayerNorm
    (Phi-3.5-MoE)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def block_norm(x: torch.Tensor, lp, name: str,
               cfg: ModelConfig) -> torch.Tensor:
    """The norm `name` of `lp` (a layer's leaves, or the top of the
    tree for `final_norm`), dispatched on cfg.norm_type; layernorm
    biases ride as `<name>_bias` leaves."""
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, lp[name], cfg.rms_norm_eps, cfg.unit_offset_norm)
    bias = lp.get(name + "_bias") if cfg.norm_type == "layernorm" \
        else None
    return layer_norm(x, lp[name], bias, cfg.rms_norm_eps)


def rope_frequencies(cfg: ModelConfig,
                     device: Union[str, torch.device]) -> torch.Tensor:
    """[head_dim / 2] fp32 inverse frequencies (reference
    `_rope_frequencies`) with linear, llama3 (Llama-3.1 NTK-by-parts),
    yarn and longrope scaling. Yarn's cos/sin attention factor is not
    applied here: `ModelConfig.from_hf_config` folds it into
    `query_scale` once. longrope takes `long_factor` when the config's
    window (`max_seq_len`, its max_position_embeddings) exceeds
    `original_max_position_embeddings`, whatever window the engine
    serves. Any other type is refused by name. An MLA model's table is
    that of its rope dims (`mla.rope_interleaved`'s, yarn's attention
    factor apart)."""
    if cfg.mla:
        from .mla import yarn_frequencies
        return yarn_frequencies(cfg, cfg.qk_rope_head_dim, device)[0]
    half = cfg.head_dim // 2
    freqs = 1.0 / cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=device) / half)
    sc = cfg.rope_scaling
    rtype = sc.get("rope_type", sc.get("type")) if sc else None
    if rtype not in (None, "default", "llama3", "yarn", "longrope",
                     "linear"):
        raise ValueError(f"unsupported rope_scaling type {rtype!r}")
    if rtype == "yarn":
        from .mla import yarn_frequencies
        freqs, _ = yarn_frequencies(cfg, cfg.head_dim, device)
    elif rtype == "longrope":
        orig = sc.get("original_max_position_embeddings", cfg.max_seq_len)
        which = "long_factor" if cfg.max_seq_len > orig else "short_factor"
        freqs = freqs / torch.tensor(sc[which], dtype=torch.float32,
                                     device=device)
    elif rtype == "linear":
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
               freqs: torch.Tensor, interleaved: bool = False
               ) -> torch.Tensor:
    """RoPE. x: [B, S, N, Dh]; positions: [B, S]. Rotate-half (HF Llama
    convention) by default; `interleaved` rotates even/odd pairs
    (command-r's repeat_interleave convention)."""
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape).to(x.dtype)
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _proj(x: torch.Tensor, w, dtype, out_dims=None,
          flatten: int = 1) -> torch.Tensor:
    """Contract x's trailing `flatten` dims with weight `w` (reference
    `_proj`). A plain tensor multiplies in the weights' dtype (bf16
    weights: bf16 product, fp32 accumulation). A QTensor that
    `int4_eligible` takes (int4, at most 256 flattened rows) goes
    through the int4 kernel (B4) with its output in `dtype`; every
    other QTensor (int8, fp8, wo's flatten=2 layout, a prefill of more
    than 256 rows) is dequantized to `dtype` and multiplied under JAX's
    promotion (an fp32 x against a bf16 dequant multiplies in fp32) —
    the reference's own dispatch (ome_tpu/models/llama.py:59-65)."""
    lead = x.shape[:x.dim() - flatten]
    K = math.prod(x.shape[len(lead):])
    x2 = x.reshape(*lead, K)
    if not isinstance(w, QTensor):
        y = x2 @ w.reshape(K, -1)
    elif w.bits == 4 and int4_eligible(tuple(x2.shape), w):
        y = int4_matmul(x2, w, dtype)
    else:
        wd = w.dequant(dtype).reshape(K, -1)
        out = torch.promote_types(x2.dtype, wd.dtype)
        y = x2.to(out) @ wd.to(out)
    if out_dims:
        y = y.reshape(*y.shape[:-1], *out_dims)
    return y


# -- multi-LoRA deltas (reference `_lora_delta`, `_proj_lora`) -------------

# a layer's adapter factors: {leaf: (A [B, r, K], B [B, r, N])}, each
# row's adapter already selected (`select_adapters`); None = no delta
Lora = Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


def _lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                flatten: int = 1) -> torch.Tensor:
    """Per-row low-rank delta [B, S, N] in x's dtype (reference
    `_lora_delta`, whose per-layer gather by adapter id
    `select_adapters` has done for every layer already): x's trailing
    `flatten` dims contracted with the row's A [r, K], then with its B
    [r, N] (scaling folded into B), the reference's two einsums
    `bsk,brk->bsr` and `bsr,brn->bsn` as batched products."""
    B = x.shape[0]
    K = math.prod(x.shape[x.dim() - flatten:])
    x2 = x.reshape(B, -1, K)
    h = torch.bmm(x2, a.to(x2.dtype).transpose(1, 2))
    return torch.bmm(h, b.to(x2.dtype))


def select_adapters(stacks, adapter_ids: Optional[torch.Tensor]
                    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each row's factors gathered once for every layer: the stacks
    `<leaf>_lora_a` [L, n_slots, r, K] / `<leaf>_lora_b` [L, n_slots, r,
    N] -> {leaf: (A [L, B, r, K], B [L, B, r, N])}, two gathers per
    target per forward instead of the reference's two per target per
    layer, the same values. Slot 0 of a stack is all zeros (the base
    model). Empty when `stacks` or `adapter_ids` is None."""
    if not stacks or adapter_ids is None:
        return {}
    ids = adapter_ids.long()
    return {name[:-len("_lora_a")]: (
                a.index_select(1, ids),
                stacks[name[:-len("_a")] + "_b"].index_select(1, ids))
            for name, a in stacks.items() if name.endswith("_lora_a")}


def _proj_lora(x: torch.Tensor, lp, name: str, lora: Lora, dtype,
               out_dims=None, flatten: int = 1) -> torch.Tensor:
    """`_proj` plus the rows' adapter delta (reference `_proj_lora`):
    the delta is added to the base product's output (under int4, B4's),
    then the output dims are split."""
    y = _proj(x, lp[name], dtype, flatten=flatten)
    if lora and name in lora:
        y = y + _lora_delta(x, *lora[name], flatten=flatten).reshape(
            y.shape)
    if out_dims:
        y = y.reshape(*y.shape[:-1], *out_dims)
    return y


def _layer_lora(lora, i: int) -> Lora:
    """Layer i's slice of `select_adapters`' factors (None when empty)."""
    return {n: (a[i], b[i]) for n, (a, b) in lora.items()} if lora else None


def _layer_params(layers, i: int):
    """Layer i's leaves."""
    return {name: t[i] for name, t in layers.items()}


def _block_depth(layers) -> int:
    return next(iter(layers.values())).shape[0]


def layer_blocks(params: Params, cfg: ModelConfig):
    """Each layer's (leaves, moe) in order: DeepSeek's `dense_layers`
    block (first_k_dense dense-MLP layers) first, then `layers`, whose
    MoE flag is the model's (reference `forward`'s two scans)."""
    for name, moe in (("dense_layers", False), ("layers", cfg.is_moe)):
        block = params.get(name)
        if block:
            for i in range(_block_depth(block)):
                yield _layer_params(block, i), moe


def _activate(gate: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP's activation: SiLU, or Gemma 2's tanh GELU."""
    if cfg.mlp_activation == "gelu_tanh":
        return F.gelu(gate, approximate="tanh")
    return F.silu(gate)


def dense_mlp(x: torch.Tensor, p, cfg: ModelConfig,
              lora: Lora = None) -> torch.Tensor:
    """The gated MLP. Under tp its hidden dim is split over the ranks
    (w_gate/w_up by column, w_down by row): the down projection's
    partial outputs are summed (`comm.reduce_sum`), and in training the
    input's gradient over the ranks (`comm.copy_to_tp`)."""
    x = comm.copy_to_tp(x)
    gate = _proj_lora(x, p, "w_gate", lora, cfg.dtype)
    up = _proj_lora(x, p, "w_up", lora, cfg.dtype)
    return comm.reduce_sum(_proj_lora(_activate(gate, cfg) * up, p,
                                      "w_down", lora, cfg.dtype))


# -- mixture of experts -----------------------------------------------------


def _w(w, dtype) -> torch.Tensor:
    """A weight the products take whole (an expert stack, an MLA
    projection) in the compute dtype: a QTensor is dequantized at use
    (reference `_w`)."""
    return w.dequant(dtype) if isinstance(w, QTensor) else w


def _top_k(x: torch.Tensor, k: int):
    """(values, ids) of the k largest along the last dim, ties taken
    lower index first, as `lax.top_k` takes them (a stable descending
    sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, p, cfg: ModelConfig):
    """Router (reference `_route`): the router product in x's dtype,
    widened to fp32 logits. router_scoring
      * "mixtral" (Mixtral, gpt-oss): gpt-oss's router bias `router_b`
        added before selection, the top k, then a softmax over the k
        picked logits;
      * "sparsemixer" (Phi-3.5-MoE): `_route_sparsemixer`;
      * "softmax_v2" (DeepSeek-V2): a softmax over every expert; with
        1 < n_group and 0 < topk_group < n_group, group-limited greedy
        (groups scored by their best expert, the experts of the
        topk_group best groups kept, the others zeroed);
      * "sigmoid_v3" (DeepSeek-V3, Kimi-K2): sigmoid scores; the
        selection bias `router_bias` (fp32) is added for choosing only,
        and groups are scored by the sum of their two best.
    The top k of the (masked) choice are picked; their weights are the
    unbiased scores, divided by their sum + 1e-20 under norm_topk_prob,
    and times routed_scaling_factor, which DeepSeek-V2 skips when it
    normalizes. Every top k takes ties lower id first (`_top_k`).
    Returns (weights [B, S, k] fp32, ids [B, S, k])."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    k = cfg.experts_per_token
    if cfg.router_scoring == "sparsemixer":
        return _route_sparsemixer(logits, cfg)
    if cfg.router_scoring == "mixtral":
        if cfg.moe_bias and "router_b" in p:
            logits = logits + p["router_b"]
        vals, idx = _top_k(logits, k)
        return torch.softmax(vals, dim=-1), idx
    if cfg.router_scoring == "sigmoid_v3":
        scores = torch.sigmoid(logits)
        choice = scores + p["router_bias"] if "router_bias" in p \
            else scores

        def group_reduce(g):  # a group's merit: the sum of its best two
            return _top_k(g, 2)[0].sum(dim=-1)
    else:  # softmax_v2
        scores = torch.softmax(logits, dim=-1)
        choice = scores

        def group_reduce(g):
            return g.amax(dim=-1)
    if cfg.n_group > 1 and 0 < cfg.topk_group < cfg.n_group:
        B, S, E = choice.shape
        g = choice.reshape(B, S, cfg.n_group, E // cfg.n_group)
        gidx = _top_k(group_reduce(g), cfg.topk_group)[1]
        gmask = torch.zeros((B, S, cfg.n_group), dtype=torch.bool,
                            device=x.device).scatter_(-1, gidx, True)
        choice = torch.where(
            gmask.repeat_interleave(E // cfg.n_group, dim=-1), choice,
            torch.zeros((), dtype=choice.dtype, device=x.device))
    idx = _top_k(choice, k)[1]
    weights = scores.gather(-1, idx)
    if cfg.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        if cfg.router_scoring == "softmax_v2":
            return weights, idx
    return weights * cfg.routed_scaling_factor, idx


def _route_sparsemixer(scores: torch.Tensor, cfg: ModelConfig):
    """Phi-3.5-MoE's inference-time sparsemixer (reference
    `_route_sparsemixer`): top-1 twice, the second pick among the
    logits with the first removed. Each pick masks out the logits more
    than 2 x router_jitter below its candidates' max, relative to
    max(|logit|, that max), and its weight is its softmax over its own
    masked logits (the two are not normalized together). `argmax`
    takes the lower expert id among ties, as the reference's does."""
    eps = cfg.router_jitter

    def pick(masked_from: torch.Tensor):
        m = masked_from.max(dim=-1, keepdim=True).values
        idx = masked_from.argmax(dim=-1)
        factor = torch.maximum(scores.abs(), m)
        drop = (m - scores) / factor > 2 * eps
        gates = torch.softmax(masked_from.masked_fill(drop, -math.inf),
                              dim=-1)
        return gates.gather(-1, idx[..., None])[..., 0], idx

    w1, i1 = pick(scores)
    masked = scores.masked_fill(
        F.one_hot(i1, scores.shape[-1]).bool(), -math.inf)
    w2, i2 = pick(masked)
    return torch.stack([w1, w2], dim=-1), torch.stack([i1, i2], dim=-1)


def _moe_act(gate: torch.Tensor, up: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The experts' activation: the MLP's, or gpt-oss's clamped GLU
    (gate capped at 7, up clamped to +-7, (up + 1) * gate *
    sigmoid(1.702 gate))."""
    if cfg.moe_activation == "gptoss_glu":
        gate = gate.clamp(max=7.0)
        up = up.clamp(-7.0, 7.0)
        return (up + 1.0) * (gate * torch.sigmoid(gate * 1.702))
    return _activate(gate, cfg) * up


def moe_mlp_dense(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE computing every expert for every token and mixing by
    router weight (reference `moe_mlp_dense`): O(E) products, static
    shapes; the fp32 cross-check of the ragged dispatch. gpt-oss's
    expert biases are added to each expert's gate, up and output (the
    output's before the routing weight scales it).
    Under tp the experts are split over the ranks (expert parallelism):
    a rank computes its own E/tp experts and mixes them by their columns
    of the routing weights; `moe_mlp` sums the ranks' partial outputs.
    In training the experts' input and the routing weights are
    `comm.copy_to_tp`'s: the router runs whole on every rank, and each
    rank's experts give it part of their gradient."""
    weights, idx = _route(x, p, cfg)
    xe = comm.copy_to_tp(x)
    gate = torch.einsum("bsd,edf->bsef", xe, _w(p["we_gate"], cfg.dtype))
    up = torch.einsum("bsd,edf->bsef", xe, _w(p["we_up"], cfg.dtype))
    if cfg.moe_bias:
        gate = gate + p["we_gate_b"]
        up = up + p["we_up_b"]
    expert_out = torch.einsum("bsef,efd->bsed", _moe_act(gate, up, cfg),
                              _w(p["we_down"], cfg.dtype))
    if cfg.moe_bias:
        expert_out = expert_out + p["we_down_b"]
    onehot = F.one_hot(idx, cfg.num_experts).to(weights.dtype)
    mix = torch.einsum("bske,bsk->bse", onehot, weights)
    e_local = expert_out.shape[2]
    if e_local != cfg.num_experts:  # this rank's experts' columns
        mix = comm.copy_to_tp(mix).narrow(
            -1, comm.rank_and_size()[0] * e_local, e_local)
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
    `jnp.argsort`), run the grouped products (with the rows' expert
    biases where the model has them), weight each row, put the
    rows back in (token, pick) order and add each token's k rows in pick
    order in the rows' dtype, then cast to x's dtype. Static shapes and
    no host read, so a `decode_multi` chunk stays free of syncs. One
    device only: under tp the experts are split and the dense impl runs,
    as in the reference."""
    if comm.current() is not None:
        raise NotImplementedError(
            "the ragged MoE dispatch runs on one device; a tp group "
            "serves moe_impl='dense'")
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
    if cfg.moe_bias:
        # each row's expert biases, gathered by its sorted expert id
        gate = gate + p["we_gate_b"][sorted_ids]
        up = up + p["we_up_b"][sorted_ids]
    out_sorted = _grouped(_moe_act(gate, up, cfg),
                          _w(p["we_down"], cfg.dtype), sorted_ids, offs)
    if cfg.moe_bias:
        out_sorted = out_sorted + p["we_down_b"][sorted_ids]
    w_sorted = weights.reshape(T * k)[order]
    contrib = out_sorted * w_sorted[:, None].to(out_sorted.dtype)
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)
    rows = rows.reshape(T, k, D)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out.reshape(B, S, D).to(x.dtype)


def _shared_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """DeepSeek's shared experts, an always-active dense SiLU MLP over
    `ws_gate`, `ws_up`, `ws_down`. The reference calls its `dense_mlp`
    here without the model config, so its `_proj` runs with the bf16
    default: a quantized leaf dequantizes to bf16, and B4 leaves its
    product as bf16, even in an fp32 model."""
    bf16 = torch.bfloat16
    x = comm.copy_to_tp(x)  # hidden dim split under tp
    gate = _proj(x, p["ws_gate"], bf16)
    up = _proj(x, p["ws_up"], bf16)
    return _proj(F.silu(gate) * up, p["ws_down"], bf16)


def moe_mlp(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE block (reference `moe_mlp`), plus DeepSeek's shared
    experts (`_shared_mlp`) added to the routed experts' output. Under
    tp both are partial (experts split, the shared experts' hidden dim
    split): one sum over the ranks covers the two."""
    if cfg.moe_impl == "ragged":
        out = moe_mlp_ragged(x, p, cfg)
    else:
        out = moe_mlp_dense(x, p, cfg)
    if cfg.num_shared_experts > 0:
        out = out + _shared_mlp(x, p)
    return comm.reduce_sum(out)


# -- forward ---------------------------------------------------------------


def _embed(emb, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding lookup in the compute dtype; a quantized table
    dequantizes only the rows it gathers (`QTensor.take`). Under tp the
    table is split by vocab rows (`comm.embed_lookup`)."""
    if isinstance(emb, QTensor):
        return comm.embed_lookup(lambda t: emb.take(t, dtype), tokens,
                                 emb.q.shape[0], dtype)
    return comm.embed_lookup(lambda t: emb[t.long()].to(dtype), tokens,
                             emb.shape[0], dtype)


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
         positions: torch.Tensor, lora: Lora = None, rope: bool = True):
    """Projected (with the rows' adapter deltas), biased (Qwen2, gpt-oss,
    Phi-3.5-MoE), per-head normed (Qwen3 RMSNorm, command-r-plus
    LayerNorm) and roped q/k/v, in the reference's order; shared by the
    dense and paged paths. `rope=False` is Cohere2's NoPE global
    layers. Under tp the input's gradient is summed over the ranks
    (`comm.copy_to_tp`), and so is that of a replicated per-head norm."""
    # heads from the weights: a tp rank holds H/tp and K/tp of them
    h = comm.copy_to_tp(h)
    q = _proj_lora(h, lp, "wq", lora, cfg.dtype,
                   out_dims=(-1, cfg.head_dim))
    k = _proj_lora(h, lp, "wk", lora, cfg.dtype,
                   out_dims=(-1, cfg.head_dim))
    v = _proj_lora(h, lp, "wv", lora, cfg.dtype,
                   out_dims=(-1, cfg.head_dim))
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if cfg.qk_norm:
        # the reference's own dispatch: LayerNorm only under
        # layernorm_nobias, RMSNorm otherwise (layernorm included)
        if cfg.norm_type == "layernorm_nobias":
            # command-r-plus: per-(head, dim) weighted LayerNorm; the
            # norms stay whole under tp, a rank takes its heads' rows
            q = layer_norm(q, comm.local_rows(lp["q_norm"], q.shape[-2]),
                           None, cfg.rms_norm_eps)
            k = layer_norm(k, comm.local_rows(lp["k_norm"], k.shape[-2]),
                           None, cfg.rms_norm_eps)
        else:
            q = rms_norm(q, comm.copy_to_tp(lp["q_norm"]),
                         cfg.rms_norm_eps, cfg.unit_offset_norm)
            k = rms_norm(k, comm.copy_to_tp(lp["k_norm"]),
                         cfg.rms_norm_eps, cfg.unit_offset_norm)
    if rope:
        q = apply_rope(q, positions, freqs, cfg.rope_interleaved)
        k = apply_rope(k, positions, freqs, cfg.rope_interleaved)
    return q, k, v


def _out_proj(attn: torch.Tensor, lp, cfg: ModelConfig,
              lora: Lora = None) -> torch.Tensor:
    """o_proj with the rows' adapter deltas, plus its bias where the
    checkpoint carries one. Under tp a rank's heads give a partial
    output: the ranks' parts are summed first, then the bias is added
    once."""
    a = comm.reduce_sum(_proj_lora(attn, lp, "wo", lora, cfg.dtype,
                                   flatten=2))
    if "bo" in lp:
        a = a + lp["bo"]
    return a


def layer_windows(cfg: ModelConfig):
    """[(sliding window or None, use_rope)] for each layer (reference
    `_alt_window_scan`): the model's one window on every layer, or, with
    alternating windows, layer i global (no window) iff
    (i + 1) % sliding_pattern == 0, its RoPE skipped under
    rope_skip_global (Cohere2's NoPE global layers). A depth that is not
    a whole number of periods is refused by name."""
    L, P = cfg.num_layers, cfg.sliding_pattern
    if not cfg.alt_sliding_window:
        return [(cfg.sliding_window, True)] * L
    if L % P:
        raise ValueError(
            f"alternating sliding windows need a depth divisible by "
            f"sliding_pattern {P}; got {L} layers")
    out = []
    for i in range(L):
        glob = (i + 1) % P == 0
        out.append((None if glob else cfg.sliding_window,
                    not (glob and cfg.rope_skip_global)))
    return out


def _mha(h: torch.Tensor, lp, cfg: ModelConfig, freqs: torch.Tensor,
         positions: torch.Tensor, kv_len: Optional[torch.Tensor],
         cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
         cache_index: Optional[IndexLike], window: Optional[int],
         lora: Lora = None, use_rope: bool = True) -> torch.Tensor:
    """GQA attention on the pre-normed input under the layer's `window`
    (None = global); with a cache the new K/V rows are written into it
    in place and attention spans the cache. gpt-oss's `sinks` ride
    along to `attention`."""
    q, k, v = _qkv(h, lp, cfg, freqs, positions, lora, rope=use_rope)
    if cache_kv is not None:
        ck, cv = cache_kv
        _write_rows(ck, k, cache_index)
        _write_rows(cv, v, cache_index)
        k, v = ck, cv
    attn = attention(q, k, v, positions=positions, kv_len=kv_len,
                     sliding_window=window, scale=cfg.query_scale,
                     logit_softcap=cfg.attn_logit_softcap,
                     sinks=lp.get("sinks") if cfg.attn_sinks else None)
    return _out_proj(attn, lp, cfg, lora)


def _mlp(h: torch.Tensor, lp, cfg: ModelConfig, lora: Lora,
         moe: bool) -> torch.Tensor:
    return moe_mlp(h, lp, cfg) if moe else dense_mlp(h, lp, cfg, lora)


def _layer(x: torch.Tensor, lp, cfg: ModelConfig, freqs, positions,
           kv_len, cache_kv, cache_index, lora: Lora,
           window: Optional[int], use_rope: bool,
           moe: Optional[bool] = None) -> torch.Tensor:
    """One block (reference `_layer`) under the layer's `window` (None =
    global) and RoPE flag, as `layer_windows` gives them. MLA models
    (cfg.mla) run `mla.mla_attention` in place of GQA attention.
    command-r's parallel block adds attention and MLP, both on one
    normed input, into one residual; Gemma 2 norms each branch's output
    before its residual add. `moe` overrides cfg.is_moe (DeepSeek's
    leading dense layers).
    `lora`: the layer's adapter factors of each row (`select_adapters`;
    MoE models carry attention targets only, MLA attention none)."""
    moe = cfg.is_moe if moe is None else moe
    h = block_norm(x, lp, "attn_norm", cfg)
    if cfg.mla:
        a = mla_attention(h, lp, cfg, positions, kv_len, cache_kv,
                          cache_index, freqs)
    else:
        a = _mha(h, lp, cfg, freqs, positions, kv_len, cache_kv,
                 cache_index, window, lora, use_rope)
    if cfg.parallel_block:
        return x + a + _mlp(h, lp, cfg, lora, moe)
    if cfg.post_block_norms:
        a = block_norm(a, lp, "attn_post_norm", cfg)
    x = x + a
    mlp_out = _mlp(block_norm(x, lp, "mlp_norm", cfg), lp, cfg, lora, moe)
    if cfg.post_block_norms:
        mlp_out = block_norm(mlp_out, lp, "mlp_post_norm", cfg)
    return x + mlp_out


def _embed_scaled(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows, times sqrt(hidden_size) for Gemma, that
    normalizer rounded to the compute dtype first as the reference
    rounds it (on the host: a device scalar would cost a copy that
    waits for the stream, every step)."""
    x = _embed(params["embed"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype).item()
    return x


class _HeadProduct(torch.autograd.Function):
    """x [N, D] @ head [D, V] in the inputs' dtype with fp32 output, on
    the card (`torch.mm`'s out_dtype form, which has no derivative). Its
    backward takes the fp32 gradient rounded to the inputs' dtype into
    products that accumulate in fp32 (the reference's jax.grad runs them
    in fp32: mixed precision's usual departure, for training only)."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dh = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, head.t(), out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dh = torch.mm(x.t(), g, out_dtype=torch.float32).to(head.dtype)
        return dx, dh


def _final_logits(params: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head with fp32 logits (the reference's einsum
    with preferred_element_type=float32): on a card the bf16 product
    writes fp32 directly (`_HeadProduct`, which also differentiates it);
    elsewhere the product runs in fp32. Then, on
    the fp32 logits, the head's bias (Phi-3.5-MoE), command-r's
    logit_scale and Gemma 2's final softcap. Under tp the head (tied or
    not) is split by vocab columns: the fp32 logits are gathered whole
    (`comm.gather_last`) before the bias, scale and softcap."""
    x = block_norm(x, params, "final_norm", cfg)
    tied = "lm_head" not in params
    head = params["embed" if tied else "lm_head"]
    if isinstance(head, QTensor):  # int8 (or fp8) head: dequantized
        head = head.dequant(cfg.dtype)
    if tied:
        head = head.t()
    lead = x.shape[:-1]
    x2 = comm.copy_to_tp(x.reshape(-1, x.shape[-1]))
    if x2.is_cuda and x2.dtype != torch.float32:
        logits = _HeadProduct.apply(x2, head)
    else:
        logits = x2.float() @ head.float()
    logits = comm.gather_last(logits.reshape(*lead, -1))
    if "lm_head_bias" in params:
        logits = logits + params["lm_head_bias"]
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            rows: Optional[torch.Tensor] = None,
            freqs: Optional[torch.Tensor] = None,
            adapter_ids: Optional[torch.Tensor] = None,
            lora_stacks=None
            ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder.

    tokens: [B, S] int. positions: [B, S] (defaults to arange, offset by
    cache.index). With `cache`, K/V are written into it in place at
    cache.index and attention spans the cache; without, plain causal
    prefill. `rows` ([B] int) computes the logits of one position per
    sequence only (a prefill needs just its last real token's).
    `adapter_ids` ([B] int) selects each row's LoRA adapter slot in
    `lora_stacks`, the engine's adapter stacks (`select_adapters`).
    Each layer runs under its own window and RoPE flag
    (`layer_windows`: the reference's pair scan, unrolled); DeepSeek's
    leading dense layers run first (`layer_blocks`: the reference's two
    scans), the cache's layer axis covering both blocks, dense first.
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
    x = _embed_scaled(params, cfg, tokens)
    kv_len = None
    if cache is not None:
        if isinstance(index, torch.Tensor):
            kv_len = torch.broadcast_to(index + S, (B,))
        else:
            kv_len = torch.full((B,), index + S, dtype=torch.int32,
                                device=dev)
    lora = select_adapters(lora_stacks, adapter_ids)
    windows = layer_windows(cfg)
    for i, (lp, moe) in enumerate(layer_blocks(params, cfg)):
        cache_kv = (cache.k[i], cache.v[i]) if cache is not None else None
        x = _layer(x, lp, cfg, freqs, positions, kv_len, cache_kv, index,
                   _layer_lora(lora, i), *windows[i], moe=moe)
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
                  freqs: Optional[torch.Tensor] = None,
                  adapter_ids: Optional[torch.Tensor] = None,
                  lora_stacks=None
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
    if it has one. Dense-MLP GQA models with one window only (the engine
    refuses paged KV for MoE, alternating windows, parallel blocks,
    LayerNorm and sinks, as the reference's does). `adapter_ids` and
    `lora_stacks` as in `forward`. Returns
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
    x = _embed_scaled(params, cfg, tokens)
    layers = params["layers"]
    lora = select_adapters(lora_stacks, adapter_ids)
    for i in range(cfg.num_layers):
        lp = _layer_params(layers, i)
        li = _layer_lora(lora, i)
        h = block_norm(x, lp, "attn_norm", cfg)
        q, k, v = _qkv(h, lp, cfg, freqs, positions, li)
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
        a = _out_proj(attn, lp, cfg, li)
        if cfg.post_block_norms:
            a = block_norm(a, lp, "attn_post_norm", cfg)
        x = x + a
        mlp_out = dense_mlp(block_norm(x, lp, "mlp_norm", cfg), lp, cfg, li)
        if cfg.post_block_norms:
            mlp_out = block_norm(mlp_out, lp, "mlp_post_norm", cfg)
        x = x + mlp_out
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

    Buffers mirror the parameter tree: `embed`, `final_norm` (and its
    bias), `lm_head` (and its bias), `layers.<leaf>` and, for DeepSeek's
    leading dense layers, `dense_layers.<leaf>`; a quantized leaf is two
    buffers, `<leaf>_q` and `<leaf>_s`, so `.to(device)` moves both
    planes.
    `params` gives the tree back, QTensor leaves included, for the
    plain functions above."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.qmeta: Dict[str, Tuple[int, int]] = {}
        self.block_names = [n for n in ("dense_layers", "layers")
                            if n in params]
        for block in self.block_names:
            mod = nn.Module()
            mod.qmeta = {}
            mod.names = list(params[block])
            for name in mod.names:
                _put(mod, name, params[block][name])
            setattr(self, block, mod)
        self.layer_names = self.layers.names
        self.top_names = [n for n in ("embed", "final_norm",
                                      "final_norm_bias", "lm_head",
                                      "lm_head_bias") if n in params]
        for name in self.top_names:
            _put(self, name, params[name])
        self.register_buffer("freqs", rope_frequencies(
            cfg, params["embed"].device), persistent=False)

    @property
    def params(self) -> Params:
        tree = {name: _get(self, name) for name in self.top_names}
        for block in self.block_names:
            mod = getattr(self, block)
            tree[block] = {name: _get(mod, name) for name in mod.names}
        return tree

    def forward(self, tokens, positions=None, cache=None, rows=None,
                adapter_ids=None, lora=None):
        return forward(self.params, self.cfg, tokens, positions, cache,
                       rows, freqs=self.freqs, adapter_ids=adapter_ids,
                       lora_stacks=lora)

    def forward_paged(self, tokens, cache: PagedKVCache, adapter_ids=None,
                      lora=None):
        return forward_paged(self.params, self.cfg, tokens, cache,
                             freqs=self.freqs, adapter_ids=adapter_ids,
                             lora_stacks=lora)
