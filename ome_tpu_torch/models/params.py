"""Parameter trees for the port: the JAX bridge and the port's own init.

The port keeps the reference's parameter layout: a nested dict with the
leaf names of `ome_tpu.models.llama.init_params` and the per-layer
tensors stacked on a leading [L, ...] axis (`layers["wq"]` is
[L, D, H, Dh]). So a tree from the JAX package maps leaf for leaf:

* `from_jax_params(tree, device)` takes that tree as numpy arrays (what
  `jax.tree.map(np.asarray, params)` gives) and returns torch tensors
  with the same bytes; bf16 travels through a uint16 view and fp8
  through a uint8 view, since numpy has neither of its own. A quantized
  leaf (the reference's QTensor, with numpy `q` and `s`) becomes the
  port's `QTensor`. The tests use it to run the JAX init's weights,
  plain or quantized, through both packages.
* `init_params(cfg, generator, device)` is the port's own random init
  for `--random-weights`: the same leaf names, shapes and dtypes, normal
  with std 0.02 (the residual output projections scaled by
  1/sqrt(2 * depth)), zero biases and identity norm scales (qk_norm
  included) as `llama.init_params` — but drawn from a
  `torch.Generator`, so its numbers are not the JAX init's. It also
  makes the leaves the reference's init leaves out and its checkpoint
  loader reads (sinks, o_proj, router, expert, norm and head biases),
  so that a random gpt-oss or Phi-3.5-MoE runs every term.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .quant import QTensor

Params = Dict[str, Any]


def _leaf_from_numpy(a, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"expected a numpy array leaf, got {type(a).__name__}")
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # views of JAX buffers are read-only
        a = a.copy()
    # numpy has no bf16 or fp8 of its own (ml_dtypes supplies them):
    # they travel as raw bytes
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree: Params,
                    device: Union[str, torch.device]) -> Params:
    """Numpy parameter tree (leaf names and [L, ...] stacking of
    `ome_tpu.models.llama.init_params`) -> the same tree of torch
    tensors on `device`, byte for byte."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("q", "s", "bits", "axis")):
        # the reference's QTensor (read by attribute: the port does not
        # import it) -> the port's, bytes, bits and axis unchanged
        return QTensor(q=_leaf_from_numpy(tree.q, device),
                       s=_leaf_from_numpy(tree.s, device),
                       bits=int(tree.bits), axis=int(tree.axis))
    return _leaf_from_numpy(tree, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy (bf16 as a uint16 view, fp8 as a uint8
    view) — the inverse of the bridge, for byte comparisons."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


ROUTERS = ("mixtral", "sparsemixer", "softmax_v2", "sigmoid_v3")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves every family of the reference's models/llama.py:
    Llama/Mistral, Qwen2/Qwen3, Phi-3, Mixtral, Gemma 2, command-r,
    Cohere2, Phi-3.5-MoE, gpt-oss and the MLA family (DeepSeek-V2,
    V2-Lite, V3, Kimi-K2: MLA attention, shared experts, first_k_dense
    layers, the softmax_v2 and sigmoid_v3 routers, V3's selection bias).
    Refuse by name what the reference's models do not compute (a
    router, an activation or a norm they do not have) instead of
    computing a different model; and an alternating-window depth that
    is not a whole number of periods."""
    moe = cfg.is_moe
    unsupported = {
        f"router_scoring {cfg.router_scoring!r}":
            moe and cfg.router_scoring not in ROUTERS,
        f"moe_activation {cfg.moe_activation!r}":
            moe and cfg.moe_activation not in ("silu", "gptoss_glu"),
        f"norm_type {cfg.norm_type!r}":
            cfg.norm_type not in ("rmsnorm", "layernorm",
                                  "layernorm_nobias"),
        f"mlp_activation {cfg.mlp_activation!r}":
            cfg.mlp_activation not in ("silu", "gelu_tanh"),
    }
    names = [k for k, on in unsupported.items() if on]
    if names:
        raise NotImplementedError(
            "the PyTorch port serves the families of models/llama.py; "
            f"this configuration is outside them: {', '.join(names)}")
    from .llama import layer_windows
    layer_windows(cfg)  # refuses a depth not divisible by the period


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device],
                shard: Optional[Tuple[int, int]] = None) -> Params:
    """Random weights for `cfg` on `device` (the generator must live on
    the same device). Each stacked leaf is filled one layer at a time,
    and an expert leaf [L, E, ...] one expert at a time, so the fp32
    draw stays one layer (or one expert) large. The leaves of the other
    families are the checkpoint loader's, with its shapes and dtypes:
    LayerNorm biases, Gemma's post-block norms, gpt-oss's sinks and
    router bias (fp32), o_proj and expert biases, the head's bias (fp32)
    and the final norm's; biases and sinks start at zero, unit-offset
    norm scales at zero (the identity), as the reference inits its
    biases and scales. MLA models get the reference's MLA leaves (`wq`
    or `wq_a`/`q_a_norm`/`wq_b`, `wkv_a`, `kv_a_norm`, `w_uk`, `w_uv`,
    `wo` [L, H, v, D]), DeepSeek's MoE its shared experts `ws_*` and
    V3's fp32 selection bias `router_bias` (zero), and first_k_dense
    models a `dense_layers` block of that many dense layers, drawn
    before `layers`.

    `shard` = (rank, tp) makes rank `rank`'s slice of every leaf under
    the tensor-parallel rules (`parallel/sharding.py`): each slab (a
    layer, an expert, a 2-D leaf) is drawn whole, in the same order and
    from the same generator as without `shard`, and only the rank's part
    of it is kept. So the slices equal the unsharded tree's, and the
    draw never holds more than one slab beyond the rank's shard. A leaf
    the rules do not name raises `sharding.UnshardableLeaf`."""
    check_supported(cfg)
    device = torch.device(device)
    rank, tp = shard or (0, 1)
    bname: Optional[str] = None  # the block being drawn (None: top)

    def tp_dim(name):
        if tp == 1:
            return None
        from ..parallel.sharding import leaf_spec, tp_dim as spec_dim
        return spec_dim(leaf_spec(bname, name))

    def local(name, shape):
        dim = tp_dim(name)
        shape = list(shape)
        if dim is not None:
            if shape[dim] % tp:
                raise ValueError(
                    f"tp={tp} must divide dim {dim} of parameter "
                    f"{name} (size {shape[dim]})")
            shape[dim] //= tp
        return dim, tuple(shape)

    def whole(name, t):
        # a constant leaf (norm scale, bias): its slice, made directly
        dim, shape = local(name, t.shape)
        return t if dim is None else t.narrow(
            dim, 0, shape[dim]).clone()
    D, H, K, Dh, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    L = cfg.num_layers
    out_std = 0.02 / math.sqrt(2 * L)

    def normal(name, shape, std=0.02, per_expert=False):
        # slabs: each expert of each layer, each layer, or the 2-D leaf
        dim, lshape = local(name, shape)
        out = torch.empty(lshape, dtype=cfg.dtype, device=device)
        lead = 2 if per_expert else 1 if len(shape) >= 3 else 0
        n = None if dim is None else lshape[dim]
        for idx in itertools.product(*map(range, shape[:lead])):
            slab = torch.randn(shape[lead:], generator=generator,
                               device=device,
                               dtype=torch.float32).mul_(std)
            if dim is not None and dim < lead:  # a slab of one rank
                if idx[dim] // n != rank:
                    continue
                idx = idx[:dim] + (idx[dim] % n,) + idx[dim + 1:]
            elif dim is not None:
                slab = slab.narrow(dim - lead, rank * n, n)
            out[idx].copy_(slab)
        return out

    def zeros(name, *shape, dtype=None):
        return whole(name, torch.zeros(shape, dtype=dtype or cfg.dtype,
                                       device=device))

    def scale(name, *shape):
        # unit-offset (Gemma) norms store scale - 1: zeros = identity
        if cfg.unit_offset_norm:
            return zeros(name, *shape)
        return whole(name, torch.ones(shape, dtype=cfg.dtype,
                                      device=device))

    layernorm = cfg.norm_type == "layernorm"
    # drawn first, as it always was
    embed = normal("embed", (cfg.vocab_size, D))

    def block(L: int, moe: bool) -> Params:
        """One stacked block of L layers (`layers`, or DeepSeek's
        leading dense `dense_layers`)."""
        layers: Params = {"attn_norm": scale("attn_norm", L, D)}
        if not cfg.parallel_block:  # command-r: one norm feeds both
            layers["mlp_norm"] = scale("mlp_norm", L, D)
        if cfg.mla:
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            r = cfg.kv_lora_rank
            if cfg.q_lora_rank:
                layers.update(
                    wq_a=normal("wq_a", (L, D, cfg.q_lora_rank)),
                    q_a_norm=scale("q_a_norm", L, cfg.q_lora_rank),
                    wq_b=normal("wq_b", (L, cfg.q_lora_rank, H, qk)))
            else:
                layers["wq"] = normal("wq", (L, D, H, qk))
            layers.update(
                wkv_a=normal("wkv_a", (L, D, r + cfg.qk_rope_head_dim)),
                kv_a_norm=scale("kv_a_norm", L, r),
                w_uk=normal("w_uk", (L, H, cfg.qk_nope_head_dim, r)),
                w_uv=normal("w_uv", (L, H, r, cfg.v_head_dim)),
                wo=normal("wo", (L, H, cfg.v_head_dim, D), out_std))
        else:
            layers.update(wq=normal("wq", (L, D, H, Dh)),
                          wk=normal("wk", (L, D, K, Dh)),
                          wv=normal("wv", (L, D, K, Dh)),
                          wo=normal("wo", (L, H, Dh, D), out_std))
        if layernorm:
            layers["attn_norm_bias"] = zeros("attn_norm_bias", L, D)
            layers["mlp_norm_bias"] = zeros("mlp_norm_bias", L, D)
        if cfg.post_block_norms:
            layers["attn_post_norm"] = scale("attn_post_norm", L, D)
            layers["mlp_post_norm"] = scale("mlp_post_norm", L, D)
        if cfg.qk_norm:
            # command-r-plus norms per (head, dim), Qwen3 per dim
            per_head = cfg.norm_type == "layernorm_nobias"
            layers["q_norm"] = scale("q_norm", L, H, Dh) if per_head \
                else scale("q_norm", L, Dh)
            layers["k_norm"] = scale("k_norm", L, K, Dh) if per_head \
                else scale("k_norm", L, Dh)
        if cfg.attn_bias:
            layers["bq"] = zeros("bq", L, H, Dh)
            layers["bk"] = zeros("bk", L, K, Dh)
            layers["bv"] = zeros("bv", L, K, Dh)
            if cfg.attn_sinks or layernorm:  # gpt-oss, Phi-3.5-MoE
                layers["bo"] = zeros("bo", L, D)
        if cfg.attn_sinks:
            layers["sinks"] = zeros("sinks", L, H, dtype=torch.float32)
        if moe:
            E, Fm = cfg.num_experts, cfg.moe_intermediate_size or F
            layers["router"] = normal("router", (L, D, E))
            layers["we_gate"] = normal("we_gate", (L, E, D, Fm),
                                       per_expert=True)
            layers["we_up"] = normal("we_up", (L, E, D, Fm),
                                     per_expert=True)
            layers["we_down"] = normal("we_down", (L, E, Fm, D), out_std,
                                       per_expert=True)
            if cfg.moe_bias:
                layers["router_b"] = zeros("router_b", L, E,
                                           dtype=torch.float32)
                layers["we_gate_b"] = zeros("we_gate_b", L, E, Fm)
                layers["we_up_b"] = zeros("we_up_b", L, E, Fm)
                layers["we_down_b"] = zeros("we_down_b", L, E, D)
            elif cfg.router_bias:  # DeepSeek-V3's selection bias
                layers["router_bias"] = zeros("router_bias", L, E,
                                              dtype=torch.float32)
            if cfg.num_shared_experts > 0:
                Fs = Fm * cfg.num_shared_experts
                layers["ws_gate"] = normal("ws_gate", (L, D, Fs))
                layers["ws_up"] = normal("ws_up", (L, D, Fs))
                layers["ws_down"] = normal("ws_down", (L, Fs, D), out_std)
        else:
            layers["w_gate"] = normal("w_gate", (L, D, F))
            layers["w_up"] = normal("w_up", (L, D, F))
            layers["w_down"] = normal("w_down", (L, F, D), out_std)
        return layers

    n_dense = cfg.first_k_dense if cfg.is_moe else 0
    dense = None
    if n_dense:
        bname = "dense_layers"
        dense = block(n_dense, moe=False)
    bname = "layers"
    layers = block(L - n_dense, cfg.is_moe)
    bname = None
    params: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": scale("final_norm", D),
    }
    if dense is not None:
        params["dense_layers"] = dense
    if layernorm:
        params["final_norm_bias"] = zeros("final_norm_bias", D)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal("lm_head", (D, cfg.vocab_size))
    if cfg.lm_head_bias:
        params["lm_head_bias"] = zeros("lm_head_bias", cfg.vocab_size,
                                       dtype=torch.float32)
    return params


def param_count(params: Params) -> int:
    """Logical weight count (a QTensor counts its unpacked size)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, QTensor):
        return params.size
    return params.numel()
