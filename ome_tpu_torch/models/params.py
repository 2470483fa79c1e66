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
  1/sqrt(2 * depth)) as `llama.init_params` — but drawn from a
  `torch.Generator`, so its numbers are not the JAX init's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Union

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


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense GQA RMSNorm Llama subset; refuse the
    rest by name instead of computing a different model."""
    unsupported = {
        "mixture-of-experts": cfg.is_moe,
        "MLA attention": cfg.mla,
        "qk_norm": cfg.qk_norm,
        "attention biases": cfg.attn_bias,
        "post-block norms": cfg.post_block_norms,
        "embed_scale": cfg.embed_scale,
        "unit-offset norms": cfg.unit_offset_norm,
        "alternating sliding windows": cfg.alt_sliding_window,
        "parallel blocks": cfg.parallel_block,
        f"norm_type {cfg.norm_type!r}": cfg.norm_type != "rmsnorm",
        "attention sinks": cfg.attn_sinks,
        "lm_head bias": cfg.lm_head_bias,
        "logit_scale": cfg.logit_scale is not None,
        "final_logit_softcap": bool(cfg.final_logit_softcap),
        "interleaved rope": cfg.rope_interleaved,
        f"mlp_activation {cfg.mlp_activation!r}":
            cfg.mlp_activation != "silu",
    }
    names = [k for k, on in unsupported.items() if on]
    if names:
        raise NotImplementedError(
            "the PyTorch port serves dense GQA RMSNorm Llama models; "
            f"not ported yet: {', '.join(names)}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Union[str, torch.device]) -> Params:
    """Random weights for `cfg` on `device` (the generator must live on
    the same device). Each stacked leaf is filled one layer at a time,
    so the fp32 draw stays one layer large."""
    check_supported(cfg)
    device = torch.device(device)
    D, H, K, Dh, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    L = cfg.num_layers
    out_std = 0.02 / math.sqrt(2 * L)

    def normal(shape, std=0.02):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        slabs = out if len(shape) >= 3 else out[None]
        for slab in slabs:
            slab.copy_(torch.randn(slab.shape, generator=generator,
                                   device=device,
                                   dtype=torch.float32).mul_(std))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    params: Params = {
        "embed": normal((cfg.vocab_size, D)),
        "layers": {
            "attn_norm": ones(L, D),
            "mlp_norm": ones(L, D),
            "wq": normal((L, D, H, Dh)),
            "wk": normal((L, D, K, Dh)),
            "wv": normal((L, D, K, Dh)),
            "wo": normal((L, H, Dh, D), out_std),
            "w_gate": normal((L, D, F)),
            "w_up": normal((L, D, F)),
            "w_down": normal((L, F, D), out_std),
        },
        "final_norm": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((D, cfg.vocab_size))
    return params


def param_count(params: Params) -> int:
    """Logical weight count (a QTensor counts its unpacked size)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, QTensor):
        return params.size
    return params.numel()
