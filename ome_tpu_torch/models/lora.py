"""LoRA adapter loading: merged or multi-adapter serving forms.

Port of ome_tpu/models/lora.py. Reads a PEFT-format adapter directory
(adapter_config.json + adapter_model.safetensors with lora_A [r, in] /
lora_B [out, r] pairs) through the port's `checkpoint.Checkpoint`, and
either

  * `merge_lora`: folds `W += (alpha/r) * B @ A` into a param tree —
    ONE adapter at full base-model speed (`serve --adapter DIR`). The
    tree's leaves are numpy arrays (the reference's form) or torch
    tensors on any device (the port's `load_params` tree, merged before
    quantization); both round the fp32 sum once to the leaf's dtype, so
    the two give the same bits; or
  * `load_adapter_matrices`: returns per-target stacked [L, r, K_in] /
    [L, r, N_out] factor pairs (scaling folded into B, rank zero-padded
    to the engine's slot rank) for MULTI-adapter serving: the engine
    keeps per-adapter factor stacks beside the layer leaves and adds
    each slot's low-rank delta to the projections
    (engine/core.py register_adapter, models/llama.py _proj_lora).

The matrices stay numpy here, as in the reference.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from .checkpoint import Checkpoint

log = logging.getLogger("ome.lora")

# HF module name -> (our stacked leaf, reshaper from [out, in] delta)
_TARGETS = {
    "q_proj": ("wq", lambda d, cfg: d.T.reshape(
        cfg.hidden_size, cfg.num_heads, cfg.head_dim)),
    "k_proj": ("wk", lambda d, cfg: d.T.reshape(
        cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim)),
    "v_proj": ("wv", lambda d, cfg: d.T.reshape(
        cfg.hidden_size, cfg.num_kv_heads, cfg.head_dim)),
    "o_proj": ("wo", lambda d, cfg: d.T.reshape(
        cfg.num_heads, cfg.head_dim, cfg.hidden_size)),
    "gate_proj": ("w_gate", lambda d, cfg: d.T),
    "up_proj": ("w_up", lambda d, cfg: d.T),
    "down_proj": ("w_down", lambda d, cfg: d.T),
}

_KEY_RE = re.compile(
    r"(?:base_model\.model\.)?model\.layers\.(\d+)\.(?:self_attn|mlp)\."
    r"(\w+_proj)\.lora_(A|B)\.weight")


def _read_adapter(adapter_dir: str):
    """Parse a PEFT dir -> (pairs {(layer, module): {A, B}}, scaling)."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    cfg_rank = acfg.get("r", 8)
    alpha = acfg.get("lora_alpha", cfg_rank)
    rslora = bool(acfg.get("use_rslora", False))

    ckpt = Checkpoint(adapter_dir)
    pairs: Dict[tuple, Dict[str, np.ndarray]] = {}
    unmatched = []
    for key in ckpt.keys():
        m = _KEY_RE.fullmatch(key)
        if not m:
            unmatched.append(key)
            continue
        layer, module, ab = int(m.group(1)), m.group(2), m.group(3)
        pairs.setdefault((layer, module), {})[ab] = \
            ckpt.read(key).float().numpy()
    if unmatched:
        # silently dropping deltas would serve a subtly wrong model
        raise ValueError(
            f"adapter carries weights this merge does not cover "
            f"(supported targets: {sorted(_TARGETS)}): "
            f"{unmatched[:5]}{'...' if len(unmatched) > 5 else ''}")
    for (layer, module), mats in sorted(pairs.items()):
        if "A" not in mats or "B" not in mats:
            raise ValueError(f"adapter incomplete for layer {layer} "
                             f"{module}: needs both lora_A and lora_B")
        rank = mats["A"].shape[0]
        if mats["B"].shape[1] != rank:
            raise ValueError(
                f"layer {layer} {module}: lora_A rank {rank} != "
                f"lora_B rank {mats['B'].shape[1]}")
        if rank != cfg_rank:
            raise ValueError(
                f"layer {layer} {module}: tensor rank {rank} != "
                f"adapter_config r={cfg_rank}")
    if not pairs:
        raise ValueError(f"no LoRA weights recognized in {adapter_dir}")
    scaling = alpha / (cfg_rank ** 0.5 if rslora else cfg_rank)
    return pairs, cfg_rank, alpha, scaling


# multi-LoRA factor layout per target: flattened contraction width K
# and output width N of the stacked leaf ([L, r, K] A / [L, r, N] B)
def _target_dims(cfg) -> Dict[str, tuple]:
    D, H, K, Dh, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    return {
        "wq": (D, H * Dh), "wk": (D, K * Dh), "wv": (D, K * Dh),
        "wo": (H * Dh, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }


def load_adapter_matrices(adapter_dir: str, cfg,
                          rank_pad: int) -> Dict[str, tuple]:
    """PEFT dir -> {leaf: (A [L, rank_pad, K], B [L, rank_pad, N])}
    float32, scaling folded into B, zero rows pad rank to `rank_pad`
    (zero factors = no delta, so padding and untouched layers are
    exact no-ops)."""
    pairs, rank, _alpha, scaling = _read_adapter(adapter_dir)
    if rank > rank_pad:
        raise ValueError(f"adapter rank {rank} exceeds the engine's "
                         f"LoRA slot rank {rank_pad} "
                         f"(--lora-rank at startup)")
    L = cfg.num_layers
    dims = _target_dims(cfg)
    out: Dict[str, list] = {}
    for (layer, module), mats in sorted(pairs.items()):
        leaf, _ = _TARGETS[module]
        if leaf not in dims:
            raise ValueError(f"unknown adapter target {module}")
        if layer >= L:
            raise ValueError(f"adapter layer {layer} out of range "
                             f"(model has {L})")
        Kd, Nd = dims[leaf]
        if mats["A"].shape[1] != Kd or mats["B"].shape[0] != Nd:
            raise ValueError(
                f"layer {layer} {module}: adapter dims "
                f"{mats['B'].shape[0]}x{mats['A'].shape[1]} != model "
                f"{Nd}x{Kd}")
        if leaf not in out:
            out[leaf] = [np.zeros((L, rank_pad, Kd), np.float32),
                         np.zeros((L, rank_pad, Nd), np.float32)]
        out[leaf][0][layer, :rank] = mats["A"]
        out[leaf][1][layer, :rank] = scaling * mats["B"].T
    return {k: (a, b) for k, (a, b) in out.items()}


def merge_lora(params: Dict[str, Any], cfg, adapter_dir: str,
               shard=None) -> int:
    """Fold the adapter into `params` in place (numpy leaves, or torch
    tensors on their device, before quantization). `shard` = (rank, tp):
    `params` holds a tensor-parallel rank's slices (torch leaves), and
    each delta is cut to the same slice first (`parallel/sharding.py`).

    Returns the number of (layer, module) pairs merged. Raises on rank
    mismatches or targets the model doesn't have.
    """
    pairs, rank, alpha, scaling = _read_adapter(adapter_dir)

    merged = 0
    layers = params["layers"]
    writable: set = set()  # stacked leaves copied once, not per layer
    for (layer, module), mats in sorted(pairs.items()):
        leaf_name, reshape = _TARGETS[module]
        if leaf_name not in layers:
            raise ValueError(f"model has no {leaf_name} for adapter "
                             f"target {module}")
        delta = scaling * (mats["B"] @ mats["A"])  # [out, in]
        leaf = layers[leaf_name]
        if isinstance(leaf, torch.Tensor):
            # [out, in] goes over as it is; the layout change runs on
            # the leaf's device (the same values, without a host copy)
            d = reshape(torch.from_numpy(delta).to(leaf.device), cfg)
            if shard is not None and shard[1] > 1:
                from ..parallel.sharding import (leaf_spec, shard_slice,
                                                 tp_dim)
                dim = tp_dim(leaf_spec("layers", leaf_name))
                d = shard_slice(d, None if dim is None else dim - 1,
                                shard[0], shard[1], leaf_name)
            leaf[layer] = (leaf[layer].float() + d).to(leaf.dtype)
        else:
            if leaf_name not in writable:
                layers[leaf_name] = leaf = np.array(leaf)
                writable.add(leaf_name)
            leaf[layer] = (np.asarray(leaf[layer], np.float32)
                           + reshape(delta, cfg)).astype(leaf.dtype)
        merged += 1
    if merged == 0:
        raise ValueError(f"no LoRA weights recognized in {adapter_dir}")
    log.info("merged %d LoRA deltas (r=%d, alpha=%s) from %s",
             merged, rank, alpha, adapter_dir)
    return merged
