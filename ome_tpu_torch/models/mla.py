"""Multi-head Latent Attention (port of ome_tpu/models/mla.py), in part.

For now this module holds only its own copy of the reference's
`yarn_frequencies`, which the yarn RoPE scaling of the dense families
(gpt-oss) reads through `llama.rope_frequencies`. MLA attention itself
(DeepSeek-V2/V3, Kimi-K2: the per-token latent cache, the absorbed
decode path, their routers and shared experts) is not ported yet;
`params.check_supported` refuses it by name until then.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from .config import ModelConfig


def yarn_frequencies(cfg: ModelConfig, d: int,
                     device: Union[str, torch.device] = "cpu"
                     ) -> Tuple[torch.Tensor, float]:
    """Rope inverse frequencies [d / 2] fp32 and the cos/sin attention
    factor (reference `yarn_frequencies`).

    Plain RoPE unless cfg.rope_scaling is yarn; then the published yarn
    recipe: interpolation below the beta_slow boundary, extrapolation
    above beta_fast, a linear ramp between, and the mscale attention
    factor (transformers' `_compute_yarn_parameters`)."""
    half = d // 2
    pos_freqs = cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=device) * 2 / d)
    inv_freq = 1.0 / pos_freqs
    rs = cfg.rope_scaling or {}
    if rs.get("rope_type", rs.get("type")) != "yarn":
        return inv_freq, 1.0
    factor = rs.get("factor", 1.0)
    beta_fast = rs.get("beta_fast") or 32
    beta_slow = rs.get("beta_slow") or 1
    orig = (rs.get("original_max_position_embeddings")
            or cfg.max_seq_len)

    def correction_dim(n_rot):
        return (d * math.log(orig / (n_rot * 2 * math.pi))
                / (2 * math.log(cfg.rope_theta)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = inv_freq / factor * ramp + inv_freq * (1.0 - ramp)

    def get_mscale(scale, m=1.0):
        return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

    att = rs.get("attention_factor")
    if att is None:
        mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")
        if mscale and mscale_all:
            att = get_mscale(factor, mscale) / get_mscale(factor,
                                                          mscale_all)
        else:
            att = get_mscale(factor)
    return inv_freq, float(att)
