"""Multi-head Latent Attention (port of ome_tpu/models/mla.py):
DeepSeek-V2, DeepSeek-V2-Lite, DeepSeek-V3 and Kimi-K2.

* The KV cache stores per-token LATENTS, the `kv_a_proj` output
  (kv_lora_rank values) and the one shared rope key (qk_rope_head_dim),
  as one cache "head" of kv_lora_rank + rope values; the v plane is
  zero-width (`ModelConfig.kv_cache_v_dim` is 0). DeepSeek-V3 caches 576
  values per token and layer where per-head K/V would take 128 x 2 x 192.
* Decode (one row per sequence over a cache) runs the ABSORBED path:
  q_nope goes through w_uk into latent space once per step, the scores
  and the weighted sum run against the latent cache, and w_uv lifts the
  result back per head; no K/V is materialized.
* Prefill, and any step of more than one row (a speculative verify),
  materializes per-head K/V from the latents with two products and runs
  a masked softmax attention over them.

The reference computes MLA attention as plain jnp, not as a Pallas
kernel, so this module is plain torch products that follow its
arithmetic step for step (dtypes and rounding points included); MLA
launches none of the attention kernels. `yarn_frequencies` also serves
the yarn RoPE scaling of the dense families (gpt-oss) through
`llama.rope_frequencies`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from ..parallel import comm
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
    return inv_freq, yarn_attention_factor(cfg)


def yarn_attention_factor(cfg: ModelConfig) -> float:
    """yarn's mscale factor on cos and sin (1.0 for any other RoPE): the
    host-side half of `yarn_frequencies`, for a caller that already
    holds the frequencies."""
    rs = cfg.rope_scaling or {}
    if rs.get("rope_type", rs.get("type")) != "yarn":
        return 1.0
    factor = rs.get("factor", 1.0)

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
    return float(att)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                     cfg: ModelConfig,
                     freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate interleaved pairs (x[2j], x[2j+1]) by pos * inv_freq_j,
    with yarn's frequencies and attention factor where configured; fp32
    inside, x's dtype out (reference `rope_interleaved`). `freqs`: the
    model's `yarn_frequencies` table for x's last dim, made once per
    model (`llama.rope_frequencies`); computed here when None.

    x: [B, S, N, D] (N 1 for the shared rope key). The output is laid
    out [rotated evens | rotated odds], as the reference emits it: the
    scores do not depend on the pair order as long as q and k agree,
    and the cached latents' rope half holds this layout, so the cache
    bytes equal the reference's."""
    if freqs is None:
        freqs = yarn_frequencies(cfg, x.shape[-1], x.device)[0]
    att = yarn_attention_factor(cfg)
    angles = positions[..., None].float() * freqs            # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :] * att
    sin = torch.sin(angles)[:, :, None, :] * att
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                     dim=-1).to(x.dtype)


def _masked_softmax(scores: torch.Tensor, q_pos: torch.Tensor,
                    k_pos: torch.Tensor,
                    kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """scores [B, H, S, T]; causal (and kv-length) masking with -1e30 in
    the scores' dtype, then the softmax in fp32 (reference
    `_masked_softmax`)."""
    mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]
    if kv_len is not None:
        mask = mask & (k_pos[None, None, None, :]
                       < kv_len[:, None, None, None])
    scores = scores.masked_fill(~mask, -1e30)
    return torch.softmax(scores.float(), dim=-1)


def mla_attention(h: torch.Tensor, lp, cfg: ModelConfig,
                  positions: torch.Tensor,
                  kv_len: Optional[torch.Tensor],
                  cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                  cache_index,
                  freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MLA attention block on the pre-normed input h [B, S, D]
    (reference `mla_attention`). With a cache, the new latent rows
    [B, S, 1, r + rope] are written into its k plane [B, S_max, 1,
    r + rope] in place at `cache_index` (an int, or [B] per-slot
    positions), and attention spans the whole cache length T masked by
    `kv_len`; the v plane is zero-width and untouched. `freqs`: the
    rope dims' frequencies (`rope_interleaved`). Returns the attention
    output [B, S, D]."""
    from .llama import _w, _write_rows, rms_norm
    B, S, _ = h.shape
    nope = cfg.qk_nope_head_dim
    r = cfg.kv_lora_rank
    dt = cfg.dtype

    # -- queries -------------------------------------------------------
    # (under tp in training the inputs of the head-split products take
    # `comm.copy_to_tp`, so that their gradients add over the ranks)
    if cfg.q_lora_rank:
        ql = torch.einsum("bsd,dr->bsr", h, _w(lp["wq_a"], dt))
        ql = rms_norm(ql, lp["q_a_norm"], cfg.rms_norm_eps)
        q = torch.einsum("bsr,rhk->bshk", comm.copy_to_tp(ql),
                         _w(lp["wq_b"], dt))
    else:
        q = torch.einsum("bsd,dhk->bshk", comm.copy_to_tp(h),
                         _w(lp["wq"], dt))
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = rope_interleaved(q_pe, positions, cfg, freqs)

    # -- latent K/V ----------------------------------------------------
    ckv = torch.einsum("bsd,dr->bsr", h, _w(lp["wkv_a"], dt))
    c, k_pe = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, lp["kv_a_norm"], cfg.rms_norm_eps)
    k_pe = rope_interleaved(k_pe[:, :, None, :], positions, cfg,
                            freqs)[:, :, 0]
    latent = torch.cat([c, k_pe], dim=-1)[:, :, None, :]

    if cache_kv is not None:
        ck = cache_kv[0]
        _write_rows(ck, latent, cache_index)
        full = ck[:, :, 0]                            # [B, T, r + rope]
        k_pos = torch.arange(full.shape[1], dtype=torch.int32,
                             device=h.device)
    else:
        full = latent[:, :, 0]                        # [B, S, r + rope]
        k_pos = None
    full = comm.copy_to_tp(full)
    c_all, kpe_all = full[..., :r], full[..., r:]
    scale = cfg.mla_scale

    if S == 1 and cache_kv is not None:
        # -- absorbed decode: never leave latent space -----------------
        q_lat = torch.einsum("bshn,hnr->bshr", q_nope, _w(lp["w_uk"], dt))
        scores = (torch.einsum("bshr,btr->bhst", q_lat, c_all)
                  + torch.einsum("bshp,btp->bhst", q_pe, kpe_all)) * scale
        attn = _masked_softmax(scores, positions, k_pos, kv_len)
        out_lat = torch.einsum("bhst,btr->bshr", attn.to(c_all.dtype),
                               c_all)
        attn_out = torch.einsum("bshr,hrv->bshv", out_lat,
                                _w(lp["w_uv"], dt))
    else:
        # -- materialize per-head K/V from the latents -----------------
        k_nope = torch.einsum("btr,hnr->bthn", c_all, _w(lp["w_uk"], dt))
        v = torch.einsum("btr,hrv->bthv", c_all, _w(lp["w_uv"], dt))
        k = torch.cat([k_nope, kpe_all[:, :, None, :].expand(
            *k_nope.shape[:3], kpe_all.shape[-1]).to(k_nope.dtype)],
            dim=-1)
        qf = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
        scores = torch.einsum("bshk,bthk->bhst", qf, k) * scale
        # no cache: plain causal over the chunk's own positions
        attn = _masked_softmax(scores, positions,
                               positions[0] if k_pos is None else k_pos,
                               kv_len)
        attn_out = torch.einsum("bhst,bthv->bshv", attn.to(v.dtype), v)
    # under tp a rank holds H/tp heads (wq/wq_b, w_uk, w_uv, wo) and the
    # whole latent cache: its heads' output is partial, summed over ranks
    return comm.reduce_sum(torch.einsum("bshv,hvd->bsd", attn_out,
                                        _w(lp["wo"], dt)))
