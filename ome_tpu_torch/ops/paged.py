"""Paged (block) KV-cache attention for the engine's decode (B3).

Counterpart of ome_tpu/ops/paged.py. KV lives in a POOL of fixed-size
blocks `[N, bs, K, D]` shared by all decode slots; each slot owns a
chain of blocks listed in its row of a BLOCK TABLE `[B, M]` (int32 pool
block ids; block 0 is the reserved trash block). int8 pools carry f32
per-(row, head) scales `[N, K, bs]`, S-minor as
`flash.quantize_kv_block` lays them out.

* `paged_flash_decode` replaces the Pallas kernel `paged_flash_decode`
  / `_paged_kernel` (ome_tpu/ops/paged.py:142-229) with the hand-written
  CUDA kernel `csrc/flash_paged_decode.cu`: B1's decode math with the
  tile's source block read from the table, in a bf16/fp32 branch and an
  int8 branch that folds the scales into the logits and probabilities.
  Bound on the H100: the bytes of the K/V rows in [0, kv_len) (and
  their scales). `flash_paged_decode_ref` is its plain version.
* `paged_attention_xla` is the reference's gather-and-mask path, the
  plain version the CPU runs.
* `paged_attention` dispatches: a CUDA tensor goes to the kernel (an
  uncovered shape raises), a CPU tensor to `paged_attention_xla`.

The multi-query verify path (`paged_attention_multi`) belongs to the
speculative step plans and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import (M_INIT, _masked_softmax_attention, dequantize,
                    paged_decode_launch)


def _gather_dequant(pool: torch.Tensor, scale_pool: Optional[torch.Tensor],
                    table: torch.Tensor) -> torch.Tensor:
    """Gather each slot's block chain into a contiguous f32 view:
    [B, M, bs, K, D] -> [B, M*bs, K, D]. int8 pools multiply their
    scales [N, K, bs], gathered by the same table, back in."""
    B, M = table.shape
    bs = pool.shape[1]
    idx = table.to(device=pool.device, dtype=torch.long)
    g = pool[idx]                                     # [B, M, bs, K, D]
    if scale_pool is not None:
        g = dequantize(g, scale_pool[idx])            # scales [B, M, K, bs]
    return g.float().reshape(B, M * bs, pool.shape[2], -1)


def paged_attention_xla(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, table: torch.Tensor,
                        kv_len: torch.Tensor,
                        scale: Optional[float] = None,
                        logit_softcap: Optional[float] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Reference paged decode attention (gather + masked softmax).

    q: [B, 1, H, D]; pools: [N, bs, K, D]; table: [B, M] int32;
    kv_len: [B] valid rows per slot. int8 pools pass their scale
    planes ([N, K, bs] f32). Returns [B, 1, H, D] in q.dtype."""
    B, _, H, D = q.shape
    _, bs, K, _ = k_pool.shape
    M = table.shape[1]
    scale = scale if scale is not None else D ** -0.5
    kg = _gather_dequant(k_pool, k_scale, table)
    vg = _gather_dequant(v_pool, v_scale, table)
    G = H // K
    qh = q.reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(), kg) * scale
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    col = torch.arange(M * bs, dtype=torch.int32, device=q.device)
    valid = (col[None, :] < kv_len.to(device=q.device,
                                      dtype=torch.int32)[:, None])
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, M_INIT))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(valid, p, torch.zeros_like(p))
    out = torch.einsum("bkgs,bskd->bkgd", p, vg)
    return out.reshape(B, 1, H, D).to(q.dtype)


def flash_paged_decode_ref(q, k_pool, v_pool, table, lo, hi, scale: float,
                           softcap: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version of the paged decode kernel, in fp32 with the
    kernel's online-softmax semantics (`flash.flash_decode_ref`): q
    [B, 1, H, D]; pools [N, bs, K, D] (int8 with scales [N, K, bs]);
    sequence b attends its rows [lo[b], hi[b]) — an empty window gives
    0. Returns [B, 1, H, D] in q.dtype."""
    kg = _gather_dequant(k_pool, k_scale, table)
    vg = _gather_dequant(v_pool, v_scale, table)
    S = kg.shape[1]
    col = torch.arange(S, device=kg.device)
    valid = ((col[None, :] >= lo.to(kg.device)[:, None])
             & (col[None, :] < hi.to(kg.device)[:, None]))[:, None, :]
    return _masked_softmax_attention(q, kg, vg, valid, scale, softcap)


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       kv_len: torch.Tensor,
                       scale: Optional[float] = None,
                       logit_softcap: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel (counted as
    LAUNCHES["flash_paged_decode"]): slot b attends its sequence rows
    [0, kv_len[b]). On a CPU tensor, the kernel's plain version."""
    D = q.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    hi = kv_len.to(device=q.device, dtype=torch.int32)
    lo = torch.zeros_like(hi)
    if not q.is_cuda:
        return flash_paged_decode_ref(q, k_pool, v_pool, table, lo, hi,
                                      scale, logit_softcap,
                                      k_scale=k_scale, v_scale=v_scale)
    return paged_decode_launch("flash_paged_decode", q, k_pool, v_pool,
                               table, lo, hi, scale, logit_softcap,
                               k_scale=k_scale, v_scale=v_scale)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    kv_len: torch.Tensor,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching entry (the reference's `paged_attention` contract):
    the CUDA kernel for a CUDA tensor, `paged_attention_xla` for a CPU
    tensor. int8 pools pass k_scale/v_scale."""
    if q.is_cuda:
        return paged_flash_decode(q, k_pool, v_pool, table, kv_len, scale,
                                  logit_softcap, k_scale=k_scale,
                                  v_scale=v_scale)
    return paged_attention_xla(q, k_pool, v_pool, table, kv_len, scale,
                               logit_softcap, k_scale=k_scale,
                               v_scale=v_scale)
