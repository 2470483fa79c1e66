"""Attention entry point of the port (counterpart of ome_tpu/ops/attention.py).

`attention()` is the single entry point the model calls. Its interface
is structural — query positions, valid-KV length, sliding window —
never a materialized mask:

* on a CUDA tensor, causal attention goes to the hand-written kernels
  (`ops/flash.py`): Sq == 1 to the decode kernel, Sq > 1 to the prefill
  kernel, whatever the prompt length (the reference's TPU-tuned switch
  to XLA for short prefills is not carried over; where such a switch
  belongs on the H100 is for a measurement to decide). Non-causal
  attention is not on the served path and raises.
* attention with sinks (gpt-oss) goes to the same kernels on the card,
  which add each head's sink logit to its softmax; the reference sends
  sinks to its XLA path on every backend (ome_tpu/ops/attention.py:
  104-105), since its Pallas kernels take none.
* on a CPU tensor, `xla_attention` — the plain version, copied from the
  reference — runs with a boolean mask built from the same limits.

Both compute GQA attention with fp32 softmax accumulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash

NEG_INF = -2.0e38


def make_causal_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask [B, Sq, Skv]: True = attend.

    q_pos: [B, Sq] absolute positions of queries; kv_pos: [Skv] absolute
    positions of kv slots; kv_len: optional [B] valid kv slots."""
    m = kv_pos[None, None, :] <= q_pos[:, :, None]
    if kv_len is not None:
        m = m & (kv_pos[None, None, :] < kv_len[:, None, None])
    return m


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None,
                  sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain GQA attention (the reference's XLA path).

    q: [B, Sq, H, D]; k, v: [B, Skv, K, D] with H % K == 0.
    mask: [B, Sq, Skv] boolean (True = attend) or None.
    sinks: [H] per-head sink logits: a virtual extra key whose
    probability mass is dropped after the softmax.
    Returns [B, Sq, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * scale
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits,
                             torch.full_like(logits, NEG_INF))
    if sinks is not None:
        s = sinks.float().reshape(K, G)
        col = s[None, :, :, None, None].expand(B, K, G, Sq, 1)
        probs = torch.softmax(torch.cat([logits, col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None,
              sliding_window: Optional[int] = None,
              scale: Optional[float] = None,
              logit_softcap: Optional[float] = None,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching attention entry point used by the model.

    positions: [B, Sq] absolute query positions (contiguous per row);
    None disables causal masking (bidirectional attention).
    kv_len: [B] valid KV rows for fixed-capacity caches.
    sinks: [H] attention-sink logits (gpt-oss) or None."""
    if q.is_cuda:
        if positions is None:
            raise NotImplementedError(
                "non-causal attention has no CUDA kernel in the port yet")
        return flash.flash_attention(
            q, k, v, positions=positions, kv_len=kv_len,
            sliding_window=sliding_window, scale=scale,
            logit_softcap=logit_softcap, sinks=sinks)
    mask = None
    dev = q.device
    if positions is not None:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
        mask = make_causal_mask(positions, kv_pos, kv_len)
        if sliding_window is not None:
            mask = mask & (kv_pos[None, None, :]
                           > positions[:, :, None] - sliding_window)
    elif kv_len is not None:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
        mask = (kv_pos[None, None, :] < kv_len[:, None, None]).expand(
            q.shape[0], q.shape[1], k.shape[1])
    return xla_attention(q, k, v, mask=mask, scale=scale,
                         logit_softcap=logit_softcap, sinks=sinks)
