"""Ring attention: context parallelism for long sequences (port of
ome_tpu/parallel/ring_attention.py).

The sequence is split over a group of n ranks: rank i keeps its query
rows [i S/n, (i + 1) S/n) and the K/V shards rotate around the ring
(the reference's lax.ppermute; here send to rank i + 1 and receive from
rank i - 1), each block merged into a flash-style online softmax in
fp32, so no rank holds the [S, S] logits. n - 1 rotations, and the last
block merges without a final one (a last rotation would ship every K/V
shard once for nothing). Causality rides absolute positions: block j's
key positions against the local query positions, no [S, S] mask.

The reference's block attend is jnp, so plain torch is its counterpart
here; no kernel is asked for.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import comm

M_INIT = -1.0e30


def _block_attend(q, k, v, q_pos, kv_pos, scale, softcap):
    """One (local Q x rotated KV) block: masked logits and their softmax
    statistics. q: [B, Sq, K, G, D]; k/v: [B, Sk, K, D]. Returns
    (m, l, acc): m/l [B, K, G, Sq, 1] fp32, acc [B, K, G, Sq, D] fp32."""
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    valid = (kv_pos[None, :] <= q_pos[:, None])[None, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, M_INIT))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    # p stays fp32 with fp32 accumulation: one bf16 rounding per ring
    # step would compound over long sequences
    acc = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    return m, l, acc


def _rotate(group: comm.Group, t: torch.Tensor) -> torch.Tensor:
    """`t` to rank i + 1, rank i - 1's in its place."""
    n, i = group.size, group.rank
    return group.sendrecv(t, (i + 1) % n, torch.empty_like(t), (i - 1) % n)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[comm.Group] = None,
                   scale: Optional[float] = None,
                   logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Causal GQA attention with the sequence split over `group`.

    q: [B, S/n, H, D]; k, v: [B, S/n, K, D]: this rank's rows. Returns
    this rank's rows [B, S/n, H, D] of full causal attention over the
    whole sequence. None: one rank, the whole sequence."""
    B, sl, H, D = q.shape
    K = k.shape[2]
    G = H // K
    n = group.size if group is not None else 1
    idx = group.rank if group is not None else 0
    scale_ = scale if scale is not None else D ** -0.5
    q5 = q.reshape(B, sl, K, G, D)
    ar = torch.arange(sl, dtype=torch.int32, device=q.device)
    q_pos = idx * sl + ar
    m = torch.full((B, K, G, sl, 1), M_INIT, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, K, G, sl, D), dtype=torch.float32,
                      device=q.device)

    def merge(m, l, acc, kv_idx, k, v):
        bm, bl, bacc = _block_attend(q5, k, v, q_pos, kv_idx * sl + ar,
                                     scale_, logit_softcap)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        return m_new, alpha * l + beta * bl, alpha * acc + beta * bacc

    kv_idx = idx
    for _ in range(n - 1):
        m, l, acc = merge(m, l, acc, kv_idx, k, v)
        k, v = _rotate(group, k.contiguous()), _rotate(group, v.contiguous())
        kv_idx = (kv_idx - 1) % n
    m, l, acc = merge(m, l, acc, kv_idx, k, v)
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, sl, H, D).to(q.dtype)
