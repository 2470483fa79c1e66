"""Expert-parallel ragged MoE over a group of ranks (port of
ome_tpu/parallel/moe.py).

The dense MoE path under tp computes every local expert for every
token (models/llama.py::moe_mlp_dense). This is the ragged EP path:
each rank holds E/ep experts and runs grouped products only over the
(token, expert) pairs routed to its experts, with one sum over the
group to combine the contributions (the reference's psum in a
shard_map; the XLA analog of an all-to-all dispatch).

Routing is computed on every rank (one [T, E] product), so there is no
dispatch collective: non-local pairs go to local expert 0 with weight
0, and the sum counts every pair once, on its owner. The grouped
products are `torch._grouped_mm` on the card in bf16 and `grouped_ref`
elsewhere (`llama._grouped`), as the single-device ragged dispatch
runs them. The router and the SiLU gate are the reference's: a top-k
softmax over the picked logits (Mixtral's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models import llama
from ..models.config import ModelConfig
from . import comm


def moe_mlp_ragged_ep(x: torch.Tensor, lp, cfg: ModelConfig,
                      group: Optional[comm.Group] = None) -> torch.Tensor:
    """x: [B, S, D], the same on every rank; lp: one layer's params with
    we_* holding this rank's E/ep experts (rank r: experts
    [r E/ep, (r + 1) E/ep)); `group` the ep ranks (None: one rank with
    every expert). Returns [B, S, D], the same on every rank."""
    ep = group.size if group is not None else 1
    rank = group.rank if group is not None else 0
    E = cfg.num_experts
    assert E % ep == 0, f"experts {E} must divide over ep={ep}"
    local_e = lp["we_gate"].shape[0]
    lo = rank * local_e
    B, S, D = x.shape
    k = cfg.experts_per_token
    T = B * S
    logits = torch.einsum("bsd,de->bse", x, lp["router"]).float()
    weights, idx = llama._top_k(logits, k)
    weights = torch.softmax(weights, dim=-1)
    ids = idx.reshape(T * k)
    w = weights.reshape(T * k)
    mine = (ids >= lo) & (ids < lo + local_e)
    local_ids = torch.where(mine, ids - lo, torch.zeros_like(ids))
    w = torch.where(mine, w, torch.zeros_like(w))
    order = torch.argsort(local_ids, stable=True)
    token_of = order // k
    sorted_ids = local_ids[order]
    xs = x.reshape(T, D)[token_of]
    offs = torch.bincount(local_ids, minlength=local_e).cumsum(0).to(
        torch.int32)
    gate = llama._grouped(xs, lp["we_gate"], sorted_ids, offs)
    up = llama._grouped(xs, lp["we_up"], sorted_ids, offs)
    out_sorted = llama._grouped(F.silu(gate) * up, lp["we_down"],
                                sorted_ids, offs)
    contrib = out_sorted * w[order][:, None].to(out_sorted.dtype)
    out = torch.zeros((T, D), dtype=contrib.dtype,
                      device=x.device).index_add(0, token_of, contrib)
    with comm.use(group):
        out = comm.reduce_sum(out)
    return out.reshape(B, S, D).to(x.dtype)
