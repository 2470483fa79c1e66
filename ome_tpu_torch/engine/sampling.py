"""Token sampling with per-slot parameters (port of ome_tpu/engine/sampling.py).

Each decode step samples one token per batch slot; temperature, top-k
and top-p are [B] tensors, so one call serves every request in the
batch without a host round trip. Randomness comes from an explicit
`torch.Generator` on the logits' device (it replaces the reference's
`jax.random` key); the same seed gives the same draws, but not the
draws `jax.random` would give.

Sort, top-k and top-p stay plain tensor ops, as they were XLA ops in the
reference.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def filtered_logits(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits: the distribution
    `sample` draws from. logits [B, V]; params [B]. Filtered-out entries
    are NEG_INF; greedy rows (temperature <= 0) pass through at
    temperature 1. Returns [B, V] float32."""
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device
    temperature = temperature.to(dev)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature)).float()[:, None]
    scaled = logits / safe_t
    # one descending order; both filters are rank-based prefix masks.
    # Ascending stable sort then reversed, as the reference's
    # argsort(...)[:, ::-1]: among equal logits the higher index ranks
    # first, exactly as there
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(scaled, 1, order)
    ranks = torch.arange(V, device=dev)[None, :]
    top_k = top_k.to(dev)[:, None]
    keep_k = torch.where(top_k > 0, ranks < top_k,
                         torch.ones_like(ranks, dtype=torch.bool))
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(probs_sorted, dim=-1)
    keep_p = (cumulative - probs_sorted) < top_p.to(dev)[:, None]
    keep_sorted = keep_k & keep_p  # rank 0 always survives both
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor) -> torch.Tensor:
    """Next tokens: logits [B, V]; temperature/top_k/top_p [B]
    (temperature <= 0 greedy; top_k <= 0 and top_p >= 1 disable their
    filters). Categorical draws use the Gumbel-max trick with uniforms
    from `generator`. Returns [B] int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = filtered_logits(logits, temperature, top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator,
                   device=scaled.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature.to(logits.device) > 0, sampled, greedy)
