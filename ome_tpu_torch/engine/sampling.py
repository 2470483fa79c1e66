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
    sampled = _categorical(scaled, generator)
    return torch.where(temperature.to(logits.device) > 0, sampled, greedy)


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row of `logits` [..., V] (unnormalized log
    probabilities) by the Gumbel-max trick, with uniforms from
    `generator`. Returns [...] int32."""
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def spec_verify(logits: torch.Tensor, drafts: torch.Tensor,
                draft_len: torch.Tensor, generator: torch.Generator,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor):
    """Batched draft verification (Leviathan et al. 2023), the
    reference's `spec_verify` with its `jax.random` key replaced by
    `generator`.

    One verify forward scored S = k+1 positions per slot: position 0
    follows the committed last token, position i (1 <= i <= k) follows
    draft token i-1. logits [B, S, V]; drafts [B, k] int32; draft_len
    [B] in [0, k] (0: the slot did not draft, and the step is a plain
    decode for it); temperature/top_k/top_p [B].

    Greedy slots accept d_i iff it equals the argmax at position i,
    exactly. Temperature > 0 slots accept d_i with probability p_i(d_i)
    under the filtered target distribution (the one `sample` draws
    from) and on rejection resample from p_i with d_i removed, which
    preserves the target distribution.

    Returns (out_tokens [B, S] int32, accepted [B] int32): slot b emits
    out_tokens[b, :accepted[b]+1]; out_tokens[b, accepted[b]] is its
    new last token."""
    logits = logits.float()
    B, S, V = logits.shape
    k = S - 1
    dev = logits.device
    temperature = temperature.to(dev)
    drafts = drafts.to(device=dev, dtype=torch.long)
    draft_len = draft_len.to(device=dev)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, S]
    filt = filtered_logits(
        logits.reshape(B * S, V), temperature.repeat_interleave(S),
        top_k.to(dev).repeat_interleave(S),
        top_p.to(dev).repeat_interleave(S)).reshape(B, S, V)
    probs = torch.softmax(filt, dim=-1)

    pos = torch.arange(k, device=dev)[None, :]
    in_draft = pos < draft_len[:, None]
    # per-position accept decisions, then the longest accepted prefix
    draft_p = torch.gather(probs[:, :k], 2, drafts[..., None])[..., 0]
    u = torch.rand((B, k), generator=generator, device=dev,
                   dtype=torch.float32)
    accept = torch.where(temperature[:, None] > 0, u < draft_p,
                         drafts == greedy[:, :k])
    run = torch.cumprod((accept & in_draft).to(torch.int32), dim=1)
    accepted = run.sum(dim=1).to(torch.int32)  # [B] in [0, k]

    # the token emitted at the stop position: on rejection at i, the
    # residual sample (p_i with d_i removed); on full acceptance
    # (stop == draft_len), a plain sample from p_stop
    is_draft_tok = (torch.arange(V, device=dev)[None, None, :]
                    == drafts[..., None])
    resid_tok = _categorical(
        torch.where(is_draft_tok, torch.full_like(filt[:, :k], NEG_INF),
                    filt[:, :k]), generator)                 # [B, k]
    bonus_tok = _categorical(filt, generator)                # [B, S]
    stop_tok = torch.cat([
        torch.where(pos == draft_len[:, None], bonus_tok[:, :k],
                    resid_tok),
        bonus_tok[:, k:]], dim=1)                            # [B, S]
    # greedy slots emit argmax(raw logits) at the stop position either
    # way: on rejection the masked argmax equals the unmasked one
    stop_tok = torch.where(temperature[:, None] > 0, stop_tok, greedy)

    next_tok = torch.gather(stop_tok, 1, accepted.long()[:, None])
    drafts_pad = torch.cat([drafts.to(torch.int32),
                            torch.zeros((B, 1), dtype=torch.int32,
                                        device=dev)], dim=1)  # [B, S]
    j = torch.arange(S, device=dev)[None, :]
    acc = accepted[:, None]
    out = torch.where(j < acc, drafts_pad,
                      torch.where(j == acc, next_tok,
                                  torch.zeros_like(drafts_pad)))
    return out.to(torch.int32), accepted
