"""GPipe pipeline parallelism (port of ome_tpu/parallel/pipeline.py).

The reference reshapes the layer stack to [pp, L/pp, ...], shards the
stage dim over the "pp" mesh axis, and rotates a state buffer
[pp, mb, S, D] one stage per tick with jnp.roll, which XLA lowers to a
collective-permute; jax.grad derives the reverse schedule. The port
keeps both forms of that schedule:

  * `pipeline_forward` / `pipeline_loss_fn` over stage-stacked params
    in one process, as the reference runs with `mesh=None`: M + pp - 1
    ticks, each stage applied to the microbatch it holds (a stage that
    holds none during the fill and the drain is skipped: the
    reference's zeros there are never read). autograd differentiates
    it whole.
  * `StageSchedule`, the schedule `train/step.py` runs under pp > 1
    with one process per stage (torch idiom, no GSPMD): each pp rank
    holds only its stage's layers; activations go forward and their
    gradients come back over `send`/`recv`; all microbatches' forwards
    run first, then their backwards in reverse order, as GPipe does.
    Stage 0 embeds; the last stage applies the final norm, the head,
    the softcap and the loss.

The reference's "sp" sequence sharding of the state between stages
(`logical(..., "tp", ...)` on the sequence dim) is a memory layout of
GSPMD only, and is not carried over: a stage sends its whole
[mb, S, D] activation (ROADMAP Queue A).

The reference's refusals stand in its words and exception types
(`check_pipeline`), and Gemma 2's alternating windows run as its
layer-pair body does (even layer the sliding window, odd layer global).
The head is the model's own (`llama._final_logits`: its final norm, head
bias, logit scale and softcap); the reference's pipeline applies an
RMSNorm and the softcap only, which is the same for every model the
tests run through it (RMSNorm, no head bias, no logit scale).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models import llama
from ..models.config import ModelConfig

Params = Dict[str, Any]


def check_pipeline(cfg: ModelConfig, pp: int) -> None:
    """The reference's refusals (ome_tpu/parallel/pipeline.py:44-63)."""
    if cfg.is_moe and cfg.first_k_dense:
        raise NotImplementedError(
            "pipeline_forward needs structurally uniform stages; "
            "first_k_dense (DeepSeek) models mix dense and MoE layers "
            "— serve them via tp (engine/sharded.py) instead")
    if cfg.alt_sliding_window and (cfg.sliding_pattern != 2
                                   or cfg.rope_skip_global):
        raise NotImplementedError(
            "pipeline_forward implements the P=2 alternating pattern "
            "only; serve sliding_pattern!=2 / NoPE models via tp "
            "(engine/sharded.py)")
    if cfg.alt_sliding_window and (cfg.num_layers // pp) % 2 != 0:
        raise ValueError(
            "alternating-sliding-window (gemma2) pipeline stages must "
            f"hold an even layer count; {cfg.num_layers} layers / "
            f"pp={pp} gives {cfg.num_layers // pp}")


def positions_of(mb: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        mb, S)


def stage_forward(layers: Params, cfg: ModelConfig, h: torch.Tensor,
                  freqs: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """One stage's layers ([n, ...] stacked leaves) over h [mb, S, D]:
    each layer under the model's window, or Gemma 2's pairs (reference
    `stage_fn`: the even layer of a pair under the sliding window, the
    odd one global)."""
    n = llama._block_depth(layers)
    for i in range(n):
        window = cfg.sliding_window
        if cfg.alt_sliding_window and i % 2:
            window = None
        h = llama._layer(h, llama._layer_params(layers, i), cfg, freqs,
                         positions, None, None, None, None, window, True)
    return h


def embed(params: Params, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    """Stage 0's input: the embedding rows (Gemma's normalizer too)."""
    return llama._embed_scaled(params, cfg, tokens)


def head_logits(params: Params, cfg: ModelConfig,
                h: torch.Tensor) -> torch.Tensor:
    """The last stage's fp32 logits [mb, S, vocab]."""
    return llama._final_logits(params, cfg, h)


def nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The sum of -log softmax(logits)[target] over every position."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def _stage(layers: Params, s: int) -> Params:
    return {k: v[s] for k, v in layers.items()}


def pipeline_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                     pp: int, num_microbatches: int) -> torch.Tensor:
    """Forward pass through a pp-staged pipeline in one process.

    params: layer leaves stage-stacked [pp, L/pp, ...]
    (`sharding.stack_to_stages`). tokens: [B, S] with
    B % num_microbatches == 0. Returns logits [B, S, vocab] (fp32)."""
    B, S = tokens.shape
    M = num_microbatches
    assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
    check_pipeline(cfg, pp)
    mb = B // M
    dev = tokens.device
    x = embed(params, cfg, tokens).reshape(M, mb, S, -1)
    freqs = llama.rope_frequencies(cfg, dev)
    positions = positions_of(mb, S, dev)
    layers = params["layers"]
    # state[s]: (microbatch index, activation) stage s holds, or None
    state: List[Optional[tuple]] = [None] * pp
    out: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + pp - 1):
        state = [(t, x[t]) if t < M else None] + state[:-1]
        state = [None if held is None else
                 (held[0], stage_forward(_stage(layers, s), cfg, held[1],
                                         freqs, positions))
                 for s, held in enumerate(state)]
        if state[pp - 1] is not None:
            m, h = state[pp - 1]
            out[m] = h
    h = torch.stack(out).reshape(B, S, -1)
    return head_logits(params, cfg, h)


def pipeline_loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                     targets: torch.Tensor, pp: int,
                     num_microbatches: int) -> torch.Tensor:
    """Mean next-token NLL of `pipeline_forward`'s logits."""
    logits = pipeline_forward(params, cfg, tokens, pp, num_microbatches)
    return nll_sum(logits, targets) / targets.numel()


class StageSchedule:
    """GPipe with one process per stage: this rank is stage `index` of
    `pp`, linked to its neighbours by `link` (a `comm.Group` of the pp
    ranks with the same dp and tp coordinates, rank = stage). `params`
    holds this stage's leaves: its `layers` [L/pp, ...], `embed` on
    stage 0 (and on the last stage when the head is tied), the final
    norm and `lm_head` on the last stage. Model collectives of a tp
    group run under `comm.use(...)` around `run`, by the caller."""

    def __init__(self, cfg: ModelConfig, index: int, pp: int, link=None):
        self.cfg, self.index, self.pp, self.link = cfg, index, pp, link

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.pp - 1

    def run(self, params: Params, tokens: List[torch.Tensor],
            targets: List[torch.Tensor], n_tokens: int) -> torch.Tensor:
        """Forward every microbatch (tokens / targets [mb, S] each), then
        backward them in reverse, accumulating into the params' .grad.
        The loss of a microbatch is its NLL sum over `n_tokens` (the
        global batch's positions). A stage that is both first and last
        (pp = 1) runs each microbatch's backward right after its forward,
        so that one microbatch's activations are live at a time. Returns
        the sum of this rank's losses on the last stage, 0 elsewhere
        (detached)."""
        cfg = self.cfg
        mb, S = tokens[0].shape
        dev = tokens[0].device
        freqs = llama.rope_frequencies(cfg, dev)
        positions = positions_of(mb, S, dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        saved = []
        for m in range(len(tokens)):
            if self.first:
                x = embed(params, cfg, tokens[m])
            else:
                x = torch.empty(mb, S, cfg.hidden_size, dtype=cfg.dtype,
                                device=dev)
                self.link.recv(x, self.index - 1)
                x.requires_grad_()
            h = stage_forward(params["layers"], cfg, x, freqs, positions)
            if self.last:
                h = nll_sum(head_logits(params, cfg, h), targets[m]) \
                    / n_tokens
            else:
                self.link.send(h.detach(), self.index + 1)
            if self.first and self.last:
                h.backward()
                total = total + h.detach()
            else:
                saved.append((x, h))
        for x, h in reversed(saved):
            if self.last:
                h.backward()
                total = total + h.detach()
            else:
                g = torch.empty_like(h)
                self.link.recv(g, self.index + 1)
                h.backward(g)
            if not self.first:
                self.link.send(x.grad, self.index - 1)
        return total
