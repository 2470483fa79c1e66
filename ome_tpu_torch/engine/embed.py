"""Embedding engine: decoder-based text embeddings (e5-mistral style).

Port of ome_tpu/engine/embed.py. Serves decoder-architecture embedding
models (MistralModel / Qwen2Model / Qwen3Model checkpoints: e5-mistral,
gte-Qwen2): run the decoder over the prompt, pool the LAST real token's
final hidden state in fp32, L2-normalize. Requests batch per length
bucket into one forward per bucket, stateless (no KV cache kept).

The forward is the generation model's own `_layer` over right-padded
[N, S] tokens with positions from 0 and no cache: each layer's
attention is one causal prefill at batch N, so on a card one launch of
the prefill kernel (B2) per layer; the padding sits after each row's
last real token, where causality keeps it out of every pooled row.

An input's embedding does not depend on the other inputs of its batch
when cuBLAS runs without a workspace (no split-K, whose reduction order
follows the row count): `serve`'s main sets
`CUBLAS_WORKSPACE_CONFIG=:0:0` before the process's first product, and
`serve.build_server` refuses `--task embed` on a card without it. With
a workspace, batched and lone bf16 embeddings of short inputs differed
by up to 1.5e-3 in cosine at 32 random layers on an H100 (PERF.md §6).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.params import Params
from ..ops.flash import check_model_head_dim


def forward_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  true_len: torch.Tensor,
                  freqs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] tokens (right-padded), [B] real lengths -> [B, D] fp32
    unit-norm embeddings."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, dtype=torch.int32,
                             device=dev)[None, :].expand(B, S)
    if freqs is None:
        freqs = llama.rope_frequencies(cfg, dev)
    x = llama._embed_scaled(params, cfg, tokens)
    # the `layers` block alone, as the reference's embedding scan runs
    # it: a DeepSeek model's leading `dense_layers` are skipped there and
    # here (ROADMAP Queue C)
    layers = params["layers"]
    windows = llama.layer_windows(cfg)
    for i in range(llama._block_depth(layers)):
        x = llama._layer(x, llama._layer_params(layers, i), cfg, freqs,
                         positions, None, None, None, None, *windows[i])
    x = llama.block_norm(x, params, "final_norm", cfg)
    # last REAL token pools the sequence (decoder embedding convention)
    rows = torch.arange(B, device=dev)
    pooled = x[rows, true_len.to(dev).long() - 1].float()
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


class EmbeddingEngine:
    """Bucketed batch embedding over one model on one device (CUDA
    unless the caller names the CPU)."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 max_seq: Optional[int] = None,
                 buckets: Optional[List[int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        check_model_head_dim(cfg, self.device)
        self.cfg = cfg
        self.model = llama.Llama(cfg, params).to(self.device)
        self.max_seq = max_seq or min(cfg.max_seq_len, 8192)
        if buckets is None:
            buckets, b = [], 32
            while b < self.max_seq:
                buckets.append(b)
                b *= 4
            buckets.append(self.max_seq)
        self.buckets = buckets

    def bucket_of(self, n: int) -> int:
        return next((b for b in self.buckets if n <= b), self.buckets[-1])

    @torch.no_grad()
    def embed(self, prompts_ids: List[List[int]]) -> np.ndarray:
        """Embed token-id lists -> [N, D] float32.

        Inputs group by length bucket (truncated to max_seq) and run as
        ONE [N_bucket, bucket] forward per bucket."""
        for ids in prompts_ids:
            if not ids:
                raise ValueError("cannot embed an empty input")
        out = np.zeros((len(prompts_ids), self.cfg.hidden_size),
                       np.float32)
        groups: dict = {}
        for i, ids in enumerate(prompts_ids):
            ids = list(ids)[:self.max_seq]
            groups.setdefault(self.bucket_of(len(ids)), []).append((i, ids))
        params = self.model.params
        for bucket, members in groups.items():
            padded = torch.tensor(
                [ids + [0] * (bucket - len(ids)) for _, ids in members],
                dtype=torch.int32, device=self.device)
            lens = torch.tensor([len(ids) for _, ids in members],
                                dtype=torch.int32, device=self.device)
            embs = forward_embed(params, self.cfg, padded, lens,
                                 freqs=self.model.freqs).cpu().numpy()
            for (i, _), e in zip(members, embs):
                out[i] = e
        return out
