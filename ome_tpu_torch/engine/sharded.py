"""Tensor-parallel serving engine (port of ome_tpu/engine/sharded.py).

The reference shards the weights and the KV cache over a mesh's "tp"
axis and lets GSPMD insert the collectives; its host-side scheduler code
is unchanged. The port runs one process per rank, each with its own
`ShardedInferenceEngine`:

  * weights shard Megatron-style (attention heads / MLP hidden / vocab
    / experts on tp — `parallel/sharding.py` rules): a rank holds its
    slices only (`shard_params`, or `init_params(shard=...)` and the
    checkpoint loader, which never make the whole tree);
  * the KV cache holds the rank's K/tp KV heads, so decode attention
    needs no collective: B1 and B2 run on each rank at H/tp query heads
    over K/tp KV heads, the group size G unchanged. MLA's latent cache
    (one latent "head") is whole on every rank;
  * the model's collectives (`parallel/comm.py`, under `comm.use(the
    rank's group)` around every op) sum the partial outputs after the
    attention output projection and the MLP, look the tokens up in the
    vocab-sharded embedding and gather the vocab-sharded logits, so
    every rank sees the same logits;
  * the tokens a rank samples are replaced by rank 0's (a broadcast of
    the [B] ids after each sampling), so every rank feeds the same token
    into its cache at any temperature.

Paged KV, the host prefix tier and multi-LoRA are refused under tp > 1,
as the reference's serve refuses them; the prefix cache is allowed.
int4 leaves are column slices on a rank (K whole), so each rank runs B4
on its own slices. The reference turns its int4 kernel off under tp
(`_no_int4_kernel`) because GSPMD cannot partition a Pallas call; a
rank here multiplies local slices, where that does not arise. The MoE
runs the dense impl (the ragged dispatch is single-device, as in the
reference).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..models.config import ModelConfig
from ..parallel import comm
from .core import InferenceEngine


def check_divisible(cfg: ModelConfig, tp: int) -> None:
    """The reference's divisibility checks, in its words."""
    if not cfg.mla and cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} "
            f"(KV cache shards on the head dim)")
    if cfg.num_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads}")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The shapes one rank computes: H/tp query heads and K/tp KV heads
    (MLA: the latent cache stays one head), the dense MoE impl. The
    vocabulary and the expert count stay global: logits are gathered
    whole, and the router scores every expert."""
    if tp == 1:
        return cfg
    kw = dict(num_heads=cfg.num_heads // tp)
    if not cfg.mla:
        kw["num_kv_heads"] = cfg.num_kv_heads // tp
    if cfg.is_moe:
        kw["moe_impl"] = "dense"
    return cfg.replace(**kw)


def tp_refusal(tp: int, lora_slots, kv_block, kv_int8,
               host_tier) -> str:
    """What the reference's serve refuses at tp > 1, in its words (the
    first that applies), or "": named adapters (the stacks are not
    sharded), paged KV, the int8 pool and the host prefix tier."""
    if tp <= 1:
        return ""
    if lora_slots:
        return ("multi-LoRA serving is single-host tp=1 for now (adapter "
                "stacks are unsharded); use a merged --adapter dir with "
                "tp>1")
    if kv_block:
        return ("--kv-block/--kv-blocks (paged KV) is single-host tp=1 "
                "for now (the sharded engine keeps the dense per-slot "
                "cache); drop the flags with tp>1")
    if kv_int8:
        return ("--kv-dtype int8 quantizes the paged block pool, which is "
                "single-host tp=1 for now; drop the flag with tp>1")
    if host_tier:
        return ("--prefix-cache-host-mb (host-DRAM prefix tier) is "
                "single-host tp=1 for now; drop the flag with tp>1")
    return ""


class ShardedInferenceEngine(InferenceEngine):
    """InferenceEngine over one rank's slices of the params and the KV
    cache, in a tp group (`group`, a `comm.Group` of `tp` ranks).

    `params` is this rank's slices (`sharding.shard_params`, or
    `init_params(shard=...)` and the checkpoint loader, which never make
    the whole tree). `cfg` is the model's; `self.cfg` is this rank's (`local_config`) and
    `self.model_cfg` the model's. Its `ledger` (one per rank) describes
    this rank's programs: its slices' bytes and FLOPs."""

    def __init__(self, params, cfg: ModelConfig, tp: int = 1,
                 max_slots: int = 8, max_seq: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 group: Optional[comm.Group] = None, rank: int = 0,
                 prefix_cache_bytes: int = 0,
                 lora_slots: int = 0, lora_rank: int = 16,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, ledger=None, **kw):
        check_divisible(cfg, tp)
        if group is not None:
            if group.size != tp:
                raise ValueError(f"tp={tp} but the group has {group.size} "
                                 "ranks")
            rank = group.rank
        elif tp > 1:
            raise ValueError(f"tp={tp} needs the ranks' group (comm.Group)")
        why = tp_refusal(tp, lora_slots, kw.get("kv_block"), False,
                         kw.get("prefix_host_bytes"))
        if why:
            raise ValueError(why)
        self.tp = tp
        self.rank = rank
        self.group = group
        self.model_cfg = cfg
        super().__init__(params, local_config(cfg, tp), max_slots=max_slots,
                         max_seq=max_seq, prefill_buckets=prefill_buckets,
                         prefix_cache_bytes=prefix_cache_bytes,
                         device=device, seed=seed, lora_slots=lora_slots,
                         lora_rank=lora_rank, ledger=ledger, **kw)

    def _ctx(self):
        """An op's context: the group's collectives."""
        return comm.use(self.group)

    # -- sampling: rank 0's ids on every rank -------------------------

    def _sample(self, logits, temperature, top_k, top_p) -> torch.Tensor:
        # every rank draws (its generator advances as rank 0's does),
        # then takes rank 0's ids: the same token enters every cache
        return comm.broadcast(super()._sample(logits, temperature, top_k,
                                              top_p))

    def _spec_verify(self, logits, drafts, draft_len, temperature, top_k,
                     top_p):
        out, acc = super()._spec_verify(logits, drafts, draft_len,
                                        temperature, top_k, top_p)
        return comm.broadcast(out), comm.broadcast(acc)

    # -- ops ----------------------------------------------------------

    def prefill(self, *a, **kw):
        with self._ctx():
            return super().prefill(*a, **kw)

    def insert(self, *a, **kw):
        with self._ctx():
            return super().insert(*a, **kw)

    def decode(self, *a, **kw):
        with self._ctx():
            return super().decode(*a, **kw)

    def decode_multi(self, *a, **kw):
        with self._ctx():
            return super().decode_multi(*a, **kw)

    def verify(self, *a, **kw):
        with self._ctx():
            return super().verify(*a, **kw)

    # -- KV that crosses the group's edge (PD) ------------------------

    def device_kv(self, kv):
        """A prefill's (k, v) on the device; host planes of the whole
        model (a fetched PD blob: all K KV heads) keep this rank's
        heads. MLA's one latent head is whole on every rank."""
        K, k_local = self.model_cfg.num_kv_heads, self.cfg.num_kv_heads
        if self.tp > 1 and not self.cfg.mla:
            lo = self.rank * k_local
            kv = tuple(x[:, :, :, lo:lo + k_local] if x.shape[3] == K
                       else x for x in kv)
        return super().device_kv(kv)

    def gather_kv(self, x: torch.Tensor) -> torch.Tensor:
        """A prefill KV plane [L, 1, S, K/tp, D] of this rank, whole
        ([L, 1, S, K, D], every rank's heads) on the host: a collective
        every rank joins (the leader's PD export, the followers'
        `pd_export` replay). MLA's latent plane is whole already."""
        from .pd import gather_kv
        if self.tp > 1 and not self.cfg.mla:
            with comm.use(self.group):
                x = comm.gather_dim(x, 3)
        return gather_kv(x)
