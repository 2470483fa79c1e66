"""Rank layout of a tensor-parallel group (port of ome_tpu/parallel/mesh.py).

The reference builds a `jax.sharding.Mesh` over the (dp, pp, tp) axes and
lets XLA insert the collectives. The port runs one process per rank, the
torch idiom: `MeshConfig` (with `auto` and `AXES`) is copied as it is,
and in place of `build_mesh` a `RankInfo` says where this process sits
in the tp group: its global rank, its index on its own host, its device
and the collectives backend the group runs on.

Rank devices: rank r takes `cuda:<local rank>`; an explicit
`--device cuda:i` puts every local rank on that card. The backend is
gloo on the CPU and where the caller knows that ranks share a card
(NCCL refuses two ranks on one device: serve's single-host `--tp N
--device cuda:i`, or `--tp-backend gloo`), and NCCL otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

AXES = ("dp", "pp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    tp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp

    @classmethod
    def auto(cls, n_devices: int, num_layers: int = 0,
             want_pp: bool = True) -> "MeshConfig":
        """Factor n_devices into (dp, pp, tp), preferring tp then pp.

        tp gets the innermost (fastest link) axis; pp only if the layer
        count divides; remaining devices go to dp.
        """
        n = n_devices
        tp = 2 if n % 2 == 0 else 1
        if n % 4 == 0 and n >= 16:
            tp = 4  # bigger groups: widen tp on the innermost axis
        rem = n // tp
        pp = 1
        if want_pp and rem % 2 == 0 and (num_layers == 0
                                         or num_layers % 2 == 0):
            pp = 2
        dp = rem // pp
        return cls(dp=dp, pp=pp, tp=tp)


@dataclass(frozen=True)
class RankInfo:
    """This process's place in a tp group of `tp` ranks."""

    tp: int
    rank: int               # global rank; 0 is the leader
    local_rank: int         # index among the ranks on this host
    device: torch.device
    backend: str            # "nccl" or "gloo"

    @property
    def is_leader(self) -> bool:
        return self.rank == 0


def rank_device(device: Optional[Union[str, torch.device]],
                local_rank: int) -> torch.device:
    """The device of local rank `local_rank`: `cuda:<local rank>` for a
    bare "cuda" (or None), the named card for every local rank when
    `device` names one (`cuda:i`), the CPU for "cpu". A card that is
    not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    idx = local_rank if dev.index is None else dev.index
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass --device cpu to run on the CPU")
    n = torch.cuda.device_count()
    if idx >= n:
        raise RuntimeError(
            f"local rank {local_rank} needs cuda:{idx}, but this host has "
            f"{n} card(s); name one card (--device cuda:0) to put every "
            "local rank on it")
    return torch.device("cuda", idx)


def choose_backend(device: Optional[Union[str, torch.device]],
                   shared_card: bool = False) -> str:
    """gloo on the CPU and for ranks that share one card; NCCL for
    ranks on cards otherwise."""
    dev = torch.device("cuda" if device is None else device)
    return "gloo" if dev.type == "cpu" or shared_card else "nccl"


def describe(tp: int, rank: int, local_rank: int,
             device: Optional[Union[str, torch.device]],
             backend: Optional[str] = None) -> RankInfo:
    """RankInfo of global rank `rank` (local index `local_rank`) in a
    group of `tp` ranks served on `device` (serve's --device), on
    `backend` (default `choose_backend(device)`)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a group of {tp}")
    return RankInfo(tp=tp, rank=rank, local_rank=local_rank,
                    device=rank_device(device, local_rank),
                    backend=backend or choose_backend(device))
