"""Device resolution for the port's entry points.

Every entry point takes an explicit device. The default is CUDA; the
CPU is used only when the caller names it (the tests do). Asking for
CUDA on a machine without a usable card raises: nothing carries on
silently on the CPU.

`to_host` and `to_device` move KV between the card and host memory (the
prefix cache's host tier, PD and peering blobs) on a side stream of the
calling thread, through pinned memory, waiting on that copy alone, so
the copy neither waits for nor delays the decode steps queued on the
default stream.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

_SIDE = threading.local()

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` (default "cuda") as a torch.device, checked usable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def side_stream(device: torch.device):
    """This thread's side stream on `device`: the admission thread's
    spills, the swap thread's uploads and an HTTP handler's gathers do
    not queue behind one another."""
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    if device.index not in streams:
        streams[device.index] = torch.cuda.Stream(device)
    return streams[device.index]


def to_host(x: torch.Tensor, after=None) -> torch.Tensor:
    """`x` in host memory, complete on return. A CUDA tensor is copied on
    this thread's side stream into pinned memory once `after` (a CUDA
    event; default: one recorded now on the current stream, behind what
    produced `x`) has fired, and nothing queued later; a CPU tensor is
    cloned."""
    if not x.is_cuda:
        return x.clone()
    if after is None:
        after = torch.cuda.Event()
        after.record()
    stream = side_stream(x.device)
    stream.wait_event(after)
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        out.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    return out


def to_device(x: torch.Tensor, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host tensor on `device` (in `dtype`), complete on return. On a
    card the copy runs on this thread's side stream from pinned memory,
    and the result is marked as used by the default stream, where the
    engine reads it (so freeing it cannot hand its memory to another
    tensor while a kernel there still reads it)."""
    dtype = dtype or x.dtype
    if device.type != "cuda":
        return x.to(device=device, dtype=dtype)
    stream = side_stream(device)
    with torch.cuda.stream(stream):
        src = x if x.is_pinned() else x.pin_memory()
        out = src.to(device, non_blocking=True).to(dtype)
    out.record_stream(torch.cuda.default_stream(device))
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    return out
