"""PyTorch/CUDA port of the ome_tpu serving engine.

`ome_tpu_torch` mirrors `ome_tpu`'s module paths and names
(`ome_tpu_torch/ops/flash.py` is the port of `ome_tpu/ops/flash.py`).
It imports torch, numpy and the standard library, and nothing of JAX
or of `ome_tpu`: what it needs from the reference package is copied
here. Entry points run on a CUDA device unless the caller asks for the
CPU (`device="cpu"`, `--device cpu`); every Pallas kernel on the served
path is a CUDA kernel written by hand for Hopper (`ops/csrc/`).

The port covers the default serving path: `engine/serve.py` ->
`engine/server.py` -> `engine/scheduler.py` -> `engine/core.py` ->
`models/llama.py` -> `ops/attention.py` -> `ops/flash.py` ->
`engine/sampling.py`, dense bf16 KV cache, prefix cache on; and the
paged KV cache of `--kv-block` (bf16 or `--kv-dtype int8` pools), whose
decode goes `models/llama.py::forward_paged` -> `ops/paged.py`.

Importing the package imports no torch: the router and the chaos
harness's controller side run without it (`resolve_device` loads
`device.py`, and torch, on first use).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
