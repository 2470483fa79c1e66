"""Int4 weight-only matmul for Hopper (B4); port of
ome_tpu/ops/int4_matmul.py.

`int4_matmul(x, qt, out_dtype)` computes y[..., N] = x[..., K] @
dequant(qt) for a half-packed int4 QTensor (`models/quant.py`): packed
bytes qp2 [K/2, N] (byte j: row j in the low nibble, row K/2+j in the
high nibble) and f32 group scales s2 [K/G, N]. Its semantics are the
TPU kernel's: x rounded to bf16; each weight as (f32 nibble x f32
scale) rounded to bf16; products accumulated in fp32; the sum cast to
`out_dtype`.

* On a CUDA tensor it launches the hand-written kernel
  `ops/csrc/int4_matmul.cu`, which replaces `_mm4` / `_kernel`
  (ome_tpu/ops/int4_matmul.py:85-156). Bound on the H100: the packed
  bytes and scales read from device memory (a decode batch does ~4m
  flops per packed byte, far below the tensor cores' ~295 flops/byte).
  The kernel streams the packed tiles and their scale rows into shared
  memory with cp.async, unpacks and scales in registers, and runs
  bf16 mma.sync with fp32 accumulation; the K axis is split across
  blocks so that a small N still fills the SMs, and the partial sums
  are reduced in a fixed order by a second pass (no atomics: the same
  inputs give the same bits).
* On a CPU tensor it runs `int4_matmul_ref`, the plain version.
* A CUDA tensor of a shape the kernel does not take raises; the
  caller (`models/llama._proj`) asks `int4_eligible` first, which is
  the reference's dispatch rule written as a predicate and the
  kernel's coverage at once.

Nothing is built or imported from the CUDA toolchain when this module
is imported.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from .flash import LAUNCHES

MAX_M = 256   # flattened batch rows the kernel takes (decode, short prefill)
_BN = 512     # the reference's column block; its divisibility rule stays
_TILE_N = 128  # columns per CUDA block
_TILE_KP = 32  # packed rows per CUDA pipeline step


def _geometry(qt) -> Optional[Tuple[int, int, int]]:
    """(K, N, G) of a packed leaf whose dims before the pack axis all
    have size 1 (the half-packed layout is contiguous in the flattened
    contraction only when the pack axis is outermost); None otherwise."""
    if getattr(qt, "bits", 8) != 4:
        return None
    q, s = qt.q, qt.s
    a = qt.axis % q.dim()
    if math.prod(q.shape[:a]) != 1:
        return None
    kp = q.shape[a]
    n = math.prod(q.shape[a + 1:])
    n_groups = s.shape[a]
    gsize = 2 * kp // n_groups
    if gsize < 2 or gsize % 2:
        return None
    try:
        torch.broadcast_shapes(tuple(s.shape),
                               tuple(q.shape[:a]) + (n_groups,)
                               + tuple(q.shape[a + 1:]))
    except RuntimeError:
        return None
    return 2 * kp, n, gsize


def flatten_qtensor(qt):
    """(qp2 [K/2, N], s2 [K/G, N], K, N, G): 2D views of a packed leaf
    whose pre-pack dims are all size 1; None if it does not flatten."""
    geo = _geometry(qt)
    if geo is None:
        return None
    k, n, gsize = geo
    q, s = qt.q, qt.s
    a = qt.axis % q.dim()
    n_groups = k // gsize
    s_full = torch.broadcast_to(s, tuple(q.shape[:a]) + (n_groups,)
                                + tuple(q.shape[a + 1:]))
    return q.reshape(k // 2, n), s_full.reshape(n_groups, n), k, n, gsize


def int4_eligible(x_shape, qt) -> bool:
    """The reference's dispatch rule (ome_tpu/ops/int4_matmul.py:
    200-234) as a pure predicate, and the CUDA kernel's coverage:
    bits 4, pack axis outermost, G even and >= 2, K/2 a multiple of G
    (through the block rule), N split by min(512, N) into a multiple of
    128, at most MAX_M flattened rows, and x's last dim equal to K."""
    geo = _geometry(qt)
    if geo is None:
        return False
    k, n, gsize = geo
    if x_shape[-1] != k:
        return False
    bkp = 8 * gsize
    if (k // 2) % bkp:
        bkp = k // 2
        if bkp % gsize:
            return False
    bn = min(_BN, n)
    if n % bn or bn % 128:
        return False
    return math.prod(x_shape[:-1]) <= MAX_M


def int4_matmul_ref(x: torch.Tensor, qt, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x rounded to bf16, the
    weight as (f32 nibble x f32 scale) rounded to bf16, the product in
    fp32, cast to out_dtype."""
    flat = flatten_qtensor(qt)
    if flat is None:
        raise ValueError("int4_matmul: not a half-packed int4 leaf with "
                         "its pack axis outermost (see flatten_qtensor)")
    qp2, s2, k, n, gsize = flat
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16).float()
    q32 = qp2.to(torch.int32)
    w = torch.cat([(q32 << 28) >> 28, q32 >> 4], dim=0).float()
    wb = (w * s2.float().repeat_interleave(gsize, dim=0)).to(
        torch.bfloat16).float()
    return (x2 @ wb).to(out_dtype).reshape(*lead, n)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(n_blocks: int, steps: int, device) -> Tuple[int, int]:
    """(splits, steps per split) of the K axis: enough blocks for about
    four per SM (the unpack is latency-bound at decode sizes, so more
    resident warps hide more of it), whole pipeline steps per split."""
    want = max(1, min(steps, -(-4 * _sm_count(device) // n_blocks)))
    per = -(-steps // want)
    return -(-steps // per), per


def int4_matmul(x: torch.Tensor, qt, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(qt) in `out_dtype`: the CUDA
    kernel for a CUDA tensor (counted as LAUNCHES["int4_matmul"]; a
    shape outside `int4_eligible` raises), the plain version for a CPU
    tensor."""
    if not x.is_cuda:
        return int4_matmul_ref(x, qt, out_dtype)
    if not int4_eligible(tuple(x.shape), qt):
        raise NotImplementedError(
            f"int4_matmul: the CUDA kernel does not take x "
            f"{tuple(x.shape)} against a packed leaf q "
            f"{tuple(qt.q.shape)}, s {tuple(qt.s.shape)}, axis "
            f"{qt.axis} (see int4_eligible)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"int4_matmul: the CUDA kernel writes bf16 or fp32, got "
            f"{out_dtype}")
    qp2, s2, k, n, gsize = flatten_qtensor(qt)
    dev = x.device
    qp2, s2 = qp2.contiguous(), s2.float().contiguous()
    for t, what in ((qp2, "packed weight"), (s2, "scales")):
        if t.device != dev:
            raise ValueError(f"int4_matmul: {what} on {t.device}, x on "
                             f"{dev}")
        if t.data_ptr() % 16:  # the kernel copies 16-byte chunks
            raise ValueError(f"int4_matmul: {what} is not 16-byte "
                             f"aligned")
    lead = x.shape[:-1]
    m = math.prod(lead)
    x2 = x.reshape(m, k).to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 4:  # a view at an odd offset: the kernel reads pairs
        x2 = x2.clone()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    block_m = 16 if m <= 16 else 64
    steps = -(-(k // 2) // _TILE_KP)
    n_blocks = (n // _TILE_N) * -(-m // block_m)
    splits, per = _splits(n_blocks, steps, dev)
    part = torch.empty((splits, m, n) if splits > 1 else (1,),
                       dtype=torch.float32, device=dev)
    from . import _build
    fn = _build.kernel("int4_matmul")
    rc = fn(x2.data_ptr(), qp2.data_ptr(), s2.data_ptr(), out.data_ptr(),
            part.data_ptr(), m, k, n, gsize, splits, per, block_m,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["int4_matmul"] += 1
    return out.reshape(*lead, n)
