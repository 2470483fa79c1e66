"""Flash attention for Hopper: decode (B1) and causal prefill (B2).

Counterpart of ome_tpu/ops/flash.py. The TPU package wrote these two
kernels in Pallas; here each is CUDA C++ written by hand for `sm_90a`
(`ops/csrc/`), built by `ops/_build.py` at first use and called through
ctypes on PyTorch's current stream.

* `flash_decode` replaces `_flash_decode` / `_decode_kernel`
  (ome_tpu/ops/flash.py:65-204). Bound on the H100: the bytes of the
  K/V rows in [lo, hi) read from device memory. The kernel reads only
  those rows, once per KV head for all G query heads, in 32-row tiles
  copied with cp.async, and splits each window across several blocks
  (flash-decoding) with a merge pass, so a small decode batch still
  spreads over the SMs (`csrc/flash_decode.cu`).
* `flash_prefill` replaces `_flash_prefill` / `_prefill_kernel` /
  `_prefill_block_range` (ome_tpu/ops/flash.py:261-386). Bound on the
  H100: tensor-core operations of the causal QK^T and PV products. The
  bf16 kernel runs both on the tensor cores (mma.sync m16n8k16, fp32
  accumulation) with Q and O held in registers, folds the G heads of a
  KV head into one tile's rows so K/V tiles are staged once for all of
  them, and walks only the KV tiles the causal frontier, kv_hi and the
  window allow (`csrc/flash_prefill.cu`).

Beside each kernel sits its plain PyTorch version (`flash_decode_ref`,
`flash_prefill_ref`). A wrapper uses the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises —
there is no fallback. `LAUNCHES` counts the kernel launches of each
wrapper, so a run can show that its main path went through the
kernels.

Nothing is built or imported from the CUDA toolchain when this module
is imported.
"""

from __future__ import annotations

from typing import Optional

import torch

M_INIT = -1.0e30  # finite lowest running max: exp(x - M_INIT) underflows to 0

# kernel launches per wrapper; incremented only where a kernel launches
LAUNCHES = {"flash_decode": 0, "flash_prefill": 0}

_DIMS = (64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain versions ---------------------------------------------------------


def _masked_softmax_attention(q, k, v, valid, scale, softcap):
    """Shared plain math of both kernels, in fp32: q [B, Sq, H, D],
    k/v [B, S, K, D], valid [B, Sq, S] bool. Online-softmax semantics
    of the kernels: finite M_INIT, probabilities of masked columns set
    to exactly 0, l clamped at 1e-30 (an empty window gives 0)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask = valid[:, None, None, :, :]
    logits = torch.where(mask, logits, torch.full_like(logits, M_INIT))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p / l, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_decode_ref(q, k, v, lo, hi, scale: float,
                     softcap: Optional[float] = None):
    """Plain PyTorch version of the decode kernel: q [B, 1, H, D];
    k, v [B, S, K, D]; each sequence b attends rows [lo[b], hi[b])."""
    S = k.shape[1]
    col = torch.arange(S, device=k.device)
    valid = ((col[None, :] >= lo.to(k.device)[:, None])
             & (col[None, :] < hi.to(k.device)[:, None]))[:, None, :]
    return _masked_softmax_attention(q, k, v, valid, scale, softcap)


def flash_prefill_ref(q, k, v, base, kv_hi, scale: float,
                      softcap: Optional[float] = None,
                      window: Optional[int] = None):
    """Plain PyTorch version of the prefill kernel: q [B, Sq, H, D] with
    query row i of sequence b at position base[b] + i; k, v [B, S, K, D];
    columns c <= base + i, c < kv_hi and (window) c > base + i - window."""
    Sq, S = q.shape[1], k.shape[1]
    dev = k.device
    col = torch.arange(S, device=dev)[None, None, :]
    pos = (base.to(dev)[:, None]
           + torch.arange(Sq, device=dev)[None, :])[:, :, None]
    valid = (col <= pos) & (col < kv_hi.to(dev)[:, None, None])
    if window:
        valid = valid & (col > pos - window)
    return _masked_softmax_attention(q, k, v, valid, scale, softcap)


# -- kernel wrappers ---------------------------------------------------------


def _check_cuda(name: str, q, k, v) -> None:
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype}, q is "
                             f"{q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes bf16 or fp32, got {q.dtype}")
    D = q.shape[-1]
    if D not in _DIMS or k.shape[-1] != D:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes head_dim 64 or 128, got {D}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _int32(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def decode_splits(S: int) -> int:
    """KV splits per (sequence, KV head): one per 256 rows the cache can
    hold, at most 16. A window shorter than the cache uses only the
    splits it needs (the kernel cuts windows into whole 32-row tiles),
    so a long sequence is spread over many blocks and a short one over
    few."""
    return max(1, min(16, -(-S // 256)))


def flash_decode(q, k, v, lo, hi, scale: float,
                 softcap: Optional[float] = None):
    """Decode attention (Sq == 1): q [B, 1, H, D]; k, v [B, S, K, D];
    lo, hi [B] — sequence b attends cache rows [lo[b], hi[b]).
    Returns [B, 1, H, D] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_ref(q, k, v, lo, hi, scale, softcap)
    _check_cuda("flash_decode", q, k, v)
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if Sq != 1 or H % K or H // K not in (1, 2, 4, 8, 16):
        raise NotImplementedError(
            f"flash_decode: needs Sq == 1 and H/K in (1, 2, 4, 8, 16), "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    from . import _build
    fn = _build.kernel("flash_decode")
    dev = q.device
    lo, hi = _int32(lo, dev), _int32(hi, dev)
    n_split = decode_splits(S)
    part_m = torch.empty(B * H * n_split, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * n_split * D, dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), B, S, H, K, D,
            n_split, float(scale), float(softcap or 0.0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["flash_decode"] += 1
    return out


def flash_prefill(q, k, v, base, kv_hi, scale: float,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None):
    """Causal prefill: q [B, Sq, H, D] with row i of sequence b at
    position base[b] + i; k, v [B, S, K, D] with kv_hi[b] valid rows.
    Returns [B, Sq, H, D] in q.dtype."""
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, base, kv_hi, scale, softcap,
                                 window)
    _check_cuda("flash_prefill", q, k, v)
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if H % K or 64 % (H // K):
        raise NotImplementedError(
            f"flash_prefill: needs H/K dividing 64, got H={H}, K={K}")
    from . import _build
    fn = _build.kernel("flash_prefill")
    dev = q.device
    base, kv_hi = _int32(base, dev), _int32(kv_hi, dev)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), base.data_ptr(),
            kv_hi.data_ptr(), out.data_ptr(), B, Sq, S, H, K, D,
            float(scale), float(softcap or 0.0), int(window or 0),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_prefill: kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["flash_prefill"] += 1
    return out


# -- public entry ----------------------------------------------------------


def flash_attention(q, k, v, *, positions, kv_len=None,
                    sliding_window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None):
    """Causal attention through the kernels (counterpart of
    ome_tpu/ops/flash.py::flash_attention). q: [B, Sq, H, D];
    k, v: [B, Skv, K, D]; positions: [B, Sq] absolute query positions,
    contiguous per row; kv_len: [B] valid KV rows (None = all)."""
    B, Sq, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    if kv_len is None:
        kv_hi = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        kv_hi = torch.broadcast_to(kv_len.to(device=dev,
                                              dtype=torch.int32), (B,))
        kv_hi = kv_hi.clamp(max=S)
    base = positions[:, 0].to(torch.int32)
    if Sq == 1:
        hi = torch.minimum(base + 1, kv_hi)
        lo = (base - sliding_window + 1).clamp(min=0) if sliding_window \
            else torch.zeros_like(base)
        return flash_decode(q, k, v, lo, hi, scale, logit_softcap)
    return flash_prefill(q, k, v, base, kv_hi, scale, logit_softcap,
                         sliding_window)

