"""Flash attention for Hopper: decode (B1), causal prefill (B2) and
decode over an int8 cache (B5).

Counterpart of ome_tpu/ops/flash.py. The TPU package wrote these
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
* `flash_decode_quantized` replaces `flash_decode_quantized` ->
  `_flash_decode(quantized=True)` (ome_tpu/ops/flash.py:221-255): decode
  over a dense int8 cache [B, S, K, D] with f32 scales [B, K, S] from
  `quantize_kv_block`. It runs on the paged decode kernel
  (`csrc/flash_paged_decode.cu`, also B3 in ops/paged.py): the dense
  cache is that kernel's pool of B blocks of S rows, with
  table[b, 0] = b. Bound: the int8 K/V bytes in [lo, hi) plus their
  scales. As in the reference it is not wired into serving.

Beside each kernel sits its plain PyTorch version (`flash_decode_ref`,
`flash_prefill_ref`, `flash_decode_quantized_ref`). A wrapper uses the
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises — there is no fallback. `LAUNCHES` counts
the kernel launches of each wrapper (ops/paged.py's included), so a run
can show that its main path went through the kernels.

Nothing is built or imported from the CUDA toolchain when this module
is imported.
"""

from __future__ import annotations

from typing import Optional

import torch

M_INIT = -1.0e30  # finite lowest running max: exp(x - M_INIT) underflows to 0

# kernel launches per wrapper; incremented only where a kernel launches
LAUNCHES = {"flash_decode": 0, "flash_prefill": 0,
            "flash_paged_decode": 0, "flash_decode_quantized": 0,
            "int4_matmul": 0}

_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8, 16)  # query heads per KV head the decode kernels take
_RECIP_127 = 1.0 / 127.0    # rounded to f32 where it multiplies a f32 tensor


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


def quantize_rows(x: torch.Tensor):
    """Per-(row, head) symmetric int8 over the last (feature) axis:
    x [..., K, D] -> (int8 [..., K, D], f32 scales [..., K]). The
    reference's arithmetic as XLA compiles it inside the engine's
    programs, step for step: amax with a 1e-8 floor times f32(1/127)
    (XLA turns the division by the constant 127 into that product),
    x / s in fp32, round half to even, clip to +-127 — so the bytes and
    scales equal the JAX engine's on the same input."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) * _RECIP_127
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_kv_block(x: torch.Tensor):
    """KV slab [B, S, K, D] -> (int8 values [B, S, K, D], f32 scales
    [B, K, S]): scales stored S-minor, the layout the int8 decode
    kernels read (reference flash.py:207-218)."""
    q, s = quantize_rows(x)
    return q, s.transpose(-1, -2).contiguous()


def dequantize(xq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 rows [..., S, K, D] with S-minor scales [..., K, S] -> f32."""
    return xq.float() * scale.transpose(-1, -2)[..., None]


def flash_decode_quantized_ref(q, kq, vq, k_scale, v_scale, lo, hi,
                               scale: float,
                               softcap: Optional[float] = None):
    """Plain PyTorch version of the int8 decode kernel: the dense
    decode over the dequantized cache. kq, vq [B, S, K, D] int8;
    k_scale, v_scale [B, K, S] f32."""
    return flash_decode_ref(q, dequantize(kq, k_scale),
                            dequantize(vq, v_scale), lo, hi, scale,
                            softcap)


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
    if Sq != 1 or H % K or H // K not in _GROUPS:
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


def check_paged_coverage(block: int, head_dim: int, num_heads: int,
                         num_kv_heads: int) -> None:
    """Raise ValueError unless the paged decode kernel takes this
    shape: pool blocks a multiple of its 32-row tile, head_dim 64 or
    128, and H / K in (1, 2, 4, 8, 16)."""
    G = num_heads // num_kv_heads if num_kv_heads else 0
    if block <= 0 or block % 32 or head_dim not in _DIMS or \
            num_heads % max(num_kv_heads, 1) or G not in _GROUPS:
        raise ValueError(
            f"the CUDA paged decode kernel needs a KV block that is a "
            f"multiple of 32, head_dim 64 or 128 and H/K in "
            f"{_GROUPS} (got kv_block={block}, head_dim={head_dim}, "
            f"heads={num_heads}, kv_heads={num_kv_heads})")


def paged_decode_launch(name: str, q, k_pool, v_pool, table, lo, hi,
                        scale: float, softcap: Optional[float] = None,
                        k_scale=None, v_scale=None):
    """Launch `csrc/flash_paged_decode.cu` (kernels B3 and B5) on CUDA
    tensors and count it under LAUNCHES[name]. q [B, 1, H, D] bf16 or
    fp32; pools [N, bs, K, D] in q's dtype, or int8 with k_scale,
    v_scale [N, K, bs] f32; table [B, M] pool block ids; sequence b
    attends rows [lo[b], hi[b]). Returns [B, 1, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    N, bs, K, _ = k_pool.shape
    quantized = k_pool.dtype == torch.int8
    for t, what in ((k_pool, "k_pool"), (v_pool, "v_pool"),
                    (table, "table")):
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes a bf16 or fp32 query, got "
            f"{q.dtype}")
    if v_pool.dtype != k_pool.dtype or (k_pool.dtype != q.dtype
                                        and not quantized):
        raise ValueError(f"{name}: pools {k_pool.dtype}/{v_pool.dtype} "
                         f"with a {q.dtype} query")
    if v_pool.shape != k_pool.shape or Sq != 1 or table.dim() != 2 \
            or table.shape[0] != B:
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, "
                         f"table {tuple(table.shape)}")
    if k_pool.shape[-1] != D or K == 0 or H % K:
        raise NotImplementedError(
            f"{name}: q {tuple(q.shape)} against pools "
            f"{tuple(k_pool.shape)}")
    check_paged_coverage(bs, D, H, K)
    scales = (k_scale, v_scale)
    if quantized:
        for t, what in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if t is None or t.dtype != torch.float32 or \
                    tuple(t.shape) != (N, K, bs) or t.device != q.device:
                raise ValueError(f"{name}: an int8 pool needs {what} "
                                 f"[{N}, {K}, {bs}] float32 on {q.device}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{name}: scales given for a {k_pool.dtype} pool")
    for t, what in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool")) + (
            tuple(zip(scales, ("k_scale", "v_scale"))) if quantized
            else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    from . import _build
    fn = _build.kernel("flash_paged_decode")
    dev = q.device
    table = _int32(table, dev)
    lo, hi = _int32(lo, dev), _int32(hi, dev)
    M = table.shape[1]
    n_split = decode_splits(M * bs)
    part_m = torch.empty(B * H * n_split, dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty(B * H * n_split * D, dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            table.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, bs, M, H, K, D, n_split, float(scale),
            float(softcap or 0.0), int(q.dtype == torch.bfloat16),
            int(quantized), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
    return out


def _kv_hi(kv_len, B: int, S: int, device) -> torch.Tensor:
    """[B] int32 valid KV rows per sequence (kv_len None = all S)."""
    if kv_len is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    return torch.broadcast_to(kv_len.to(device=device, dtype=torch.int32),
                              (B,)).clamp(max=S)


def _decode_limits(positions, kv_len, S: int, sliding_window):
    """[lo, hi) rows of one decode query per sequence (positions
    [B, 1]): hi = min(pos + 1, kv_len), lo = pos - window + 1 or 0."""
    base = positions[:, 0].to(torch.int32)
    hi = torch.minimum(base + 1,
                       _kv_hi(kv_len, base.shape[0], S, base.device))
    lo = (base - sliding_window + 1).clamp(min=0) if sliding_window \
        else torch.zeros_like(base)
    return lo, hi


def flash_decode_quantized(q, kq, vq, k_scale, v_scale, positions,
                           kv_len=None, sliding_window: Optional[int] = None,
                           scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None):
    """Decode attention over an int8 KV cache (`quantize_kv_block`
    layout). q: [B, 1, H, D]; kq/vq: [B, S, K, D] int8; scales
    [B, K, S] f32; positions [B, 1]. Returns [B, 1, H, D] in q.dtype.
    Not wired into serving, as in the reference."""
    B, Sq, H, D = q.shape
    if Sq != 1:
        raise ValueError(f"flash_decode_quantized: needs Sq == 1, got {Sq}")
    S = kq.shape[1]
    scale = scale if scale is not None else D ** -0.5
    lo, hi = _decode_limits(positions, kv_len, S, sliding_window)
    if not q.is_cuda:
        return flash_decode_quantized_ref(q, kq, vq, k_scale, v_scale, lo,
                                          hi, scale, logit_softcap)
    # the dense cache is a pool of B blocks of S rows, block b = sequence b
    table = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    return paged_decode_launch("flash_decode_quantized", q, kq, vq, table,
                               lo, hi, scale, logit_softcap,
                               k_scale=k_scale, v_scale=v_scale)


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
    if Sq == 1:
        lo, hi = _decode_limits(positions, kv_len, S, sliding_window)
        return flash_decode(q, k, v, lo, hi, scale, logit_softcap)
    return flash_prefill(q, k, v, positions[:, 0].to(torch.int32),
                         _kv_hi(kv_len, B, S, q.device), scale,
                         logit_softcap, sliding_window)

