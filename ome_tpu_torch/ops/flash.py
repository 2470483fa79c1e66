"""Flash attention for Hopper: decode (B1), causal prefill (B2) and
decode over an int8 cache (B5).

Counterpart of ome_tpu/ops/flash.py. The TPU package wrote these
kernels in Pallas; here each is CUDA C++ written by hand for `sm_90a`
(`ops/csrc/`), built by `ops/_build.py` at first use and called through
ctypes on PyTorch's current stream.

* `flash_decode` replaces `_flash_decode` / `_decode_kernel`
  (ome_tpu/ops/flash.py:65-204). Bound on the H100: the bytes of the
  K/V rows in [lo, hi) read from device memory. It runs the decode core
  (`csrc/decode_core.cuh`, shared with the paged kernel) with the dense
  row address: each window is cut into work units by its own length
  (`decode_plan` states the rule), a persistent grid walks them, and the
  last unit of a window merges the window's partials inside the one
  launch. bf16 loads 64-row tiles by TMA and runs both products on
  wgmma; fp32 runs on the CUDA cores (`csrc/flash_decode.cu`).
* `flash_prefill` replaces `_flash_prefill` / `_prefill_kernel` /
  `_prefill_block_range` (ome_tpu/ops/flash.py:261-386). Bound on the
  H100: tensor-core operations of the causal QK^T and PV products. The
  bf16 kernel runs both on `wgmma` (fp32 accumulation, P fed from
  registers, O held in registers), in two consumer warpgroups of 64
  folded rows (the G heads of a KV head folded into the rows) fed by a
  producer warpgroup whose TMA copies fill a ring of K/V stages under
  mbarriers; it walks only the KV tiles the causal frontier, kv_hi and
  the window allow (`prefill_tile_plan` states the rule), heaviest q
  tiles first (`csrc/flash_prefill.cu`). fp32 runs a scalar kernel.
* `flash_decode_quantized` replaces `flash_decode_quantized` ->
  `_flash_decode(quantized=True)` (ome_tpu/ops/flash.py:221-255): decode
  over a dense int8 cache [B, S, K, D] with f32 scales [B, K, S] from
  `quantize_kv_block`. It runs on the paged decode kernel
  (`csrc/flash_paged_decode.cu`, also B3 in ops/paged.py): the dense
  cache is that kernel's pool of B blocks of S rows, with
  table[b, 0] = b. Bound: the int8 K/V bytes in [lo, hi) plus their
  scales. As in the reference it is not wired into serving.

All three take head_dim 64, 96, 128 and 256 (`_DIMS`; the reference's
Pallas kernels take multiples of 128 and its XLA path the rest): a D
that is not a multiple of 64 is read as ceil(D / 64) boxes of 64 dims
whose tail TMA fills with zeros. Any other head_dim is refused on CUDA
when the engine is built (`check_head_dim`), never at the first step,
and never sent to the plain version.

All three take every GQA group size G = H/K, as the reference's
kernels do. One launch folds at most MAX_GROUP (16) query heads of a KV
head into its rows; for G > 16 the wrapper splits the query heads, not
the kernel (`head_split`): the G axis is cut into ceil(G / 16) chunks of
sizes that differ by at most one, each chunk runs the same kernel with
H' = K G_c query heads over the same K/V, and its output is written back
into its heads. Head kh G_c + j of a chunk still maps to KV head kh, so
every head's arithmetic is the kernel's at G <= 16; the price is that
K/V is read once per chunk.

B1 and B2 also take attention sinks (gpt-oss): `sinks` [H], one logit
per query head, is one more column of the head's softmax whose
probability is dropped (the reference computes it on its XLA path,
ome_tpu/ops/attention.py:69-75; its Pallas kernels take no sinks). The
kernels add it where a row's output is normalized, once per head.

* `flash_prefill_bwd` is the port's own: the gradient of `flash_prefill`
  on its training path (a causal prefill from base 0 with kv_hi = S, an
  optional window and softcap, any G). The reference has no Pallas
  backward: its train step differentiates its XLA attention with
  jax.grad (ome_tpu/ops/attention.py:48-81). bf16, the training step's
  dtype, runs `csrc/flash_prefill_bwd_wgmma.cu` (every product on
  wgmma, P and dS fed as two bf16 terms, TMA-fed, the logsumexp the
  forward saved; `bwd_tile_plan` states its walks and head split); fp32
  runs the scalar `csrc/flash_prefill_bwd.cu`. `FlashPrefill` is the
  `torch.autograd.Function` whose forward is B2 (bf16: with `lse=True`,
  which writes each row's logsumexp, sinks included) and whose backward
  is this wrapper; `flash_attention` takes it only when grad is enabled
  and q, k, v or the sinks require grad, so serving runs B2 as before
  (without lse). gpt-oss's sinks get their gradient (bf16) from the
  forward's lse and the kernel's Delta (`sink_grad`). Under grad on a
  CUDA tensor a decode, fp32 sinks and any shape outside that path
  raise by name (`check_prefill_grad`): none runs the plain version or
  returns a missing gradient. Its plain version is `torch.autograd.grad`
  through `flash_prefill_ref` (`flash_prefill_bwd_ref`).

Beside each kernel sits its plain PyTorch version (`flash_decode_ref`,
`flash_prefill_ref`, `flash_decode_quantized_ref`). A wrapper uses the
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises — there is no fallback. `LAUNCHES` counts
the kernel launches of each wrapper (ops/paged.py's included), so a run
can show that its main path went through the kernels. Inside a
`count_kernel_flops()` block each launch also reports its FLOPs (the
program ledger's counted mode, perf/ledger.py: FlopCounterMode does not
see a ctypes launch), with the formulas chip_smoke's kernel bounds use.

Nothing is built or imported from the CUDA toolchain when this module
is imported.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

M_INIT = -1.0e30  # finite lowest running max: exp(x - M_INIT) underflows to 0

# kernel launches per wrapper; incremented only where a kernel launches
LAUNCHES = {"flash_decode": 0, "flash_prefill": 0, "flash_prefill_bwd": 0,
            "flash_prefill_bwd_fp32": 0, "flash_paged_decode": 0,
            "flash_decode_quantized": 0, "int4_matmul": 0}
# int4_matmul's launches by (K, N), counted at the same launch
INT4_LAUNCHES_BY_SHAPE: dict = {}

# head_dims the CUDA kernels take (B1, B2, B3, B5)
_DIMS = (64, 96, 128, 256)
# query heads per KV head (G = H / K) one launch takes: 1 to 16, any of
# them (kMaxGroup in csrc/decode_core.cuh). A larger G is split into
# chunks of at most MAX_GROUP heads (`head_split`), one launch each.
MAX_GROUP = 16
_RECIP_127 = 1.0 / 127.0    # rounded to f32 where it multiplies a f32 tensor


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    INT4_LAUNCHES_BY_SHAPE.clear()


# this thread's open FLOP sink (a list), or None
_FLOP_SINK = threading.local()


@contextlib.contextmanager
def count_kernel_flops():
    """Collect the FLOPs of the kernels this thread launches inside the
    block: yields a list of callables, one per launch, each giving that
    launch's count (an int, or an int tensor on the card where the count
    depends on the data) when called after the block."""
    prev = getattr(_FLOP_SINK, "sink", None)
    sink = _FLOP_SINK.sink = []
    try:
        yield sink
    finally:
        _FLOP_SINK.sink = prev


def _report_flops(count) -> None:
    """Add a launch's FLOPs (`count`, a callable) to this thread's open
    sink, if any."""
    sink = getattr(_FLOP_SINK, "sink", None)
    if sink is not None:
        sink.append(count)


def _rows(lo, hi) -> torch.Tensor:
    """KV rows the windows [lo[b], hi[b]) attend, summed (on the device;
    lo None: from row 0)."""
    span = hi if lo is None else hi - lo
    return span.clamp(min=0).sum(dtype=torch.int64)


def _prefill_pairs(base, kv_hi, Sq: int, window) -> torch.Tensor:
    """(query row, key row) pairs a causal prefill attends: row i of
    sequence b at base[b] + i sees [pos - window + 1 or 0,
    min(pos + 1, kv_hi[b]))."""
    pos = base[:, None].long() + torch.arange(Sq, device=base.device)
    top = torch.minimum(pos + 1, kv_hi[:, None].long())
    lo = (pos - window + 1).clamp(min=0) if window else 0
    return (top - lo).clamp(min=0).sum()


def _dims_text() -> str:
    return ", ".join(map(str, _DIMS[:-1])) + f" or {_DIMS[-1]}"


def check_head_dim(head_dim: int, device) -> None:
    """Raise NotImplementedError, naming head_dim and the taken set,
    when a model of this head_dim would run the CUDA kernels on `device`
    (a torch.device or a name such as "cuda") and they do not take it.
    The CPU runs the plain versions at every head_dim. The engine calls
    this at construction, so such a model is refused when it loads."""
    if torch.device(device).type == "cuda" and head_dim not in _DIMS:
        raise NotImplementedError(
            f"head_dim {head_dim}: the CUDA attention kernels take "
            f"head_dim {_dims_text()}")


def check_model_head_dim(cfg, device) -> None:
    """`check_head_dim` for a model config, where its attention runs the
    kernels: MLA attention (`cfg.mla`: DeepSeek, Kimi-K2) is plain
    products over the latent cache that launch none of them, so its
    derived head_dim (hidden / heads, 56 for DeepSeek-V3) is not
    checked. The engine, the embedding engine and `serve`'s loader call
    this one predicate."""
    if not cfg.mla:
        check_head_dim(cfg.head_dim, device)


def check_group(name: str, H: int, K: int) -> None:
    """Raise NotImplementedError unless H query heads over K KV heads
    form a whole group size G = H / K >= 1 (any G: one launch takes up
    to MAX_GROUP heads per KV head, `head_split` cuts a larger G)."""
    if K <= 0 or H < K or H % K:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take G = H/K >= 1 whole query heads "
            f"per KV head, got H={H}, K={K}")


def group_chunks(G: int) -> List[Tuple[int, int]]:
    """(first head, heads) of each chunk of a group of G query heads:
    ceil(G / MAX_GROUP) chunks whose sizes differ by at most one, larger
    first. One chunk (0, G) for G <= MAX_GROUP."""
    n = -(-G // MAX_GROUP)
    size, extra = divmod(G, n)
    out, g0 = [], 0
    for i in range(n):
        gc = size + (i < extra)
        out.append((g0, gc))
        g0 += gc
    return out


def head_split(launch, q: torch.Tensor, K: int,
               sinks: Optional[torch.Tensor] = None,
               lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run `launch(q', sinks')` on each chunk of q's query heads and put
    the outputs back in their heads. q [B, Sq, H, D] with G = H / K
    heads per KV head, viewed as [B, Sq, K, G, D]; chunk (g0, gc) is the
    contiguous [B, Sq, K gc, D] tensor of heads g0 .. g0 + gc - 1 of
    every KV head, so its head kh gc + j still attends KV head kh, and
    sinks' (None without sinks) is the [K gc] sinks of those heads.
    `launch` maps such a q' to an output of its shape. G <= MAX_GROUP
    calls `launch(q, sinks)` once, unchanged. With `lse` (a [B, H, Sq]
    plane the launches fill), `launch(q', sinks', lse')` also writes
    lse' [B, K gc, Sq], the chunk's heads, which go back into theirs."""
    B, Sq, H, D = q.shape
    G = H // K
    chunks = group_chunks(G)
    extra = () if lse is None else (lse,)
    if len(chunks) == 1:
        return launch(q, sinks, *extra)
    qg = q.reshape(B, Sq, K, G, D)
    sg = None if sinks is None else sinks.reshape(K, G)
    out = torch.empty_like(qg)
    for g0, gc in chunks:
        qc = qg[:, :, :, g0:g0 + gc].reshape(B, Sq, K * gc, D).contiguous()
        sc = None if sg is None else \
            sg[:, g0:g0 + gc].reshape(K * gc).contiguous()
        lc = () if lse is None else (lse.new_empty(B, K * gc, Sq),)
        out[:, :, :, g0:g0 + gc] = launch(qc, sc, *lc).reshape(
            B, Sq, K, gc, D)
        if lse is not None:
            lse.view(B, K, G, Sq)[:, :, g0:g0 + gc] = lc[0].view(
                B, K, gc, Sq)
    return out.reshape(B, Sq, H, D)


# -- plain versions ---------------------------------------------------------


def _masked_softmax_attention(q, k, v, valid, scale, softcap, sinks=None,
                              lse: bool = False):
    """Shared plain math of both kernels, in fp32 (fp64 for fp64 inputs:
    the backward's fp64 yardstick): q [B, Sq, H, D],
    k/v [B, S, K, D], valid [B, Sq, S] bool, sinks [H] or None.
    Online-softmax semantics of the kernels: finite M_INIT,
    probabilities of masked columns set to exactly 0, a head's sink one
    more column of its softmax whose probability is dropped, l clamped
    at 1e-30 (an empty window gives 0). `lse`: also return each row's
    logsumexp [B, H, Sq] (natural log, the sink column included), the
    plane B2 writes under grad."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(ct).reshape(B, Sq, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.to(ct)) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mask = valid[:, None, None, :, :]
    logits = torch.where(mask, logits, torch.full_like(logits, M_INIT))
    m = logits.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.to(device=q.device, dtype=ct).reshape(
            1, K, G, 1, 1)
        m = torch.maximum(m, sk)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sk - m)
    l = l.clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p / l, v.to(ct))
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not lse:
        return out
    return out, (m + torch.log(l))[..., 0].reshape(B, H, Sq)


def flash_decode_ref(q, k, v, lo, hi, scale: float,
                     softcap: Optional[float] = None,
                     sinks: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the decode kernel: q [B, 1, H, D];
    k, v [B, S, K, D]; each sequence b attends rows [lo[b], hi[b]);
    sinks [H] sink logits or None."""
    S = k.shape[1]
    col = torch.arange(S, device=k.device)
    valid = ((col[None, :] >= lo.to(k.device)[:, None])
             & (col[None, :] < hi.to(k.device)[:, None]))[:, None, :]
    return _masked_softmax_attention(q, k, v, valid, scale, softcap, sinks)


def flash_prefill_ref(q, k, v, base, kv_hi, scale: float,
                      softcap: Optional[float] = None,
                      window: Optional[int] = None,
                      sinks: Optional[torch.Tensor] = None,
                      lse: bool = False):
    """Plain PyTorch version of the prefill kernel: q [B, Sq, H, D] with
    query row i of sequence b at position base[b] + i; k, v [B, S, K, D];
    columns c <= base + i, c < kv_hi and (window) c > base + i - window;
    sinks [H] sink logits or None. `lse`: returns (out, lse [B, H, Sq]),
    as `flash_prefill(lse=True)` does."""
    Sq, S = q.shape[1], k.shape[1]
    dev = k.device
    col = torch.arange(S, device=dev)[None, None, :]
    pos = (base.to(dev)[:, None]
           + torch.arange(Sq, device=dev)[None, :])[:, :, None]
    valid = (col <= pos) & (col < kv_hi.to(dev)[:, None, None])
    if window:
        valid = valid & (col > pos - window)
    return _masked_softmax_attention(q, k, v, valid, scale, softcap, sinks,
                                     lse)


PREFILL_ROWS = 64  # folded query rows of a consumer warpgroup (kBM)


def prefill_block_positions(G: int, consumers: int) -> int:
    """Query positions of one bf16 prefill block (BQ in
    `csrc/flash_prefill.cu`): each of its `consumers` warpgroups folds
    floor(64 / G) positions x G heads into its 64 rows, the rest idle.
    The block's q tile is positions q0 .. q0 + BQ - 1, q0 = BQ x tile."""
    return consumers * (PREFILL_ROWS // G)


def prefill_tile_plan(base: int, kv_hi: int, q0: int, nq: int, bn: int,
                      window: Optional[int] = None):
    """The KV-tile walk of one prefill q tile: the rule the bf16 kernel
    implements (`csrc/flash_prefill.cu`, `prefill_wgmma`: `t0`/`ntiles`
    at the head of the kernel, `tile_full` in the consumer loop).

    The q tile holds positions base + q0 .. base + q0 + nq - 1 (nq >= 1
    valid rows; q0 a multiple of `prefill_block_positions`); KV tiles
    are `bn` rows. Returns (t0, ntiles, full):
    the walk is tiles t0 .. t0 + ntiles - 1, every one of which holds a
    valid (row, column) pair, and full[i] says that every pair of tile
    t0 + i is valid (column <= position, column < kv_hi and, with a
    window, column > position - window), so the kernel skips its mask.
    Columns before the window's first or past min(last position,
    kv_hi - 1) are never walked — `_prefill_block_range`'s bounds."""
    first = max(base + q0 - window + 1, 0) if window else 0
    last = min(base + q0 + nq - 1, kv_hi - 1)
    if nq <= 0 or last < first:
        return first // bn, 0, []
    t0 = first // bn
    ntiles = last // bn - t0 + 1
    full = []
    for t in range(t0, t0 + ntiles):
        c0 = t * bn
        full.append(c0 + bn - 1 <= base + q0 and c0 + bn <= kv_hi
                    and (not window or c0 > base + q0 + nq - 1 - window))
    return t0, ntiles, full


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
            f"{name}: the CUDA kernel takes head_dim {_dims_text()}, got "
            f"{D}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _int32(x, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def _sinks(name: str, sinks, H: int, device) -> Optional[torch.Tensor]:
    """sinks [H] (any float dtype) as the kernels' contiguous fp32, or
    None."""
    if sinks is None:
        return None
    if sinks.numel() != H:
        raise ValueError(f"{name}: {sinks.numel()} sinks for {H} heads")
    return sinks.to(device=device, dtype=torch.float32).reshape(
        H).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- decode plan -------------------------------------------------------------
#
# How the decode core (`csrc/decode_core.cuh`; B1, B3, B5) cuts and walks
# its work, in plain Python so that the CPU tests reach it. The kernel
# mirrors it: kTileRows, kMaxBatch, kTcBlocksPerSm and `window_of`,
# `build_prefix`, `unit_of`, `merge_window` for the functions below.

TILE_ROWS = 64       # rows of a tile (kTileRows): wgmma's M side
UNIT_ROWS = 512      # rows of a full work unit, a multiple of TILE_ROWS
MAX_BATCH = 1024     # sequences a launch takes (kMaxBatch)
TC_BLOCKS_PER_SM = 2      # decode_tc blocks on an SM (bf16 queries)
SCALAR_BLOCKS_PER_SM = 4  # decode_scalar blocks on an SM (fp32)


def decode_blocks_per_sm(tensor_cores: bool = True,
                         head_dim: int = 128) -> int:
    """Resident decode blocks per SM (`tc_blocks_per_sm` in
    `csrc/decode_core.cuh`): half as many at head_dim 256, whose
    decode_tc stages are 64 KB and whose decode_scalar tiles take
    87 KB."""
    per_sm = TC_BLOCKS_PER_SM if tensor_cores else SCALAR_BLOCKS_PER_SM
    return per_sm // 2 if head_dim > 128 else per_sm


class DecodeWindow(NamedTuple):
    """Sequence b's rows [lo, hi) inside [0, limit), the tile-aligned
    start `alo` the units are cut from, and the number of units `n`
    (at least 1: an empty window is one unit with no rows, which writes
    its zeros)."""

    lo: int
    hi: int
    alo: int
    n: int


def decode_window(lo: int, hi: int, limit: int,
                  unit_rows: int = UNIT_ROWS) -> DecodeWindow:
    lo, hi = max(int(lo), 0), min(int(hi), limit)
    if hi <= lo:
        return DecodeWindow(0, 0, 0, 1)
    alo = lo - lo % TILE_ROWS
    return DecodeWindow(lo, hi, alo, -(-(hi - alo) // unit_rows))


def decode_grid(B: int, K: int, limit: int, sm_count: int,
                tensor_cores: bool = True, unit_rows: int = UNIT_ROWS,
                head_dim: int = 128):
    """(grid, max_units) of a launch, from what the host knows without
    reading lo and hi: the persistent grid is the card's resident blocks
    of the kernel, but no more than the units the windows can have
    (`max_units`, B K ceil(limit / unit_rows), which also sizes the
    workspace)."""
    max_units = B * K * max(1, -(-limit // unit_rows))
    per_sm = decode_blocks_per_sm(tensor_cores, head_dim)
    return max(1, min(sm_count * per_sm, max_units)), max_units


class DecodePlan(NamedTuple):
    """The walk of one decode launch. Window (b, kh) is cut from its
    `alo` into units of `unit_rows` rows, unit j taking [alo + j
    unit_rows, min(alo + (j + 1) unit_rows, hi)). Units are numbered
    sequence by sequence, `u = prefix[b] + j * K + kh`, so that units
    that run side by side read one sequence's heads at the same rows.
    Block i of the persistent grid walks units i, i + grid, ...; the
    last unit of a window to finish merges the window's partials in
    unit order (`merge_order`). A window's units and its merge depend on
    its own [lo, hi) only."""

    K: int
    limit: int
    unit_rows: int
    windows: Tuple[DecodeWindow, ...]
    prefix: Tuple[int, ...]   # prefix[b]: units of sequences before b
    grid: int
    max_units: int

    @property
    def n_units(self) -> int:
        return self.prefix[-1]

    def unit(self, u: int) -> Tuple[int, int, int, int, int]:
        """Unit u as (b, kh, j, r0, r1): rows [r0, r1) of its window."""
        b = bisect.bisect_right(self.prefix, u) - 1
        j, kh = divmod(u - self.prefix[b], self.K)
        w = self.windows[b]
        r0 = w.alo + j * self.unit_rows
        return b, kh, j, r0, max(min(r0 + self.unit_rows, w.hi), r0)

    def units(self, block: int) -> List[int]:
        """Block `block`'s units in walk order."""
        return list(range(block, self.n_units, self.grid))

    def merge_order(self, b: int, kh: int) -> List[int]:
        """The units of window (b, kh), in the order their partials are
        added."""
        return [self.prefix[b] + j * self.K + kh
                for j in range(self.windows[b].n)]


def decode_plan(lo, hi, K: int, limit: int, sm_count: int,
                tensor_cores: bool = True,
                unit_rows: int = UNIT_ROWS,
                head_dim: int = 128) -> DecodePlan:
    """The plan of a decode launch over windows [lo[b], hi[b]) of
    sequences that hold `limit` rows (S dense, M * bs paged), K KV heads,
    on a card of `sm_count` SMs. The kernel builds the same unit list on
    the device; the host needs only `decode_grid`."""
    windows = tuple(decode_window(a, z, limit, unit_rows)
                    for a, z in zip(lo, hi))
    prefix = [0]
    for w in windows:
        prefix.append(prefix[-1] + w.n * K)
    grid, max_units = decode_grid(len(windows), K, limit, sm_count,
                                  tensor_cores, unit_rows, head_dim)
    return DecodePlan(K, limit, unit_rows, windows, tuple(prefix), grid,
                      max_units)


# (device index, stream) -> (fp32 unit partials, int32 window counters):
# allocated once and grown, never per launch. The kernels leave every
# counter at 0 when they end, so launches on one stream reuse them.
_DECODE_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _decode_scratch(dev: torch.device, stream: int, n_part: int,
                    n_cnt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    part, cnt = _DECODE_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < n_cnt:
        cnt = torch.zeros(n_cnt, dtype=torch.int32, device=dev)
    _DECODE_SCRATCH[key] = (part, cnt)
    return part, cnt


def _check_batch(name: str, B: int) -> None:
    if B > MAX_BATCH:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes at most {MAX_BATCH} sequences, "
            f"got {B}")


def _decode_workspace(name: str, q, K: int, limit: int):
    """(grid, unit_rows, part, cnt, stream) of a decode launch on q's
    device and current stream."""
    from . import _build
    B, _, H, D = q.shape
    dev = q.device
    unit_rows = UNIT_ROWS
    grid, max_units = decode_grid(B, K, limit, _build.sm_count(dev),
                                  q.dtype == torch.bfloat16, unit_rows, D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, cnt = _decode_scratch(dev, stream,
                                max_units * (H // K) * (D + 4), B * K)
    return grid, unit_rows, part, cnt, stream


def flash_decode(q, k, v, lo, hi, scale: float,
                 softcap: Optional[float] = None,
                 sinks: Optional[torch.Tensor] = None):
    """Decode attention (Sq == 1): q [B, 1, H, D]; k, v [B, S, K, D];
    lo, hi [B] — sequence b attends cache rows [lo[b], hi[b]); sinks
    [H] sink logits or None. Returns [B, 1, H, D] in q.dtype."""
    if not q.is_cuda:
        return flash_decode_ref(q, k, v, lo, hi, scale, softcap, sinks)
    _check_cuda("flash_decode", q, k, v)
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if Sq != 1:
        raise NotImplementedError(
            f"flash_decode: needs Sq == 1, got q {tuple(q.shape)}")
    check_group("flash_decode", H, K)
    _check_batch("flash_decode", B)
    from . import _build
    fn = _build.kernel("flash_decode")
    dev = q.device
    lo, hi = _int32(lo, dev), _int32(hi, dev)
    sinks = _sinks("flash_decode", sinks, H, dev)

    def launch(qc, sc):
        grid, unit_rows, part, cnt, stream = _decode_workspace(
            "flash_decode", qc, K, S)
        out = torch.empty_like(qc)
        rc = fn(qc.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
                hi.data_ptr(), out.data_ptr(), part.data_ptr(),
                cnt.data_ptr(), _ptr(sc), B, S, qc.shape[2], K, D,
                unit_rows, grid,
                float(scale), float(softcap or 0.0),
                int(q.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"flash_decode: kernel launch failed with "
                               f"CUDA error {rc}")
        LAUNCHES["flash_decode"] += 1
        _report_flops(lambda: 4 * D * qc.shape[2] * _rows(lo, hi))
        return out
    with torch.cuda.device(dev):  # the C side launches on the current card
        return head_split(launch, q, K, sinks)


def flash_prefill(q, k, v, base, kv_hi, scale: float,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None,
                  sinks: Optional[torch.Tensor] = None,
                  lse: bool = False):
    """Causal prefill: q [B, Sq, H, D] with row i of sequence b at
    position base[b] + i; k, v [B, S, K, D] with kv_hi[b] valid rows;
    sinks [H] sink logits or None. Returns [B, Sq, H, D] in q.dtype.
    `lse` (bf16 on the card; `FlashPrefill` asks for it under grad):
    returns (out, lse [B, H, Sq] fp32), each row's logsumexp in natural
    log, its sink included, written by the same launch."""
    if not q.is_cuda:
        return flash_prefill_ref(q, k, v, base, kv_hi, scale, softcap,
                                 window, sinks, lse)
    _check_cuda("flash_prefill", q, k, v)
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    check_group("flash_prefill", H, K)
    if lse and (q.dtype != torch.bfloat16 or S == 0):
        raise NotImplementedError(
            f"flash_prefill: lse is written by the bf16 kernel over a "
            f"non-empty cache, got {q.dtype} with S={S}")
    from . import _build
    fn = _build.kernel("flash_prefill")
    dev = q.device
    base, kv_hi = _int32(base, dev), _int32(kv_hi, dev)
    sinks = _sinks("flash_prefill", sinks, H, dev)
    lse_t = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if lse else None

    def launch(qc, sc, lc=None):
        out = torch.empty_like(qc)
        rc = fn(qc.data_ptr(), k.data_ptr(), v.data_ptr(), base.data_ptr(),
                kv_hi.data_ptr(), out.data_ptr(), _ptr(sc), _ptr(lc), B, Sq,
                S, qc.shape[2], K, D, float(scale), float(softcap or 0.0),
                int(window or 0), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_prefill: kernel launch failed with "
                               f"CUDA error {rc}")
        LAUNCHES["flash_prefill"] += 1
        _report_flops(lambda: 4 * D * qc.shape[2] * _prefill_pairs(
            base, kv_hi, Sq, window))
        return out
    with torch.cuda.device(dev):  # the C side launches on the current card
        out = head_split(launch, q, K, sinks, lse_t)
    return (out, lse_t) if lse else out


# -- the prefill's backward (training) ---------------------------------------

BWD_TILE = 64  # rows of a query tile and of a key tile (kT)


class BwdPlan(NamedTuple):
    """The walks and grids of the bf16 backward (`csrc/
    flash_prefill_bwd_wgmma.cu`) over S rows with a sliding window
    (None: none): tiles of BWD_TILE rows; `q_walk(qt)` the key tiles
    bwd_dq walks for query tile qt, `kv_walk(kt)` the query tiles
    bwd_dkdv walks for key tile kt, each as (first tile, count, full)
    with full[i] saying that every pair of that tile pair is valid (its
    mask is skipped). bwd_dkdv runs a block per key tile, KV head,
    sequence, 64-column chunk of D (`kv_chunks`) and head split: each
    key tile's G heads are split over `g_split` blocks (`heads(split)`),
    whose partials a third launch sums in split order."""

    S: int
    window: Optional[int]
    G: int
    n_tiles: int
    kv_chunks: int
    g_split: int

    @staticmethod
    def full(q0: int, k0: int, S: int, window: Optional[int]) -> bool:
        """Every pair of query rows q0.. and key rows k0.. valid
        (`tile_full`)."""
        t = BWD_TILE
        return (k0 + t - 1 <= q0 and q0 + t <= S
                and (not window or k0 > q0 + t - 1 - window))

    def q_walk(self, qt: int):
        t, S, w = BWD_TILE, self.S, self.window
        q0 = qt * t
        first = max(q0 - w + 1, 0) if w else 0
        last = min(q0 + t, S) - 1
        kt0 = first // t
        n = last // t - kt0 + 1
        return kt0, n, [self.full(q0, (kt0 + i) * t, S, w)
                        for i in range(n)]

    def kv_steps(self, kt: int) -> int:
        """The number of query tiles bwd_dkdv walks for key tile kt."""
        t, w = BWD_TILE, self.window
        last = min(self.S - 1, kt * t + t - 2 + w) if w else self.S - 1
        return last // t - kt + 1

    def kv_walk(self, kt: int):
        n = self.kv_steps(kt)
        return kt, n, [self.full((kt + i) * BWD_TILE, kt * BWD_TILE, self.S,
                                 self.window) for i in range(n)]

    def heads(self, split: int) -> range:
        return range(split * self.G // self.g_split,
                     (split + 1) * self.G // self.g_split)


@functools.lru_cache(maxsize=256)
def bwd_tile_plan(B: int, S: int, H: int, K: int, D: int,
                  window: Optional[int], sm_count: int) -> BwdPlan:
    """The bf16 backward's plan (`BwdPlan`) on a card of `sm_count` SMs.
    The head split: bwd_dkdv's heaviest block (key tile 0, which every
    query tile of a causal walk sees) does G / g_split of its heads'
    steps; g_split is the least that keeps it within the mean work of a
    resident block (two per SM at D <= 128, one at 256), so that at low
    B K (G 32: K 1) the key tiles' heads fill the SMs. At most G."""
    n = -(-S // BWD_TILE)
    G = H // K
    plan = BwdPlan(S, window, G, n, -(-D // 64), 1)
    steps = [plan.kv_steps(kt) for kt in range(n)]
    slots = sm_count * (1 if D > 128 else 2)
    split = -(-steps[0] * slots // (sum(steps) * K * B * plan.kv_chunks))
    return plan._replace(g_split=max(1, min(G, split)))


def sink_grad(sinks: torch.Tensor, lse: torch.Tensor,
              delta: torch.Tensor) -> torch.Tensor:
    """The sink logits' gradient [H] fp32 from the forward's lse and the
    backward's Delta = rowsum(P dP), both [B, H, S]: a sink is one more
    column of its head's softmax with no value row, so dP of its column
    is 0 and dsink_h = -sum_{b, i} exp(sink_h - lse_{b,h,i}) Delta_{b,h,i}
    (an O(S) reduction: plain torch)."""
    p = torch.exp(sinks.float().reshape(1, -1, 1) - lse)
    return -(p * delta).sum(dim=(0, 2))


def flash_prefill_bwd_ref(q, k, v, dout, scale: float,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None,
                          compute: torch.dtype = torch.float32,
                          sinks: Optional[torch.Tensor] = None):
    """Plain version of the prefill's backward: (dq, dk, dv) of
    `flash_prefill_ref` at base 0 with kv_hi = S, by torch.autograd.grad
    in fp32, returned in fp32 as the kernel writes them; with `sinks`
    [H] also their gradient (dq, dk, dv, dsink). `compute` float64 runs
    it in fp64 (a yardstick finer than fp32's own sums)."""
    B, S = q.shape[:2]
    dev = q.device
    leaves = (q, k, v) + (() if sinks is None else (sinks,))
    with torch.enable_grad():
        xs = [t.detach().to(compute).requires_grad_() for t in leaves]
        out = flash_prefill_ref(
            *xs[:3], torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), S, dtype=torch.int32, device=dev), scale,
            softcap, window, xs[3] if sinks is not None else None)
        return torch.autograd.grad(out, xs, dout.to(compute))


def check_prefill_grad(q, k, v, positions, kv_len=None,
                       sinks: Optional[torch.Tensor] = None) -> None:
    """Raise NotImplementedError, naming the case, unless attention with
    these arguments is on a backward kernel's path: a causal prefill
    (Sq > 1; a decode, Sq = 1, is refused) of the whole sequence from
    position 0 (Sq = S, no kv_len, positions[:, 0] = 0), bf16 (sinks
    too) or fp32 (no sinks: its scalar kernel recomputes a logsumexp
    without them), head_dim 64, 96, 128 or 256 and a whole G = H / K.
    `flash_attention` calls it under grad on a CUDA tensor, so no such
    call quietly runs the plain version or leaves q, k, v or the sinks
    without a gradient. The position check reads positions[:, 0] back to
    the host."""
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    name = "flash_attention backward"
    if Sq == 1:
        raise NotImplementedError(
            f"{name}: a decode (Sq = 1) has no backward kernel; training "
            "runs whole-sequence prefills")
    if sinks is not None and q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name}: attention sinks (gpt-oss) take the bf16 kernel, "
            f"whose logsumexp comes from the forward; got {q.dtype}")
    why = []
    if q.dtype not in (torch.bfloat16, torch.float32):
        why.append(f"dtype {q.dtype}")
    if D not in _DIMS or k.shape[-1] != D or v.shape[-1] != D:
        why.append(f"head_dim {D} (takes {_dims_text()})")
    if K <= 0 or H < K or H % K:
        why.append(f"H={H} over K={K}")
    if Sq != S or kv_len is not None:
        why.append(f"a query chunk of {Sq} rows over {S} cache rows"
                   + (" with kv_len" if kv_len is not None else ""))
    elif positions is None or bool((positions[:, 0] != 0).any()):
        why.append("positions that do not start at 0")
    if why:
        raise NotImplementedError(
            f"{name}: the kernel takes a causal prefill of the whole "
            f"sequence from position 0; got {', '.join(why)}")


def flash_prefill_bwd(q, k, v, dout, scale: float,
                      softcap: Optional[float] = None,
                      window: Optional[int] = None,
                      lse: Optional[torch.Tensor] = None,
                      sinks: Optional[torch.Tensor] = None,
                      launch_events: Optional[List] = None):
    """(dq, dk, dv) of the causal prefill at base 0 with kv_hi = S: q,
    dout [B, S, H, D]; k, v [B, S, K, D], bf16 or fp32; with `sinks` [H]
    (bf16) also dsink: (dq, dk, dv, dsink). bf16 launches
    `csrc/flash_prefill_bwd_wgmma.cu` on `lse` [B, H, S], the forward's
    (`flash_prefill(lse=True)`: the sinks are in it); fp32 launches the
    scalar `csrc/flash_prefill_bwd.cu`, which recomputes each row's
    logsumexp. Both take Delta = rowsum(P dP) (not rowsum(dout * out),
    which the forward's bf16 rounding of out would move). The gradients
    come back in fp32 (a bf16 rounding of the largest would move it by
    ~0.2 of the gradient's rms: the kernels' notes); `FlashPrefill`
    casts them. Counted under LAUNCHES["flash_prefill_bwd"] (bf16) or
    ["flash_prefill_bwd_fp32"]. `launch_events`: None, or 4 recorded
    `torch.cuda.Event(enable_timing=True)` that the C side records on
    the stream around its launches (a caller's per-launch timing: the
    kernels' `mark`)."""
    if not q.is_cuda:
        return flash_prefill_bwd_ref(q, k, v, dout, scale, softcap, window,
                                     sinks=sinks)
    _check_cuda("flash_prefill_bwd", q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"flash_prefill_bwd: dout must be a contiguous "
                         f"{q.dtype} tensor of q's shape {tuple(q.shape)} "
                         f"on {q.device}")
    B, S, H, D = q.shape
    K = k.shape[2]
    if k.shape[1] != S:
        raise NotImplementedError(
            f"flash_prefill_bwd: needs Sq == S, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")
    check_group("flash_prefill_bwd", H, K)
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and sinks is not None:
        raise NotImplementedError(
            "flash_prefill_bwd: attention sinks take the bf16 kernel; the "
            f"{q.dtype} kernel recomputes a logsumexp without them")
    if bf16 and (lse is None or tuple(lse.shape) != (B, H, S)
                 or lse.dtype != torch.float32 or lse.device != q.device
                 or not lse.is_contiguous()):
        raise ValueError(f"flash_prefill_bwd: bf16 takes the forward's lse, "
                         f"a contiguous float32 [{B}, {H}, {S}] on "
                         f"{q.device}")
    from . import _build
    dev = q.device
    dq, dk, dv = (torch.empty(t.shape, dtype=torch.float32, device=dev)
                  for t in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    events = None if launch_events is None else \
        (ctypes.c_void_p * 4)(*(e.cuda_event for e in launch_events))
    with torch.cuda.device(dev):  # the C side launches on the current card
        if bf16:
            plan = bwd_tile_plan(B, S, H, K, D, window, _build.sm_count(dev))
            part = torch.empty(2 * plan.g_split * k.numel(),
                               dtype=torch.float32, device=dev) \
                if plan.g_split > 1 else None
            rc = _build.kernel("flash_prefill_bwd_wgmma")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _ptr(part), B, S, H, K, D,
                float(scale), float(softcap or 0.0), int(window or 0),
                plan.g_split, events, stream)
        else:
            lse_f = torch.empty_like(delta)
            rc = _build.kernel("flash_prefill_bwd")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse_f.data_ptr(), delta.data_ptr(), B, S, H, K, D,
                float(scale), float(softcap or 0.0), int(window or 0),
                events, stream)
    if rc != 0:
        raise RuntimeError(f"flash_prefill_bwd: kernel launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["flash_prefill_bwd" if bf16 else "flash_prefill_bwd_fp32"] += 1
    base = torch.zeros(B, dtype=torch.int32, device=dev)
    kv_hi = torch.full((B,), S, dtype=torch.int32, device=dev)
    _report_flops(lambda: 10 * D * H * _prefill_pairs(base, kv_hi, S,
                                                      window))
    if sinks is None:
        return dq, dk, dv
    return dq, dk, dv, sink_grad(_sinks("flash_prefill_bwd", sinks, H, dev),
                                 lse, delta)


class FlashPrefill(torch.autograd.Function):
    """B2 with a gradient: the forward launches `flash_prefill` at base 0
    with kv_hi = S and saves q, k, v (and, bf16, the lse plane it asks
    B2 for, and the sinks); the backward launches `flash_prefill_bwd`
    and casts its fp32 gradients to the inputs' dtype. `sinks` [H] (or
    None) is an input with a gradient (bf16)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, softcap, window, sinks=None):
        B, S = q.shape[:2]
        dev = q.device
        base = torch.zeros(B, dtype=torch.int32, device=dev)
        kv_hi = torch.full((B,), S, dtype=torch.int32, device=dev)
        out, lse = flash_prefill(q, k, v, base, kv_hi, scale, softcap,
                                 window, sinks, lse=True) \
            if q.dtype == torch.bfloat16 else \
            (flash_prefill(q, k, v, base, kv_hi, scale, softcap, window,
                           sinks), None)
        ctx.save_for_backward(q, k, v, lse, sinks)
        ctx.args = (scale, softcap, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, sinks = ctx.saved_tensors
        grads = flash_prefill_bwd(q, k, v, dout.contiguous(), *ctx.args,
                                  lse=lse, sinks=sinks)
        dsink = None if sinks is None else grads[3].to(sinks.dtype)
        return (grads[0].to(q.dtype), grads[1].to(k.dtype),
                grads[2].to(v.dtype), None, None, None, dsink)


def check_paged_coverage(block: int, head_dim: int, num_heads: int,
                         num_kv_heads: int) -> None:
    """Raise ValueError unless the paged decode kernel takes this
    shape: pool blocks a multiple of its 32-row tile, a head_dim of
    `_DIMS`, and a whole G = H / K >= 1 (any G: `head_split` cuts
    G > 16)."""
    if block <= 0 or block % 32 or head_dim not in _DIMS or \
            num_kv_heads <= 0 or num_heads < num_kv_heads or \
            num_heads % num_kv_heads:
        raise ValueError(
            f"the CUDA paged decode kernel needs a KV block that is a "
            f"multiple of 32, head_dim {_dims_text()} and a whole "
            f"G = H/K >= 1 (got kv_block={block}, head_dim={head_dim}, "
            f"heads={num_heads}, kv_heads={num_kv_heads})")


def paged_decode_launch(name: str, q, k_pool, v_pool, table, lo, hi,
                        scale: float, softcap: Optional[float] = None,
                        k_scale=None, v_scale=None):
    """Launch `csrc/flash_paged_decode.cu` (kernels B3 and B5) on CUDA
    tensors and count it under LAUNCHES[name]. q [B, 1, H, D] bf16 or
    fp32; pools [N, bs, K, D] in q's dtype, or int8 with k_scale,
    v_scale [N, K, bs] f32; table [B, M] pool block ids; sequence b
    attends rows [lo[b], hi[b]) (lo None: from row 0). Returns
    [B, 1, H, D] in q.dtype."""
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
    _check_batch(name, B)
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
    hi = _int32(hi, dev)
    lo = None if lo is None else _int32(lo, dev)
    M = table.shape[1]

    def launch(qc, _):
        grid, unit_rows, part, cnt, stream = _decode_workspace(
            name, qc, K, M * bs)
        out = torch.empty_like(qc)
        rc = fn(qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                table.data_ptr(), None if lo is None else lo.data_ptr(),
                hi.data_ptr(), out.data_ptr(),
                part.data_ptr(), cnt.data_ptr(), B, N, bs, M, qc.shape[2],
                K, D, unit_rows, grid, float(scale), float(softcap or 0.0),
                int(q.dtype == torch.bfloat16), int(quantized), stream)
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {rc}")
        LAUNCHES[name] += 1
        _report_flops(lambda: 4 * D * qc.shape[2] * _rows(lo, hi))
        return out
    with torch.cuda.device(dev):
        return head_split(launch, q, K)


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
                    logit_softcap: Optional[float] = None,
                    sinks: Optional[torch.Tensor] = None):
    """Causal attention through the kernels (counterpart of
    ome_tpu/ops/flash.py::flash_attention). q: [B, Sq, H, D];
    k, v: [B, Skv, K, D]; positions: [B, Sq] absolute query positions,
    contiguous per row; kv_len: [B] valid KV rows (None = all); sinks:
    [H] sink logits (gpt-oss) or None. Under grad on a CUDA tensor (q,
    k, v or the sinks requiring it) the prefill runs through
    `FlashPrefill` (B2 and its backward kernels) or raises
    (`check_prefill_grad`); on the CPU autograd differentiates the plain
    versions."""
    B, Sq, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    if q.is_cuda and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, sinks)):
        check_prefill_grad(q, k, v, positions, kv_len, sinks)
        return FlashPrefill.apply(q, k, v, scale, logit_softcap,
                                  sliding_window, sinks)
    if Sq == 1:
        lo, hi = _decode_limits(positions, kv_len, S, sliding_window)
        return flash_decode(q, k, v, lo, hi, scale, logit_softcap, sinks)
    return flash_prefill(q, k, v, positions[:, 0].to(torch.int32),
                         _kv_hi(kv_len, B, S, q.device), scale,
                         logit_softcap, sliding_window, sinks)

