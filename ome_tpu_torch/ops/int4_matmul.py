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
  bytes and scales read from device memory at decode sizes (a decode
  batch does ~4m flops per packed byte, far below the tensor cores'
  ~295 flops/byte), tensor-core operations at m 256. TMA copies fill a
  ring of shared-memory stages under mbarriers; a persistent grid walks
  the (split, column tile) units that `int4_plan` deals out; the K
  splits of a tile are summed inside the launch, in split order, by the
  last split to finish (no atomics on the data: the same inputs give
  the same bits). Decode (m <= 16) runs wgmma with the unpacked weights
  as the A operand from registers; m 17..256 unpack each weight once
  into shared memory for wgmma over every row of x.
* On a CPU tensor it runs `int4_matmul_ref`, the plain version.
* A CUDA tensor of a shape the kernel does not take raises; the
  caller (`models/llama._proj`) asks `int4_eligible` first, which is
  the reference's dispatch rule written as a predicate and the
  kernel's coverage at once.
* A tp rank's int4 leaves are column slices (w_gate / w_up / wq / wk /
  wv split on N; K stays whole), so each rank launches the kernel on
  its own slice. The reference turns its kernel off under tp
  (`_no_int4_kernel`) only because GSPMD cannot partition a Pallas
  call; the port's ranks run local slices, where that does not apply.

Nothing is built or imported from the CUDA toolchain when this module
is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .flash import INT4_LAUNCHES_BY_SHAPE, LAUNCHES, _report_flops

MAX_M = 256   # flattened batch rows the kernel takes (decode, short prefill)
_BN = 512     # the reference's column block; its divisibility rule stays


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




# -- launch plan ---------------------------------------------------------------
#
# The kernel's geometry, in plain Python so that the CPU tests reach it.
# `ops/csrc/int4_matmul.cu` mirrors it: kBN/kBKP/kMaxStages and
# stage_bytes() for the constants below, and the `Walk` struct for
# `Int4Plan.unit` / `Int4Plan.units`.

TILE_N = 128        # columns of a work unit (kBN)
TILE_KP = 64        # packed rows of a K step, one ring stage (kBKP)
DECODE_MAX_M = 16   # the decode variant's rows (one m16 tile)
MAX_STAGES = 6      # ring depth (kMaxStages)
SMEM_PER_SM = 232448 - 2 * 1024  # bytes a block may use, less the
                                 # driver's 1 KB reserve per block
MIN_STEPS_PER_BLOCK = 2  # K steps of a split at least
UNIT_COST_STEPS = 2  # a unit's own cost (epilogue, split sum), in K steps
# the wide kernel's last split reads every other split's partial (up to
# 256 x 128 fp32): its cost per split, in K steps of that tile
WIDE_SPLIT_SUM_STEPS = 0.5
WIDE_WU_BYTES = 2 * TILE_KP * TILE_N * 2  # the unpacked tile (kWideWu)


def _scale_rows(gsize: int) -> int:
    """Scale rows one K step of TILE_KP packed rows touches in each
    half (its start is a multiple of TILE_KP; G is even)."""
    return 1 if gsize % TILE_KP == 0 else (TILE_KP - 1) // gsize + 2


def variant_of(m: int) -> Tuple[str, int, int, int]:
    """(variant, block_m, blocks per SM, extra shared bytes) of a launch
    with m rows. decode: x padded to 16 rows, two consumer warpgroups
    taking turns (they hand over their sums in 8 KB, kXchg), two blocks
    per SM up to 8 rows and one above (decode_blocks_per_sm in the
    kernel). wide: x padded to 64, 128 or 256 rows, one block per SM
    with the double-buffered unpacked tile. Either way one m tile holds
    every row of x."""
    if m <= DECODE_MAX_M:
        return ("decode", DECODE_MAX_M, 2 if m <= 8 else 1,
                DECODE_MAX_M * 128 * 4)
    block_m = 64 if m <= 64 else 128 if m <= 128 else 256
    return "wide", block_m, 1, 2 * WIDE_WU_BYTES


def stage_bytes(block_m: int, gsize: int) -> int:
    """Shared bytes of one ring stage: the packed tile, the x columns
    of both halves (128-byte rows of 64 bf16), the scale rows of both
    halves (fp32)."""
    return (TILE_KP * TILE_N + 2 * block_m * 128
            + 2 * _scale_rows(gsize) * TILE_N * 4)


class Int4Plan(NamedTuple):
    """How one `int4_matmul` launch walks its work.

    Every row of x sits in one m tile of `block_m` rows. A tile is one
    column tile of `tile_n` columns; its `steps` K steps are cut into
    `splits` contiguous splits, split s taking steps [s * steps //
    splits, (s + 1) * steps // splits). A work unit is one (split, tile)
    pair, numbered split first, `u = split * tiles + tile`, so units that
    run at the same time read the same packed rows of neighbouring
    columns. Block b of the persistent grid walks units b, b + grid,
    b + 2 grid, ..., its ring running on from one unit into the next.
    The last split of a tile to finish adds all of them in split
    order."""

    variant: str    # "decode" (m <= 16) or "wide"
    block_m: int    # x rows padded: 16; wide 64, 128 or 256
    tile_n: int
    tiles: int      # column tiles
    tile_kp: int
    steps: int      # K steps of a tile: ceil(K/2 / tile_kp)
    splits: int     # K splits of every tile
    grid: int       # persistent blocks
    stages: int     # ring depth
    smem: int       # dynamic shared bytes of a block

    @property
    def n_units(self) -> int:
        return self.tiles * self.splits

    def unit(self, u: int) -> Tuple[int, int, int, int]:
        """Unit u as (tile, split, first step, end step)."""
        split, tile = divmod(u, self.tiles)
        return (tile, split, split * self.steps // self.splits,
                (split + 1) * self.steps // self.splits)

    def units(self, b: int) -> List[Tuple[int, int, int, int]]:
        """Block b's units in walk order."""
        return [self.unit(u) for u in range(b, self.n_units, self.grid)]


def int4_plan(m: int, k: int, n: int, gsize: int, sm_count: int
              ) -> Int4Plan:
    """The launch of `int4_matmul` for x [m, k] against a [k, n] int4
    leaf of group size `gsize` (a shape `int4_eligible` admits) on a
    card of `sm_count` SMs: the variant, tiles, K steps, splits and the
    persistent grid (at most `variant_of`'s blocks on every SM). The
    splits minimise the work of the busiest block, rounds of units x
    (steps per split + UNIT_COST_STEPS), plus the last split's sum of
    the others' partials, the fewest splits among equals."""
    variant, block_m, per_sm, extra = variant_of(m)
    tiles = n // TILE_N
    steps = -(-(k // 2) // TILE_KP)
    slots = per_sm * sm_count
    # the decode kernel's partials (16 rows) are summed at no cost that
    # shows; the wide kernel's cost WIDE_SPLIT_SUM_STEPS each
    reduce_cost = WIDE_SPLIT_SUM_STEPS if variant == "wide" else 0
    splits, cost = 1, None
    for s in range(1, max(1, steps // MIN_STEPS_PER_BLOCK) + 1):
        c = (-(-tiles * s // slots) * (-(-steps // s) + UNIT_COST_STEPS)
             + (s - 1) * reduce_cost)
        if cost is None or c < cost:
            splits, cost = s, c
    sb = stage_bytes(block_m, gsize)
    stages = min(MAX_STAGES, (SMEM_PER_SM // per_sm - 1024 - extra) // sb)
    # the decode variant's two warpgroups own half the ring each; at
    # least 2 stages (tiny G only may need fewer blocks per SM then)
    if variant == "decode":
        stages -= stages % 2
    stages = max(stages, 2)
    return Int4Plan(variant, block_m, TILE_N, tiles, TILE_KP, steps, splits,
                    min(tiles * splits, slots), stages,
                    1024 + stages * sb + extra)


# -- the CUDA launch -------------------------------------------------------------


# (device index, stream) -> (fp32 split partials, int32 tile counters):
# allocated once and grown, never per launch. The kernel leaves every
# counter at 0 when it ends, so launches on one stream reuse them.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev: torch.device, stream: int, plan: Int4Plan
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, stream)
    n_part = plan.n_units * plan.block_m * TILE_N if plan.splits > 1 else 1
    part, cnt = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if cnt is None or cnt.numel() < plan.tiles:
        cnt = torch.zeros(plan.tiles, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, cnt)
    return part, cnt


def int4_matmul(x: torch.Tensor, qt, out_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """y[..., N] = x[..., K] @ dequant(qt) in `out_dtype`: the CUDA
    kernel for a CUDA tensor (counted as LAUNCHES["int4_matmul"] and by
    (K, N) in INT4_LAUNCHES_BY_SHAPE; a shape outside `int4_eligible`
    raises), the plain version for a CPU tensor."""
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
        if t.data_ptr() % 16:  # TMA reads from 16-byte aligned bases
            raise ValueError(f"int4_matmul: {what} is not 16-byte "
                             f"aligned")
    lead = x.shape[:-1]
    m = math.prod(lead)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    x2 = x.reshape(m, k).to(torch.bfloat16)
    if k % 8:
        # TMA needs 16-byte row strides; the dispatch rule gives k % 4
        x2 = torch.nn.functional.pad(x2, (0, 4))
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    from . import _build
    plan = int4_plan(m, k, n, gsize, _build.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, cnt = _scratch(dev, stream, plan)
    fn = _build.kernel("int4_matmul")
    with torch.cuda.device(dev):  # the C side launches on the current card
        rc = fn(x2.data_ptr(), qp2.data_ptr(), s2.data_ptr(),
                out.data_ptr(), part.data_ptr(), cnt.data_ptr(), m, k,
                x2.shape[1], n, gsize, plan.block_m, plan.splits,
                plan.grid, plan.stages, int(out_dtype == torch.bfloat16),
                stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul: kernel launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["int4_matmul"] += 1
    INT4_LAUNCHES_BY_SHAPE[(k, n)] = INT4_LAUNCHES_BY_SHAPE.get((k, n), 0) + 1
    _report_flops(lambda: 2 * m * k * n)
    return out.reshape(*lead, n)
