"""The launch plan of the port's int4 kernel (B4), on the CPU.

`ops/int4_matmul.int4_plan` sizes every launch of the CUDA kernel: the
variant, the tiles, the K steps, the splits of each work unit and the
persistent grid, in plain Python that the kernel mirrors. These tests
hold it to what the kernel relies on:

* coverage: for every int4 leaf of Llama-3-8B that the kernel serves
  (wq, wk, wv, w_gate, w_up), for w_down's shape and for the small
  shapes of tests/test_torch_int4_matmul.py, at decode and short-prefill
  row counts and three SM counts, the blocks' units cover every (column
  tile, K step) exactly once; each split's steps are contiguous,
  the splits of a tile are numbered in K order, the units are dealt
  evenly over the persistent grid, and blocks side by side read the
  same split;
* a numpy emulation of the kernel's walk, against `int4_matmul_ref`
  (and through it the reference kernel, see test_torch_int4_matmul.py):
  each unit's partial product over its K steps, read as the kernel's
  TMA boxes read it (64 packed rows, both halves, zero past the edges),
  each tile's partials added in split order. Its fp32 result is within 1e-5 of
  max |y| of the plain version (the two differ only in summation
  order) and lands on the same bits whatever order the units are
  visited in;
* the variant at the m 16 / 17 edge, and a plan for every shape that
  `int4_eligible` admits among the reference's fallback cases.
"""

import math

import numpy as np
import pytest
import torch

from ome_tpu_torch.models import quant
from ome_tpu_torch.ops import int4_matmul

RTOL_OF_MAX = 1e-5
SM_COUNTS = (132, 114, 8)
ROWS = (1, 5, 8, 16, 17, 64, 256)
# (K, N) of Llama-3-8B's int4 leaves (wq; wk and wv; w_gate and w_up),
# w_down's, and the small shapes of test_torch_int4_matmul.py
SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
          "w_down": (14336, 4096), "small_gate": (1024, 512),
          "small_wk": (1024, 256), "small_square": (1024, 1024)}


def _check_walk(plan, m, k, n):
    """Every (column tile, K step) exactly once; splits contiguous,
    non-empty and numbered in K order; the units dealt round-robin over
    a grid that has no idle block; one m tile holds every row of x."""
    assert m <= plan.block_m
    assert plan.tiles * plan.tile_n == n
    assert plan.steps == -(-(k // 2) // plan.tile_kp)
    assert 1 <= plan.splits <= plan.steps
    assert 1 <= plan.grid <= plan.n_units
    assert 2 <= plan.stages <= int4_matmul.MAX_STAGES
    if plan.variant == "decode":  # two warpgroups, half the ring each
        assert plan.stages % 2 == 0
    assert plan.smem <= 227 * 1024
    seen = np.zeros((plan.tiles, plan.steps), np.int32)
    pieces = {}
    counts = []
    for b in range(plan.grid):
        units = plan.units(b)
        counts.append(len(units))
        for tile, split, lo, hi in units:
            assert 0 <= lo < hi <= plan.steps
            seen[tile, lo:hi] += 1
            pieces.setdefault(tile, []).append((split, lo, hi))
    assert (seen == 1).all()
    assert max(counts) - min(counts) <= 1
    for ps in pieces.values():
        assert len(ps) == plan.splits
        ps.sort()
        assert [p[0] for p in ps] == list(range(plan.splits))
        assert ps[0][1] == 0 and ps[-1][2] == plan.steps
        for (_, _, hi), (_, lo, _) in zip(ps, ps[1:]):
            assert hi == lo  # contiguous, in K order
    # units that run side by side (one per block, in block order) share
    # their split: the same packed rows of neighbouring columns
    first = [plan.units(b)[0][1] for b in range(plan.grid)]
    assert first == sorted(first)


@pytest.mark.parametrize("sm", SM_COUNTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_covers_every_step_once(shape, sm):
    k, n = SHAPES[shape]
    for m in ROWS:
        plan = int4_matmul.int4_plan(m, k, n, 128, sm)
        _check_walk(plan, m, k, n)
        # the persistent grid: at most its blocks per SM on each SM
        assert plan.grid <= int4_matmul.variant_of(m)[2] * sm


def _emulate(plan, x, qp2, s2, gsize, order):
    """The kernel's walk in numpy, fp32: block by block in `order`, each
    unit's K steps as the kernel's boxes read them, then each unit's
    partials added in split order."""
    m, k = x.shape
    kp, n = qp2.shape
    kx = k if k % 8 == 0 else k + 4  # the wrapper's padded copy of x
    bkp, bn, bm = plan.tile_kp, plan.tile_n, plan.block_m
    # x rounded to bf16; rows past m and columns past kx read as zero
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    xpad = np.zeros((bm, kx + 2 * bkp), np.float32)
    xpad[:m, :k] = xb
    q = qp2.astype(np.int32)
    lo_w, hi_w = (q << 28) >> 28, q >> 4
    srow = np.arange(kp) // gsize

    def dq(v, rows):  # bf16(f32 nibble x f32 scale)
        return torch.from_numpy(
            v.astype(np.float32) * s2[rows]).bfloat16().float().numpy()
    wl = np.zeros((plan.steps * bkp, n), np.float32)
    wh = np.zeros_like(wl)
    wl[:kp] = dq(lo_w, srow)
    wh[:kp] = dq(hi_w, srow + kp // gsize)
    partial = {}
    for b in order:
        for tile, split, s0, s1 in plan.units(b):
            c = slice(tile * bn, tile * bn + bn)
            acc = np.zeros((bm, bn), np.float32)
            for step in range(s0, s1):
                j0 = step * bkp
                acc += xpad[:, j0:j0 + bkp] @ wl[j0:j0 + bkp, c]
                acc += xpad[:, kp + j0:kp + j0 + bkp] @ wh[j0:j0 + bkp, c]
            partial[(tile, split)] = acc
    y = np.zeros((bm, n), np.float32)
    for tile in range(plan.tiles):
        tot = partial[(tile, 0)].copy()
        for split in range(1, plan.splits):
            tot += partial[(tile, split)]
        y[:, tile * bn:tile * bn + bn] = tot
    return y[:m]


@pytest.mark.parametrize("m,k,n,gsize,sm", [
    (5, 1024, 512, 128, 8),     # decode, several splits per unit
    (16, 1024, 256, 128, 3),    # decode, the grid smaller than the units
    (17, 1024, 256, 128, 8),    # wide: 64 rows, rows past m zero
    (64, 1024, 512, 128, 132),  # wide, one split per unit
    (80, 1024, 256, 128, 5),    # wide: 128 rows
    (3, 192, 128, 32, 4),       # ragged last step, several scale rows
    (4, 12, 128, 2, 2),         # K % 8 == 4: x padded for TMA's stride
])
def test_emulated_walk_matches_plain_version(m, k, n, gsize, sm):
    rng = np.random.default_rng(m * 131 + k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qt = quant.quantize_tensor_int4(w, (0,), group=gsize)
    assert int4_matmul.int4_eligible((m, k), qt)
    qp2, s2, k2, n2, g2 = int4_matmul.flatten_qtensor(qt)
    assert (k2, n2, g2) == (k, n, gsize)
    x = rng.standard_normal((m, k)).astype(np.float32)
    plan = int4_matmul.int4_plan(m, k, n, gsize, sm)
    _check_walk(plan, m, k, n)
    qp2, s2 = qp2.numpy(), s2.float().numpy()
    got = _emulate(plan, x, qp2, s2, gsize, range(plan.grid))
    want = int4_matmul.int4_matmul_ref(torch.from_numpy(x), qt,
                                       torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(want).max())
    # the sum's order is the split order, whoever finishes last
    again = _emulate(plan, x, qp2, s2, gsize, reversed(range(plan.grid)))
    assert np.array_equal(got.view(np.uint32), again.view(np.uint32))


@pytest.mark.parametrize("sm", SM_COUNTS)
def test_variant_at_the_decode_edge(sm):
    # the decode variant up to 16 rows; the wide one holds every row of x
    # (padded to 64, 128 or 256), so each weight is unpacked once
    for k, n in SHAPES.values():
        for m, variant, block_m in ((1, "decode", 16), (8, "decode", 16),
                                    (16, "decode", 16), (17, "wide", 64),
                                    (64, "wide", 64), (65, "wide", 128),
                                    (128, "wide", 128), (129, "wide", 256),
                                    (256, "wide", 256)):
            p = int4_matmul.int4_plan(m, k, n, 128, sm)
            assert (p.variant, p.block_m) == (variant, block_m), (m, k, n)


def test_every_eligible_shape_has_a_plan():
    """The reference's fallback cases (test_torch_int4_matmul.py) with
    the port's quantizer: where `int4_eligible` admits x, the plan
    covers it."""
    rng = np.random.default_rng(1)

    def leaf(shape, axes, group):
        w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return quant.quantize_tensor_int4(w, axes, group=group)
    gate = leaf((1024, 256), (0,), 128)
    cases = [((16, 8 * 128), leaf((8, 128, 256), (1, 0), 128), False),
             ((4, 192), leaf((192, 256), (0,), 64), False),
             ((512, 1024), gate, False), ((4, 1024), gate, True),
             ((4, 512), gate, False), ((1, 2, 3, 1024), gate, True),
             ((256, 1024), gate, True), ((12, 192), leaf((192, 128), (0,),
                                                         32), True)]
    for x_shape, qt, want in cases:
        assert int4_matmul.int4_eligible(x_shape, qt) is want, x_shape
        if not want:
            continue
        _, _, k, n, gsize = int4_matmul.flatten_qtensor(qt)
        m = math.prod(x_shape[:-1])
        for sm in SM_COUNTS:
            _check_walk(int4_matmul.int4_plan(m, k, n, gsize, sm), m, k, n)
