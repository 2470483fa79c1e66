"""The prefill kernel's KV-tile walk, `ome_tpu_torch.ops.flash.
prefill_tile_plan`, held against the reference and a brute-force mask.

* Against `ome_tpu.ops.flash._prefill_block_range` and the `process`
  predicate of `_prefill_kernel`: with equal q-tile and KV-tile sizes
  (the reference's own tiling), the plan walks every tile the Pallas
  kernel processes except those that hold no valid pair (the reference
  can process one such tile where the window starts past kv_hi, all of
  it masked), over seeded bases, kv_hi, windows and q tiles; and the
  same at the CUDA kernel's q tiles for group sizes that do not divide
  64 (G 3, 5, 6, 7: floor(64 / G) positions per warpgroup).
* Against the mask `flash_prefill_ref` applies, at the CUDA kernel's
  tile sizes (KV tiles of 64 and 128 rows; q tiles of
  `prefill_block_positions(G, 1 or 2)` positions, G in 1-8 and 16):
  every valid (row, column) pair lies in a walked tile, every walked
  tile holds a valid pair, and every tile marked full has all its pairs
  valid.
* Edge cases: kv_hi inside a tile, the window starting inside a tile,
  a partial last q tile, kv_hi <= base (an empty walk), a base past the
  cache.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ome_tpu.ops.flash import _prefill_block_range
from ome_tpu_torch.ops.flash import prefill_block_positions, prefill_tile_plan


def _valid(base, kv_hi, q0, nq, window, cols):
    """[nq, cols] bool: the pairs flash_prefill_ref lets through."""
    pos = base + q0 + np.arange(nq)[:, None]
    col = np.arange(cols)[None, :]
    ok = (col <= pos) & (col < kv_hi)
    if window:
        ok &= col > pos - window
    return ok


def _reference_tiles(base, kv_hi, qi, bq, bs, window, n_kv_tiles):
    """Tiles `_prefill_kernel` processes for q block qi: its grid walks
    ki = 0 .. n_kv_tiles - 1 over the clamped `_prefill_block_range`,
    and `process` keeps the steps with a valid pair."""
    first, last = (int(x) for x in _prefill_block_range(
        jnp.int32(base), jnp.int32(kv_hi), jnp.int32(qi), bq, bs, window))
    q_lo = base + qi * bq
    q_hi = q_lo + bq - 1
    tiles = []
    for ki in range(n_kv_tiles):
        start = min(first + ki, last) * bs
        process = first + ki <= last and start <= q_hi and start < kv_hi
        if window is not None:
            process = process and start + bs > q_lo - window + 1
        if process:
            tiles.append(start // bs)
    return tiles


def _reference_cases(seed, n=40):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        bs = int(rng.choice([16, 32, 64]))
        S = bs * int(rng.integers(2, 9))
        Sq = bs * int(rng.integers(1, 5))
        base = int(rng.integers(0, S))
        kv_hi = int(rng.integers(0, S + 1))
        window = None if rng.random() < 0.4 else int(rng.integers(1, S))
        yield bs, S, Sq, base, kv_hi, window


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_matches_reference_block_range(seed):
    for bs, S, Sq, base, kv_hi, window in _reference_cases(seed):
        for qi in range(Sq // bs):
            ref = _reference_tiles(base, kv_hi, qi, bs, bs, window,
                                   S // bs)
            t0, ntiles, full = prefill_tile_plan(base, kv_hi, qi * bs, bs,
                                                 bs, window)
            walked = list(range(t0, t0 + ntiles))
            valid = _valid(base, kv_hi, qi * bs, bs, window, S + bs)
            useful = [t for t in ref
                      if valid[:, t * bs:(t + 1) * bs].any()]
            assert walked == useful, (bs, S, base, kv_hi, window, qi)
            assert len(full) == ntiles


@pytest.mark.parametrize("G", [3, 5, 6, 7])
@pytest.mark.parametrize("consumers", [1, 2])
def test_plan_matches_reference_at_folded_q_tiles(G, consumers):
    """The reference's block range at the CUDA kernel's q tile for a G
    that does not divide 64, over KV tiles of 64 and 128 rows."""
    bq = prefill_block_positions(G, consumers)
    assert bq == consumers * (64 // G)
    rng = np.random.default_rng(100 * G + consumers)
    for _ in range(40):
        bs = int(rng.choice([64, 128]))
        S = bs * int(rng.integers(2, 9))
        Sq = bq * int(rng.integers(1, 12))
        base = int(rng.integers(0, S))
        kv_hi = int(rng.integers(0, S + 1))
        window = None if rng.random() < 0.4 else int(rng.integers(1, S))
        for qi in range(Sq // bq):
            ref = _reference_tiles(base, kv_hi, qi, bq, bs, window,
                                   S // bs)
            t0, ntiles, full = prefill_tile_plan(base, kv_hi, qi * bq, bq,
                                                 bs, window)
            valid = _valid(base, kv_hi, qi * bq, bq, window, S + bs)
            useful = [t for t in ref
                      if valid[:, t * bs:(t + 1) * bs].any()]
            assert list(range(t0, t0 + ntiles)) == useful, (
                bs, S, base, kv_hi, window, qi)
            assert len(full) == ntiles


def _check_against_mask(base, kv_hi, q0, nq, bn, window, S):
    cols = max(S, kv_hi, base + q0 + nq) + bn
    valid = _valid(base, kv_hi, q0, nq, window, cols)
    t0, ntiles, full = prefill_tile_plan(base, kv_hi, q0, nq, bn, window)
    walked = set(range(t0, t0 + ntiles))
    need = {c // bn for c in np.nonzero(valid.any(axis=0))[0]}
    assert need <= walked, ("valid pair outside the walk", sorted(
        need - walked))
    for i, t in enumerate(range(t0, t0 + ntiles)):
        tile = valid[:, t * bn:(t + 1) * bn]
        assert tile.any(), ("walked tile with no valid pair", t)
        if full[i]:
            assert tile.all(), ("tile marked full has a masked pair", t)
    return t0, ntiles, full


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 3, 5, 6, 7, 16])
@pytest.mark.parametrize("consumers", [1, 2])
def test_plan_against_brute_force_mask(bn, G, consumers):
    rng = np.random.default_rng(1000 * bn + 10 * G + consumers)
    bq = prefill_block_positions(G, consumers)
    for _ in range(25):
        S = int(rng.integers(1, 1200))
        Sq = int(rng.integers(1, 700))
        base = int(rng.integers(0, S))
        kv_hi = int(rng.integers(0, S + 1))
        window = None if rng.random() < 0.4 else int(rng.integers(1, 600))
        for q0 in range(0, Sq, bq):
            _check_against_mask(base, kv_hi, q0, min(bq, Sq - q0), bn,
                                window, S)


@pytest.mark.parametrize("case", [
    # kv_hi inside a tile: the tile is walked and not full
    dict(base=0, kv_hi=1000, q0=992, nq=32, bn=128, window=None,
         tiles=(0, 8), partial={7}),
    # the window starts inside a tile: its first tile is not full
    dict(base=0, kv_hi=2048, q0=1024, nq=32, bn=128, window=500,
         tiles=(4, 5), partial={4, 8}),
    # a partial last q tile (nq < tile): only its own rows count
    dict(base=0, kv_hi=1000, q0=992, nq=8, bn=64, window=None,
         tiles=(0, 16), partial={15}),
    # a suffix chunk: the prefix tiles are full, the diagonal is not
    dict(base=1024, kv_hi=1536, q0=0, nq=32, bn=128, window=None,
         tiles=(0, 9), partial={8}),
])
def test_plan_edge_cases(case):
    t0, ntiles, full = _check_against_mask(
        case["base"], case["kv_hi"], case["q0"], case["nq"], case["bn"],
        case["window"], case["kv_hi"])
    assert (t0, ntiles) == case["tiles"]
    assert {t0 + i for i, f in enumerate(full) if not f} == case["partial"]


@pytest.mark.parametrize("base,kv_hi,S,ntiles,partial", [
    (100, 100, 256, 2, 1),   # kv_hi == base: the first row sees column 99
    (100, 0, 256, 0, 0),     # an empty cache: nothing to walk
    (300, 256, 256, 4, 0),   # a base past the cache: all of it, unmasked
])
def test_plan_short_or_empty_cache(base, kv_hi, S, ntiles, partial):
    t0, n, full = _check_against_mask(base, kv_hi, 0, 32, 64, None, S)
    assert n == ntiles
    assert sum(not f for f in full) == partial


def test_plan_window_past_kv_hi_is_empty():
    # every row's window starts after the last valid column
    t0, ntiles, full = _check_against_mask(2000, 500, 0, 32, 128, 100,
                                           2048)
    assert ntiles == 0 and full == []
