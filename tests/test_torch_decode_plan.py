"""The launch plan of the port's decode core (B1, B3, B5), on the CPU.

`ops/flash.decode_plan` states how the CUDA decode core
(`ops/csrc/decode_core.cuh`) cuts and walks its work: each (sequence,
KV head) window [lo, hi) is cut from its 64-row-aligned start into
units of `UNIT_ROWS` rows, units are numbered sequence by sequence, a
persistent grid deals them round robin, and the last unit of a window
merges the window's partials in unit order. These tests hold it to what
the kernel relies on:

* coverage: every row of every window is covered exactly once per (b,
  kh), for lengths 0, 1, 17, 63, 64, 300, 4095, 4096, 5000 (past M *
  bs) and windows that start inside a tile; every unit lies in exactly
  one block's walk, and the grid has no idle block beyond the units the
  windows can have;
* batch invariance: a window's units (and so its partials and its merge)
  do not change when the other sequences' lengths or the grid change;
* a numpy emulation of the kernel's walk (64-row tiles, logits of rows
  outside [lo, hi) selected to M_INIT, V rows outside zeroed, P rounded
  to bf16 as the reference's `pb = p.astype(v_blk.dtype)` does, int8
  scales folded into the logits and probabilities, the merge in unit
  order) against `flash_decode_ref`, `flash_paged_decode_ref` and,
  through numpy inputs, `ome_tpu.ops.paged.paged_attention_xla`. The
  tolerance is 1e-2: P in bf16 carries a relative error of at most 2^-9
  per probability, and the output is a convex combination of V rows
  whose entries here stay below 5 in magnitude (2^-9 x 5 < 1e-2); the
  plain versions keep P in fp32. The emulation lands on the same bits
  whatever order the units are visited in. The walks run at G 4 and
  at the group sizes that are not powers of two (G 3, 5, 6, 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.ops.paged import paged_attention_xla as jax_paged_xla
from ome_tpu_torch.ops import flash, paged

LENGTHS = [0, 1, 17, 63, 64, 300, 4095, 4096, 5000]
LIMIT = 4096          # M * bs of the paged cases, S of the dense ones
ATOL = 1e-2
SM_COUNTS = (132, 114, 8, 1)


def _rows_of(plan, b, kh):
    """Rows each unit of window (b, kh) covers inside [lo, hi)."""
    w = plan.windows[b]
    out = []
    for u in plan.merge_order(b, kh):
        ub, ukh, j, r0, r1 = plan.unit(u)
        assert (ub, ukh) == (b, kh)
        assert r0 % flash.TILE_ROWS == 0 or r0 == r1 == 0
        out.append((j, max(r0, w.lo), min(r1, w.hi)))
    return out


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("windowed", [False, True])
def test_every_row_once(sm_count, windowed):
    K = 3
    hi = LENGTHS
    lo = [max(h - 257, 0) if windowed else 0 for h in hi]
    plan = flash.decode_plan(lo, hi, K, LIMIT, sm_count)
    assert plan.n_units <= plan.max_units
    assert 1 <= plan.grid <= plan.max_units
    assert plan.grid <= sm_count * flash.TC_BLOCKS_PER_SM
    for b, (a, z) in enumerate(zip(lo, hi)):
        a_c, z_c = max(a, 0), min(z, LIMIT)
        for kh in range(K):
            covered = np.zeros(LIMIT, np.int32)
            units = _rows_of(plan, b, kh)
            assert [j for j, _, _ in units] == list(range(len(units)))
            assert len(units) == plan.windows[b].n >= 1
            for _, r0, r1 in units:
                covered[r0:max(r1, r0)] += 1
            want = np.zeros(LIMIT, np.int32)
            want[a_c:z_c] = 1
            assert (covered == want).all(), (b, kh)
    walked = sorted(u for blk in range(plan.grid) for u in plan.units(blk))
    assert walked == list(range(plan.n_units))


@pytest.mark.parametrize("unit_rows", [64, 256, 512])
def test_unit_sizes(unit_rows):
    plan = flash.decode_plan([0, 100, 0], [4096, 4000, 0], 2, LIMIT, 132,
                             unit_rows=unit_rows)
    assert plan.windows[0].n == 4096 // unit_rows
    assert plan.windows[1].alo == 64
    assert plan.windows[1].n == -(-(4000 - 64) // unit_rows)
    assert plan.windows[2] == flash.DecodeWindow(0, 0, 0, 1)
    # an empty window is one unit with no rows
    assert plan.unit(plan.merge_order(2, 1)[0])[3:] == (0, 0)


@pytest.mark.parametrize("seed", range(4))
def test_a_window_does_not_depend_on_the_batch(seed):
    rng = np.random.default_rng(seed)
    K = 4
    hi = rng.integers(0, 6000, 12).tolist()
    lo = [max(h - int(rng.integers(1, 5000)), 0) for h in hi]
    base = flash.decode_plan(lo, hi, K, LIMIT, 132)
    other_hi = list(hi)
    other_lo = list(lo)
    for b in range(0, 12, 2):   # change every other sequence
        other_hi[b] = int(rng.integers(0, 6000))
        other_lo[b] = 0
    for sm in SM_COUNTS:
        plan = flash.decode_plan(other_lo, other_hi, K, LIMIT, sm)
        for b in range(1, 12, 2):
            for kh in range(K):
                rows = [plan.unit(u)[2:] for u in plan.merge_order(b, kh)]
                assert rows == [base.unit(u)[2:]
                                for u in base.merge_order(b, kh)]


def test_grid_is_bounded_by_what_the_host_knows():
    grid, max_units = flash.decode_grid(8, 8, 4096, 132)
    assert max_units == 8 * 8 * -(-4096 // flash.UNIT_ROWS)
    assert grid == min(132 * flash.TC_BLOCKS_PER_SM, max_units)
    assert flash.decode_grid(1, 1, 64, 132) == (1, 1)
    assert flash.decode_grid(2, 8, 4096, 132, tensor_cores=False)[0] == \
        min(132 * flash.SCALAR_BLOCKS_PER_SM, 2 * 8 * -(-4096 //
                                                        flash.UNIT_ROWS))


# -- the kernel's walk, emulated in numpy ----------------------------------------


def _bf16(x):
    """Round fp32 to bf16 (nearest even), kept in fp32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _emulate(plan, q, rows_k, rows_v, scale, softcap, order,
             rows_ks=None, rows_vs=None):
    """The kernel's walk: q [B, H, D]; rows_k(b, r) -> [n, K, D] rows of
    sequence b (rows_ks -> [n, K] int8 k-scales); units visited in
    `order`, merged per window in unit order."""
    B, H, D = q.shape
    K = plan.K
    G = H // K
    T = flash.TILE_ROWS
    parts = {}
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for u in order:
            b, kh, j, r0, r1 = plan.unit(u)
            w = plan.windows[b]
            qg = q[b, kh * G:(kh + 1) * G]                  # [G, D]
            m = np.full(G, flash.M_INIT, np.float32)
            l = np.zeros(G, np.float32)
            acc = np.zeros((G, D), np.float32)
            for t0 in range(r0, r1, T):
                rows = np.arange(t0, t0 + T)
                valid = (rows >= w.lo) & (rows < w.hi)
                kt = rows_k(b, rows)[:, kh]                 # [T, D]
                vt = rows_v(b, rows)[:, kh]
                s = (kt @ qg.T).astype(np.float32)          # [T, G]
                if rows_ks is not None:
                    s = s * rows_ks(b, rows)[:, kh, None]
                s = s * np.float32(scale)
                if softcap:
                    s = np.tanh(s / np.float32(softcap)) * np.float32(softcap)
                s = np.where(valid[:, None], s, np.float32(flash.M_INIT))
                m_new = np.maximum(m, s.max(axis=0))
                alpha = np.exp(m - m_new)
                p = np.where(valid[:, None], np.exp(s - m_new), 0.0
                             ).astype(np.float32)
                l = l * alpha + p.sum(axis=0)
                if rows_vs is not None:
                    p = np.where(valid[:, None],
                                 p * rows_vs(b, rows)[:, kh, None], 0.0)
                pb = _bf16(p)
                vt = np.where(valid[:, None], vt, 0.0).astype(np.float32)
                acc = acc * alpha[:, None] + pb.T @ vt
                m = m_new
            parts[u] = (m, l, acc)
    out = np.zeros((B, H, D), np.float32)
    for b in range(B):
        for kh in range(K):
            us = plan.merge_order(b, kh)
            mx = np.max([parts[u][0] for u in us], axis=0)
            lsum = np.zeros(G, np.float32)
            a = np.zeros((G, D), np.float32)
            for u in us:
                f = np.exp(parts[u][0] - mx)
                lsum = lsum + parts[u][1] * f
                a = a + parts[u][2] * f[:, None]
            out[b, kh * G:(kh + 1) * G] = a / np.maximum(lsum, 1e-30)[:, None]
    return out


def _orders(plan):
    walk = [u for blk in range(plan.grid) for u in plan.units(blk)]
    return walk, walk[::-1]


def _check_orders(plan, *args, **kw):
    first, second = (_emulate(plan, *args, order=o, **kw)
                     for o in _orders(plan))
    assert np.array_equal(first, second)
    return first


B, H, K, D = 6, 8, 2, 16
G = H // K


def _q(rng):
    return _bf16(rng.standard_normal((B, H, D)).astype(np.float32))


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("window", [None, 100])
def test_emulated_dense_walk_matches_flash_decode_ref(softcap, window):
    rng = np.random.default_rng(1)
    S = 700          # not a multiple of the 64-row tile
    q = _q(rng)
    k = _bf16(rng.standard_normal((B, S, K, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((B, S, K, D)).astype(np.float32))
    hi = np.array([0, 1, 17, 64, 300, 700])
    lo = np.maximum(hi - window, 0) if window else np.zeros_like(hi)
    # rows outside the windows are NaN: a tile past S reads the next
    # sequence's rows, whose head lies outside its window when windowed
    kn, vn = k.copy(), v.copy()
    for b in range(B):
        outside = np.ones(S, bool)
        outside[lo[b]:hi[b]] = False
        kn[b, outside] = np.nan
        vn[b, outside] = np.nan
    flat_k, flat_v = kn.reshape(B * S, K, D), vn.reshape(B * S, K, D)

    def rows(flat):
        def get(b, r):  # dense address b * S + r; past the cache: zeros
            idx = b * S + r
            out = np.zeros((len(r), K, D), np.float32)
            ok = idx < B * S
            out[ok] = flat[idx[ok]]
            return out
        return get
    plan = flash.decode_plan(lo, hi, K, S, 132, unit_rows=128)
    got = _check_orders(plan, q, rows(flat_k), rows(flat_v), D ** -0.5,
                        softcap)
    ref = flash.flash_decode_ref(
        torch.from_numpy(q)[:, None], torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(lo), torch.from_numpy(hi),
        D ** -0.5, softcap)[:, 0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def _pool(rng, N, bs, int8):
    kp = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    if not int8:
        return _bf16(kp), _bf16(vp), None, None
    kq, ks = flash.quantize_kv_block(torch.from_numpy(kp))
    vq, vs = flash.quantize_kv_block(torch.from_numpy(vp))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


@pytest.mark.parametrize("bs", [32, 64])
@pytest.mark.parametrize("int8", [False, True])
def test_emulated_paged_walk_matches_the_plain_versions(bs, int8):
    """B3 over a paged pool, a trash-table slot whose length runs past
    M * bs among them, against flash_paged_decode_ref and the JAX
    package's paged_attention_xla."""
    rng = np.random.default_rng(2)
    M = 256 // bs
    N = B * M + 1
    kp, vp, ks, vs = _pool(rng, N, bs, int8)
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    table = table.astype(np.int32)
    table[5] = 0                                     # a free slot
    kv_len = np.array([1, 17, 63, 64, 256, 300])     # 300 > M * bs
    q = _q(rng)

    def rows(pool):
        def get(b, r):
            blk = table[b, np.minimum(r // bs, M - 1)]
            return pool[blk, r % bs].astype(np.float32)
        return get

    def scale_rows(sp):
        def get(b, r):                                # [n, K]
            blk = table[b, np.minimum(r // bs, M - 1)]
            return sp[blk, :, r % bs]
        return get
    plan = flash.decode_plan(np.zeros(B, int), kv_len, K, M * bs, 132,
                             unit_rows=128)
    got = _check_orders(
        plan, q, rows(kp), rows(vp), D ** -0.5, None,
        rows_ks=scale_rows(ks) if int8 else None,
        rows_vs=scale_rows(vs) if int8 else None)
    t = torch.from_numpy
    ref = paged.flash_paged_decode_ref(
        t(q)[:, None], t(kp), t(vp), t(table), torch.zeros(B, dtype=int),
        t(kv_len), D ** -0.5, k_scale=t(ks) if int8 else None,
        v_scale=t(vs) if int8 else None)[:, 0].numpy()
    jref = np.asarray(jax_paged_xla(
        jnp.asarray(q)[:, None], jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(kv_len, jnp.int32), D ** -0.5,
        k_scale=jnp.asarray(ks) if int8 else None,
        v_scale=jnp.asarray(vs) if int8 else None))[:, 0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("G", [3, 5, 6, 7])
@pytest.mark.parametrize("int8", [False, True])
def test_emulated_walk_at_group_sizes_that_are_not_powers_of_two(G, int8):
    """The walk and the merge of units of G query heads (G 3, 5, 6, 7:
    the kernel pads them to 8 and keeps G) over a paged pool with a
    trash-table slot, against flash_paged_decode_ref, dense addressing
    through a one-block-per-sequence table included (B5's layout)."""
    rng = np.random.default_rng(10 + G)
    Hg, bs = K * G, 64
    M = 256 // bs
    N = B * M + 1
    kp, vp, ks, vs = _pool(rng, N, bs, int8)
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    table = table.astype(np.int32)
    table[2] = 0                                     # a free slot
    kv_len = np.array([1, 63, 300, 64, 256, 129])
    q = _bf16(rng.standard_normal((B, Hg, D)).astype(np.float32))

    def rows(pool):
        def get(b, r):
            blk = table[b, np.minimum(r // bs, M - 1)]
            return pool[blk, r % bs].astype(np.float32)
        return get

    def scale_rows(sp):
        def get(b, r):
            blk = table[b, np.minimum(r // bs, M - 1)]
            return sp[blk, :, r % bs]
        return get
    plan = flash.decode_plan(np.zeros(B, int), kv_len, K, M * bs, 132,
                             unit_rows=128)
    got = _check_orders(
        plan, q, rows(kp), rows(vp), D ** -0.5, None,
        rows_ks=scale_rows(ks) if int8 else None,
        rows_vs=scale_rows(vs) if int8 else None)
    t = torch.from_numpy
    ref = paged.flash_paged_decode_ref(
        t(q)[:, None], t(kp), t(vp), t(table), torch.zeros(B, dtype=int),
        t(kv_len), D ** -0.5, k_scale=t(ks) if int8 else None,
        v_scale=t(vs) if int8 else None)[:, 0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, so the kernel wrappers' checks
    run without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("entry", ["dense", "paged"])
def test_a_batch_past_the_kernels_limit_raises(entry):
    Bx = flash.MAX_BATCH + 1
    q = torch.zeros(Bx, 1, 8, 64).as_subclass(_FakeCuda)
    before = dict(flash.LAUNCHES)
    with pytest.raises(NotImplementedError, match="at most"):
        if entry == "dense":
            k = torch.zeros(Bx, 4, 2, 64)
            flash.flash_decode(q, k, k, torch.zeros(Bx), torch.ones(Bx),
                               0.125)
        else:
            pool = torch.zeros(3, 32, 2, 64)
            paged.paged_flash_decode(q, pool, pool,
                                     torch.ones(Bx, 1, dtype=torch.int32),
                                     torch.ones(Bx, dtype=torch.int32))
    assert flash.LAUNCHES == before
