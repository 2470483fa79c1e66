"""B2's bf16 backward (`ops/csrc/flash_prefill_bwd_wgmma.cu`) as far as
the CPU can reach it, against the JAX package's attention.

* `flash.bwd_tile_plan`, the walks the kernel implements: bwd_dq's key
  tiles of each query tile and bwd_dkdv's query tiles of each key tile
  each cover every valid (row, key) pair exactly once, a tile marked
  full holds only valid pairs, every walked tile holds one, and the head
  split covers each of the G heads once (causal and windowed, G 1, 7,
  32, S off the tile grid).
* The plain lse plane (`flash_prefill_ref(lse=True)`, what B2 writes
  under grad) equals `jax.nn.logsumexp` of the reference's masked logits,
  with and without the sink column, within 1e-6.
* A torch emulation of the kernel's arithmetic (P from the forward's
  lse, Delta = rowsum(P dP), P and dS fed to the output products as two
  bf16 terms) meets chip_smoke's bf16 tolerance (2e-3 of each
  gradient's rms) against `flash_prefill_bwd_ref` on bf16 inputs with
  heavy tails (q x 10, softcap), while one bf16 term (what SDPA's
  backward does) reads beyond it: the card's check made here.
* The sink logits' gradient from lse and Delta (`flash.sink_grad`) and
  dq, dk, dv with sinks equal `jax.grad` of the reference's
  `xla_attention(..., sinks=)` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.ops.attention import NEG_INF, attention as jattention
from ome_tpu_torch.ops import flash

T = flash.BWD_TILE
SMS = 132  # an H100's SMs, for the head split


def _valid(S, window):
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    ok = j <= i
    if window:
        ok &= j > i - window
    return ok


PLAN_CASES = [  # (B, S, H, K, D, window)
    (1, 64, 4, 4, 128, None), (2, 130, 7, 1, 64, None),
    (1, 200, 32, 1, 128, None), (1, 2048, 32, 1, 128, None),
    (2, 2048, 32, 8, 128, None), (1, 293, 14, 2, 96, 5),
    (1, 333, 7, 1, 256, 64), (1, 500, 32, 1, 64, 100),
    (1, 2048, 64, 8, 64, 128), (1, 2048, 16, 8, 256, 1024)]


@pytest.mark.parametrize("B,S,H,K,D,window", PLAN_CASES,
                         ids=[f"S{c[1]}H{c[2]}K{c[3]}D{c[4]}w{c[5]}"
                              for c in PLAN_CASES])
def test_walks_cover_every_valid_pair_once(B, S, H, K, D, window):
    plan = flash.bwd_tile_plan(B, S, H, K, D, window, SMS)
    ok = _valid(S, window)
    n = -(-S // T)
    assert plan.n_tiles == n
    for walk, by_query in ((plan.q_walk, True), (plan.kv_walk, False)):
        seen = np.zeros((n * T, n * T), dtype=np.int32)
        for t in range(n):
            t0, count, full = walk(t)
            assert count >= 1 and len(full) == count
            for u, f in zip(range(t0, t0 + count), full):
                qt, kt = (t, u) if by_query else (u, t)
                rows = slice(qt * T, (qt + 1) * T)
                cols = slice(kt * T, (kt + 1) * T)
                pad = np.zeros((n * T, n * T), dtype=bool)
                pad[:S, :S] = ok
                block = pad[rows, cols]
                assert block.any(), (t, u)
                if f:
                    assert block.all(), (t, u)
                seen[rows, cols] += 1
        assert (seen[:S, :S][ok] == 1).all()
    G = H // K
    heads = [g for sp in range(plan.g_split) for g in plan.heads(sp)]
    assert heads == list(range(G))
    assert 1 <= plan.g_split <= G
    assert plan.kv_chunks == -(-D // 64)


def test_head_split_fills_the_card_at_low_b_k():
    """G 32 over one KV head (32 key tiles a chunk) splits its heads;
    the 8B's heads at the step's B 2 have blocks enough and do not."""
    g32 = flash.bwd_tile_plan(1, 2048, 32, 1, 128, None, SMS)
    assert g32.g_split > 1
    assert g32.n_tiles * g32.kv_chunks * g32.g_split >= SMS
    assert flash.bwd_tile_plan(2, 2048, 32, 8, 128, None, SMS).g_split == 1


def _inputs(seed, B, S, H, K, D, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32) * q_scale
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, dout


def _jax_lse(q, k, scale, softcap, window, sinks, base=0, kv_hi=None):
    """logsumexp of the reference's masked logits (`xla_attention`'s,
    NEG_INF where masked), with the sink column where there are sinks:
    [B, H, Sq]."""
    B, Sq, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    logits = jnp.einsum("bskgd,btkd->bkgst",
                        jnp.asarray(q).reshape(B, Sq, K, G, D),
                        jnp.asarray(k)) * scale
    if softcap:
        logits = jnp.tanh(logits / softcap) * softcap
    pos = base + jnp.arange(Sq)[:, None]
    col = jnp.arange(S)[None, :]
    mask = (col <= pos) & (col < (S if kv_hi is None else kv_hi))
    if window:
        mask &= col > pos - window
    logits = jnp.where(mask, logits, NEG_INF)
    if sinks is not None:
        sk = jnp.broadcast_to(jnp.asarray(sinks).reshape(K, G)[
            None, :, :, None, None], (B, K, G, Sq, 1))
        logits = jnp.concatenate([logits, sk], axis=-1)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(B, H, Sq)


LSE_CASES = [  # (H, K, window, softcap, sinks, base, kv_hi)
    (8, 2, None, None, False, 0, None), (8, 2, None, None, True, 0, None),
    (7, 7, 6, 30.0, False, 0, None), (14, 2, 6, 30.0, True, 0, None),
    (8, 4, None, None, True, 5, 30)]


@pytest.mark.parametrize("H,K,window,softcap,sinks,base,kv_hi", LSE_CASES,
                         ids=[f"H{c[0]}K{c[1]}w{c[2]}c{c[3]}s{c[4]}b{c[5]}"
                              for c in LSE_CASES])
def test_plain_lse_is_the_references_logsumexp(H, K, window, softcap, sinks,
                                               base, kv_hi):
    B, Sq, D = 2, 24, 16
    S = base + Sq if kv_hi is None else 40
    q, k, v, _ = _inputs(H * 3 + K, B, S, H, K, D)
    q = q[:, :Sq]
    sk = np.random.default_rng(7).standard_normal(H).astype(np.float32) * 2 \
        if sinks else None
    scale = D ** -0.5
    out, lse = flash.flash_prefill_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.full((B,), base, dtype=torch.int32),
        torch.full((B,), S if kv_hi is None else kv_hi, dtype=torch.int32),
        scale, softcap, window, None if sk is None else torch.from_numpy(sk),
        lse=True)
    want = _jax_lse(q, k, scale, softcap, window, sk, base, kv_hi)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-6)
    plain = flash.flash_prefill_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.full((B,), base, dtype=torch.int32),
        torch.full((B,), S if kv_hi is None else kv_hi, dtype=torch.int32),
        scale, softcap, window, None if sk is None else torch.from_numpy(sk))
    assert torch.equal(out, plain)


def _terms(x, n):
    """x fed to a bf16 product as n bf16 terms (hi, then lo = x - hi),
    summed back in fp32: what the kernel's two wgmmas into one fp32
    accumulator add up to."""
    hi = x.bfloat16().float()
    return hi if n == 1 else hi + (x - hi).bfloat16().float()


def emulate_bwd(q, k, v, dout, scale, softcap, window, sinks=None,
                terms=2):
    """The bf16 backward kernel's arithmetic in torch, fp32, head by
    head: P = exp(s - lse) with lse the forward's plane (the sink in
    it), dP = dO V^T, Delta = rowsum(P dP), dS = P (dP - Delta) (1 -
    (s/c)^2), and P and dS as `terms` bf16 terms in dV = P^T dO, dK =
    scale dS^T Q, dQ = scale dS K. Returns (dq, dk, dv, delta)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    _, lse = flash.flash_prefill_ref(
        q, k, v, torch.zeros(B, dtype=torch.int32),
        torch.full((B,), S, dtype=torch.int32), scale, softcap, window,
        sinks, lse=True)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    ok = torch.from_numpy(_valid(S, window))
    dq = torch.zeros(B, S, H, D)
    dk = torch.zeros(B, S, K, D)
    dv = torch.zeros(B, S, K, D)
    delta = torch.zeros(B, H, S)
    for h in range(H):
        kh = h // G
        s = qf[:, :, h] @ kf[:, :, kh].transpose(1, 2) * scale
        d = 1.0
        if softcap:
            th = torch.tanh(s / softcap)
            s, d = th * softcap, 1 - th * th
        p = torch.where(ok, torch.exp(s - lse[:, h, :, None]), 0.0)
        dp = gf[:, :, h] @ vf[:, :, kh].transpose(1, 2)
        delta[:, h] = (p * dp).sum(-1)
        ds = p * (dp - delta[:, h, :, None]) * d
        p2, ds2 = _terms(p, terms), _terms(ds, terms)
        dv[:, :, kh] += p2.transpose(1, 2) @ gf[:, :, h]
        dk[:, :, kh] += ds2.transpose(1, 2) @ qf[:, :, h] * scale
        dq[:, :, h] = ds2 @ kf[:, :, kh] * scale
    return dq, dk, dv, delta


def _rel(got, ref):
    return max(((a.double() - r.double()).abs().max()
                / r.double().pow(2).mean().sqrt()).item()
               for a, r in zip(got, ref))


BF16_TOL = 2e-3  # chip_smoke's BWD_REL_TOL["bf16"]

EMU_CASES = [  # (D, q scale, softcap, window)
    (16, 10.0, 50.0, None), (32, 10.0, None, None), (64, 10.0, 50.0, 100),
    (64, 10.0, None, None)]


@pytest.mark.parametrize("D,q_scale,softcap,window", EMU_CASES,
                         ids=[f"D{c[0]}q{c[1]}c{c[2]}w{c[3]}"
                              for c in EMU_CASES])
def test_two_bf16_terms_meet_the_card_tolerance_and_one_does_not(
        D, q_scale, softcap, window):
    B, S, H, K = 1, 256, 4, 2
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in _inputs(
        D, B, S, H, K, D, q_scale))
    scale = D ** -0.5
    ref = flash.flash_prefill_bwd_ref(q, k, v, dout, scale, softcap, window)
    two = _rel(emulate_bwd(q, k, v, dout, scale, softcap, window)[:3], ref)
    one = _rel(emulate_bwd(q, k, v, dout, scale, softcap, window,
                           terms=1)[:3], ref)
    assert two < BF16_TOL / 4, two
    assert one > BF16_TOL, one


SINK_CASES = [(8, 2, None, None), (8, 8, 5, None), (14, 2, 6, 30.0)]


@pytest.mark.parametrize("H,K,window,softcap", SINK_CASES,
                         ids=[f"H{c[0]}K{c[1]}w{c[2]}c{c[3]}"
                              for c in SINK_CASES])
def test_sink_gradient_matches_jax_grad(H, K, window, softcap):
    B, S, D = 2, 20, 16
    q, k, v, dout = _inputs(H + 10 * K, B, S, H, K, D)
    sinks = np.random.default_rng(H).standard_normal(H).astype(
        np.float32) * 2
    scale = D ** -0.5
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def loss(q, k, v, s):
        out = jattention(q, k, v, positions=pos, sliding_window=window,
                         logit_softcap=softcap, backend="xla", sinks=s)
        return jnp.sum(out * dout)
    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, sinks)))]
    tq, tk, tv, tg, ts = (torch.from_numpy(a) for a in
                          (q, k, v, dout, sinks))
    got = flash.flash_prefill_bwd(tq, tk, tv, tg, scale, softcap, window,
                                  sinks=ts)
    for name, g, w in zip(("dq", "dk", "dv", "dsink"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)
    # the kernel's route: lse from the forward, Delta from its walk
    _, lse = flash.flash_prefill_ref(
        tq, tk, tv, torch.zeros(B, dtype=torch.int32),
        torch.full((B,), S, dtype=torch.int32), scale, softcap, window, ts,
        lse=True)
    delta = emulate_bwd(tq, tk, tv, tg, scale, softcap, window, ts)[3]
    np.testing.assert_allclose(flash.sink_grad(ts, lse, delta).numpy(),
                               want[3], atol=1e-5, err_msg="sink_grad")


def test_flash_prefill_under_grad_gives_the_sinks_a_gradient():
    """`flash_attention` on CPU tensors with sinks that require grad
    (the plain versions) and `FlashPrefill` (what the card runs) give
    the same four gradients."""
    B, S, H, K, D = 1, 12, 4, 2, 16
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(5, B, S, H, K, D))
    sinks = torch.linspace(-1.0, 2.0, H)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, sinks)]
    pos = torch.arange(S)[None]
    out = flash.flash_attention(*leaves[:3], positions=pos,
                                sinks=leaves[3])
    want = torch.autograd.grad(out, leaves, dout)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v, sinks)]
    out2 = flash.FlashPrefill.apply(*leaves2[:3], D ** -0.5, None, None,
                                    leaves2[3])
    got = torch.autograd.grad(out2, leaves2, dout)
    assert torch.allclose(out, out2, atol=1e-6)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=1e-5)
