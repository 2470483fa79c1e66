"""MLA (DeepSeek-V2-Lite, V2, V3, V3 with yarn, Kimi-K2) in the port,
against the JAX package, on the CPU.

The tiny models of tests/torch_family_cases.py (`MLA_FAMILIES`: 3 layers,
the first dense; seeded MLA norms and V3's selection bias), fp32, the
same numpy weights through both packages:

* logits of `forward` (a 13-row prefill, then per-slot decode steps over
  the latent cache at other lengths: the materialized and the absorbed
  paths) within 2e-4 of the JAX forward;
* `rope_interleaved` (its [evens | odds] layout, yarn's attention
  factor) and `mla_scale` within 1e-6 of the reference's;
* the latent cache's geometry (one head of kv_lora_rank + rope values,
  a zero-width v plane) and bytes per token equal the reference's, and
  a prefill writes the reference's latent rows;
* the absorbed decode continues a prompt with the greedy tokens of the
  materialized forward over the whole sequence.

Checkpoints: tests/test_torch_mla_checkpoint.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models import mla as jmla
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models import llama, mla
from torch_family_cases import (ATOL, MLA_FAMILIES,  # noqa: F401
                                _one_thread, check_logits, model, tokens)


@pytest.mark.parametrize("family", MLA_FAMILIES)
def test_logits_match_jax(family):
    check_logits(family)


@pytest.mark.parametrize("family", ["dsv2lite", "dsv3yarn"])
def test_rope_interleaved_and_scale_match(family):
    jcfg, _, tcfg, _ = model(family)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, jcfg.qk_rope_head_dim)).astype(
        np.float32)
    pos = rng.integers(0, 120, (2, 7)).astype(np.int32)
    ref = jmla.rope_interleaved(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = mla.rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos),
                               tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    # [rotated evens | rotated odds], not HF's interleaved layout: at
    # position 0 (no rotation, att 1) the halves are x's evens and odds
    zero = mla.rope_interleaved(torch.from_numpy(x),
                                torch.zeros((2, 7), dtype=torch.int32),
                                tcfg)
    _, att = mla.yarn_frequencies(tcfg, jcfg.qk_rope_head_dim)
    half = jcfg.qk_rope_head_dim // 2
    np.testing.assert_allclose(zero[..., :half].numpy(),
                               x[..., 0::2] * att, rtol=1e-6)
    np.testing.assert_allclose(zero[..., half:].numpy(),
                               x[..., 1::2] * att, rtol=1e-6)
    assert abs(tcfg.mla_scale - jcfg.mla_scale) <= 1e-6 * jcfg.mla_scale
    if family == "dsv3yarn":
        assert att != 1.0 and tcfg.mla_scale != (16 + 8) ** -0.5


@pytest.mark.parametrize("family", ["dsv2lite", "dsv3yarn"])
def test_model_rope_table_is_made_once_and_bit_equal(family):
    """The `Llama` module holds the rope dims' yarn frequencies as its
    `freqs` buffer and hands them to every MLA layer, so that a forward
    makes no table; `rope_interleaved` over that table equals, bit for
    bit, the call that makes its own."""
    jcfg, _, tcfg, tp = model(family)
    m = llama.Llama(tcfg, tp)
    inv, _ = mla.yarn_frequencies(tcfg, tcfg.qk_rope_head_dim)
    assert torch.equal(m.freqs, inv)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (2, 5, 3, jcfg.qk_rope_head_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 120, (2, 5)).astype(np.int32))
    assert torch.equal(mla.rope_interleaved(x, pos, tcfg, m.freqs),
                       mla.rope_interleaved(x, pos, tcfg))
    toks = torch.from_numpy(tokens(6, 2, 5).astype(np.int64))
    want, _ = llama.forward(tp, tcfg, toks)
    calls = []
    make = mla.yarn_frequencies

    def counted(*a, **kw):
        calls.append(a)
        return make(*a, **kw)
    mla.yarn_frequencies = counted
    try:
        got, _ = m(toks)
    finally:
        mla.yarn_frequencies = make
    assert not calls
    assert torch.equal(got, want)


def test_latent_cache_geometry_and_bytes():
    jcfg, jp, tcfg, tp = model("dsv3")
    jc = jllama.KVCache.create(jcfg, 2, 16)
    tc = llama.KVCache.create(tcfg, 2, 16, device="cpu")
    assert tuple(tc.k.shape) == jc.k.shape == (3, 2, 16, 1, 40)
    assert tuple(tc.v.shape) == jc.v.shape == (3, 2, 16, 1, 0)
    kw = dict(max_slots=2, max_seq=32, prefill_buckets=[16])
    jeng, teng = JaxEngine(jp, jcfg, **kw), InferenceEngine(
        tp, tcfg, device="cpu", **kw)
    # 3 layers x 40 values x 4 bytes: no v plane
    assert teng.kv_row_bytes() == jeng.kv_row_bytes() == 3 * 40 * 4
    state = teng.new_state()
    assert tuple(state.v.shape) == (3, 2, 32, 1, 0)
    prompt = [int(t) for t in tokens(5, 1, 11)[0]]
    _, (jk, jv), _, _ = jeng.prefill(prompt)
    _, (tk, tv), _, _ = teng.prefill(prompt)
    assert tuple(tv.shape) == jv.shape and tv.numel() == 0
    # the latent rows of the prompt and its padding, [normed c | roped
    # k_pe in evens|odds], as the reference writes them
    assert tuple(tk.shape) == jk.shape == (3, 1, 16, 1, 40)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)


def test_absorbed_decode_matches_materialized_forward():
    """Engine decode (one row over the cache: the absorbed path) gives
    the greedy tokens of the plain forward over the whole sequence (no
    cache: the materialized path)."""
    _, _, tcfg, tp = model("dsv2")
    prompt = [1, 7, 42, 9, 3]
    seq = list(prompt)
    for _ in range(6):
        logits, _ = llama.forward(tp, tcfg, torch.tensor([seq]))
        seq.append(int(logits[0, -1].argmax()))
    eng = InferenceEngine(tp, tcfg, device="cpu", max_slots=2, max_seq=32,
                          prefill_buckets=[8])
    state = eng.new_state()
    tok, kv, n, b = eng.prefill(prompt)
    state = eng.insert(state, kv, 0, n, tok, b)
    got = [tok]
    greedy = (np.zeros(2, np.float32), np.zeros(2, np.int32),
              np.ones(2, np.float32))
    for _ in range(5):
        state, toks = eng.decode(state, *greedy)
        got.append(int(np.asarray(toks)[0]))
    assert got == seq[len(prompt):]


def test_from_jax_params_carries_the_mla_tree():
    """The reference's init of an MLA MoE model (dense_layers,
    router_bias, ws_*) crosses into the port byte for byte."""
    from ome_tpu_torch.models.params import from_jax_params, to_numpy
    jcfg, _, _, _ = model("dsv3")
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(2), jcfg.replace(dtype=jnp.bfloat16)))
    got = from_jax_params(tree, "cpu")
    assert set(got) == set(tree) >= {"dense_layers", "layers"}
    for block in ("dense_layers", "layers"):
        assert set(got[block]) == set(tree[block])
        for name, a in tree[block].items():
            np.testing.assert_array_equal(
                to_numpy(got[block][name]),
                a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    assert got["layers"]["router_bias"].dtype == torch.float32
    assert {"ws_gate", "ws_up", "ws_down"} <= set(got["layers"])
