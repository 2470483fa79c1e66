"""Phi-3.5-MoE (PhimoeForCausalLM) in the port, against the JAX
package, on the CPU.

A tiny Phi-3.5-MoE (tests/torch_family_cases.py: 2 layers, 4 experts
top-2 through the sparsemixer router, torch LayerNorm with seeded
scales and biases, q/k/v/o and head biases, longrope past its original
window):

* the sparsemixer's expert ids equal the reference's and its weights
  are within 1e-6, tied logits included (lower id first);
* LayerNorm with a bias equals the reference's;
* logits of `forward` within 2e-4 of the JAX forward; greedy streams of
  the engines equal;
* a transformers checkpoint loads leaf for leaf equal through both
  packages' `load_params`; int8 / int4 quantization gives the
  reference's bytes, with the router, norms and biases kept; paged KV
  is refused by name; `serve --random-weights` serves it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.params import check_supported
from torch_family_cases import (_one_thread, check_hf_checkpoint,  # noqa: F401
                                check_logits, check_paged_refused,
                                check_quant_bytes, check_serve, check_streams,
                                model, save_hf)


def _router_inputs(seed, E=8, D=16, T=40):
    """x [1, T, D] and a router [D, E] whose columns 1 and 5 are equal
    (tied logits in every row), plus rows of all-zero logits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, D)).astype(np.float32)
    x[0, :4] = 0.0
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 5] = router[:, 1]
    return x, router


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparsemixer_routes_as_the_reference(seed):
    jcfg, _, tcfg, _ = model("phimoe")
    x, router = _router_inputs(seed)
    jcfg = jcfg.replace(num_experts=8)
    tcfg = tcfg.replace(num_experts=8)
    jw, jidx = jllama._route(jnp.asarray(x), {"router": jnp.asarray(router)},
                             jcfg)
    tw, tidx = llama._route(torch.from_numpy(x),
                            {"router": torch.from_numpy(router)}, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    ids = tidx.numpy()[0]
    assert (ids[:4] == [[0, 1]] * 4).all()  # all tied: lower ids first
    both = (ids == 1).any(-1) & (ids == 5).any(-1)
    assert not ((ids[:, 0] == 5) & both).any()  # 1 before its tie 5


def test_layernorm_with_bias_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3 + 1
    w = (1 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    b = (0.3 * rng.standard_normal(64)).astype(np.float32)
    ref = jllama.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            1e-5)
    got = llama.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_phimoe_logits_match_reference():
    _, _, tcfg, tp = model("phimoe")
    assert tcfg.router_scoring == "sparsemixer"
    assert tcfg.norm_type == "layernorm" and "final_norm_bias" in tp
    assert "lm_head_bias" in tp and "bo" in tp["layers"]
    check_logits("phimoe")


@pytest.mark.parametrize("norm_type", ["layernorm", "layernorm_nobias"])
def test_qk_norm_under_each_layernorm_matches_reference(norm_type):
    # the reference's q/k norm dispatch: LayerNorm (weight only) under
    # layernorm_nobias, RMSNorm under layernorm (Phi-3.5-MoE's norms with
    # qk_norm on), so both are served
    jcfg, jp, tcfg, tp = model("phimoe")
    jcfg = jcfg.replace(qk_norm=True, norm_type=norm_type)
    tcfg = tcfg.replace(qk_norm=True, norm_type=norm_type)
    check_supported(tcfg)
    rng = np.random.default_rng(7)
    H, K, Dh = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
    norms = {"q_norm": 1 + 0.3 * rng.standard_normal((H, Dh)),
             "k_norm": 1 + 0.3 * rng.standard_normal((K, Dh))}
    norms = {n: w.astype(np.float32) for n, w in norms.items()}
    jlp = {n: v[0] for n, v in jp["layers"].items()}
    jlp.update((n, jnp.asarray(w)) for n, w in norms.items())
    tlp = dict(llama._layer_params(tp["layers"], 0))
    tlp.update((n, torch.from_numpy(w)) for n, w in norms.items())
    h = rng.standard_normal((2, 5, tcfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    ref = jllama._qkv(jnp.asarray(h), jlp, jcfg,
                      jllama._rope_frequencies(jcfg), jnp.asarray(pos),
                      False)
    got = llama._qkv(torch.from_numpy(h), tlp, tcfg,
                     llama.rope_frequencies(tcfg, "cpu"),
                     torch.from_numpy(pos.copy()))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_phimoe_streams_match_jax_engine():
    check_streams("phimoe")


def test_phimoe_checkpoint_loads_leaf_for_leaf(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.PhimoeConfig(
        vocab_size=120, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, attention_bias=True, lm_head_bias=True,
        router_jitter_noise=0.01, tie_word_embeddings=False,
        sliding_window=None)
    check_hf_checkpoint(save_hf(tmp_path, hf), expect=(
        "layers.attn_norm_bias", "layers.mlp_norm_bias", "layers.bo",
        "final_norm_bias", "lm_head_bias", "layers.we_gate"))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_phimoe_quantized_bytes_match_reference(mode):
    # router, norms, norm biases and q/k/v/o biases stay full precision
    assert check_quant_bytes("phimoe", mode) >= 9


def test_phimoe_paged_kv_refused_by_name():
    check_paged_refused("phimoe", ["MoE", "norm_type 'layernorm'"])


def test_phimoe_serves_random_weights(tmp_path):
    engine = check_serve("phimoe", tmp_path)
    assert engine.cfg.moe_impl == "ragged"
    assert "lm_head_bias" in engine.model.params
