"""Llama forward parity: the port against ome_tpu.models.llama.

Weights come from the JAX init (`llama.init_params`) and cross to the
port through `from_jax_params`, so both packages run the same numbers.
The config is `tiny_test()` in float32; logits agree within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import ModelConfig, llama3_8b, tiny_test
from ome_tpu_torch.models.params import (check_supported,
                                         from_jax_params, init_params,
                                         to_numpy)

ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny().replace(dtype=jnp.float32)
    tcfg = tiny_test().replace(dtype=torch.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, B, S, V=512):
    return np.random.default_rng(seed).integers(0, V, (B, S),
                                                dtype=np.int32)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trips_bytes(dtype):
    jcfg = jax_tiny().replace(dtype=getattr(jnp, dtype))
    jparams = jax.tree.map(np.asarray,
                           jllama.init_params(jax.random.PRNGKey(1), jcfg))
    tparams = from_jax_params(jparams, "cpu")
    jl, tl = _leaves(jparams), _leaves(tparams)
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        t = tl[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == getattr(torch, dtype), name
        want = a.view(np.uint16) if dtype == "bfloat16" else a
        np.testing.assert_array_equal(to_numpy(t), want, err_msg=name)


def test_port_init_matches_reference_layout():
    jcfg = jax_tiny().replace(dtype=jnp.bfloat16)
    jl = _leaves(jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(0), jcfg)))
    gen = torch.Generator().manual_seed(0)
    tl = _leaves(init_params(tiny_test(), gen, "cpu"))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        assert tuple(tl[name].shape) == a.shape, name
        assert tl[name].dtype == torch.bfloat16, name
    # normal std 0.02, norms at one
    assert abs(tl["embed"].float().std().item() - 0.02) < 2e-3
    assert torch.all(tl["layers.attn_norm"] == 1)


def test_port_init_is_seeded():
    a = init_params(tiny_test(), torch.Generator().manual_seed(3), "cpu")
    b = init_params(tiny_test(), torch.Generator().manual_seed(3), "cpu")
    c = init_params(tiny_test(), torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])


def test_forward_without_cache(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(0, 2, 24)
    ref, _ = jllama.forward(jparams, jcfg, jnp.asarray(toks))
    out, cache = llama.forward(tparams, tcfg, torch.from_numpy(toks))
    assert cache is None and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_forward_with_cache_at_scalar_index(models):
    # two chunks into one cache: the second starts at scalar index 16
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(1, 2, 24)
    jc = jllama.KVCache.create(jcfg, 2, 64)
    tc = llama.KVCache.create(tcfg, 2, 64, device="cpu")
    for lo, hi in ((0, 16), (16, 24)):
        ref, jc = jllama.forward(jparams, jcfg, jnp.asarray(toks[:, lo:hi]),
                                 cache=jc)
        out, tc = llama.forward(tparams, tcfg,
                                torch.from_numpy(toks[:, lo:hi]), cache=tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert tc.index == int(jc.index) == 24
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)


def test_forward_per_slot_index_decode(models):
    # continuous-batching decode: each slot writes at its own length
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(2, 3, 20)
    jc = jllama.KVCache.create(jcfg, 3, 64)
    tc = llama.KVCache.create(tcfg, 3, 64, device="cpu")
    _, jc = jllama.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
    _, tc = llama.forward(tparams, tcfg, torch.from_numpy(toks), cache=tc)
    lengths = np.asarray([20, 7, 13], np.int32)
    step = _tokens(3, 3, 1)
    for _ in range(3):
        jc = jllama.KVCache(k=jc.k, v=jc.v, index=jnp.asarray(lengths))
        tc = llama.KVCache(k=tc.k, v=tc.v, index=torch.from_numpy(lengths))
        ref, jc = jllama.forward(jparams, jcfg, jnp.asarray(step), cache=jc)
        out, tc = llama.forward(tparams, tcfg, torch.from_numpy(step),
                                cache=tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
        step = np.asarray(ref)[:, -1].argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + 1


def test_forward_rows_selects_last_token_logits(models):
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(_tokens(4, 2, 12))
    full, _ = llama.forward(tparams, tcfg, toks)
    rows = torch.tensor([11, 5])
    one, _ = llama.forward(tparams, tcfg, toks, rows=rows)
    assert one.shape == (2, 1, tcfg.vocab_size)
    torch.testing.assert_close(one[:, 0], full[torch.arange(2), rows],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"rope_type": "linear", "factor": 4.0},
])
def test_rope_frequencies_equal(scaling):
    from ome_tpu.models.config import llama3_8b as jax_8b
    jcfg = jax_8b().replace(rope_scaling=scaling)
    tcfg = llama3_8b().replace(rope_scaling=scaling)
    ref = np.asarray(jllama._rope_frequencies(jcfg))
    out = llama.rope_frequencies(tcfg, "cpu").numpy()
    assert out.dtype == np.float32
    # fp32 pow/divide in two libraries: equal to within 2 ulp
    np.testing.assert_allclose(out, ref, rtol=3e-7, atol=0)


def test_llama3_8b_preset_and_hf_config_match_reference():
    from ome_tpu.models.config import ModelConfig as JaxConfig
    from ome_tpu.models.config import llama3_8b as jax_8b
    hf = {"architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
          "hidden_size": 4096, "num_hidden_layers": 32,
          "num_attention_heads": 32, "num_key_value_heads": 8,
          "intermediate_size": 14336, "rope_theta": 500000.0,
          "max_position_embeddings": 8192}
    for ours, ref in ((llama3_8b(), jax_8b()),
                      (ModelConfig.from_hf_config(hf),
                       JaxConfig.from_hf_config(hf))):
        a = {k: v for k, v in vars(ours).items() if k != "dtype"}
        b = {k: v for k, v in vars(ref).items() if k != "dtype"}
        assert a == b
        assert ours.dtype == torch.bfloat16


def test_unsupported_architectures_refuse_by_name():
    # the sparsemixer router (Phi-3.5-MoE) and the command-r LayerNorm
    # form of qk_norm are served now, beside Mixtral's MoE and Qwen3's
    # RMSNorm qk_norm; DeepSeek's MLA, shared experts, first_k_dense,
    # routers and selection bias stay refused by name
    with pytest.raises(NotImplementedError, match="shared experts"):
        check_supported(tiny_test(moe=True).replace(num_shared_experts=1))
    check_supported(tiny_test(moe=True).replace(
        router_scoring="sparsemixer", router_jitter=0.01))
    # q/k norms under either LayerNorm form, as the reference's `_qkv`
    # dispatches them
    for nt in ("layernorm_nobias", "layernorm"):
        check_supported(tiny_test().replace(qk_norm=True, norm_type=nt))
    for scoring in ("softmax_v2", "sigmoid_v3"):
        with pytest.raises(NotImplementedError, match=scoring):
            check_supported(tiny_test(moe=True).replace(
                router_scoring=scoring))
    with pytest.raises(NotImplementedError, match="router_bias"):
        check_supported(tiny_test(moe=True).replace(router_bias=True))
    with pytest.raises(NotImplementedError, match="first_k_dense"):
        check_supported(tiny_test(moe=True).replace(first_k_dense=1))
    with pytest.raises(NotImplementedError, match="MLA attention"):
        check_supported(tiny_test().replace(mla=True))
    check_supported(llama3_8b())
    check_supported(tiny_test(moe=True))
    check_supported(tiny_test().replace(qk_norm=True, attn_bias=True))
