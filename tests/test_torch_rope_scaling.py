"""The yarn and longrope RoPE scalings in the port, and the families'
gates, against the JAX package, on the CPU.

* yarn frequencies (`llama.rope_frequencies` through the port's own
  `mla.yarn_frequencies`) within 1e-6 (relative) of the JAX
  `_rope_frequencies`, at a tiny config and at gpt-oss-20b's published
  one; yarn's attention factor (also with mscale / mscale_all_dim)
  equal to the reference's, and folded into `query_scale` once;
* longrope: `short_factor` up to the original window and `long_factor`
  past it, chosen by the config's window (max_position_embeddings),
  within 1e-6 of the reference; Phi-3.5-MoE's published config takes
  the long factors;
* an unknown scaling type (`dynamic`) is refused by name;
* `check_supported` admits Gemma 2, command-r, Cohere2, Phi-3.5-MoE and
  gpt-oss, and refuses each of DeepSeek's MLA items by name.
"""

import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import mla as jmla
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.models import llama, mla
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import check_supported
from torch_family_cases import FAMILIES, hf_config

GPT_OSS_20B_ROPE = {"architectures": ["GptOssForCausalLM"],
                    "hidden_size": 2880, "num_attention_heads": 64,
                    "num_key_value_heads": 8, "head_dim": 64,
                    "rope_theta": 150000, "max_position_embeddings": 131072,
                    "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0,
                                     "factor": 32.0,
                                     "original_max_position_embeddings":
                                     4096, "rope_type": "yarn",
                                     "truncate": False}}


def _both(hf):
    return JaxConfig.from_hf_config(hf), ModelConfig.from_hf_config(hf)


def _close(jcfg, tcfg):
    ref = np.asarray(jllama._rope_frequencies(jcfg))
    got = llama.rope_frequencies(tcfg, "cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    return got


@pytest.mark.parametrize("hf", [hf_config("gptoss"), GPT_OSS_20B_ROPE],
                         ids=["tiny", "gpt-oss-20b"])
def test_yarn_frequencies_match_reference(hf):
    jcfg, tcfg = _both(hf)
    got = _close(jcfg, tcfg)
    plain = 1.0 / tcfg.rope_theta ** (np.arange(tcfg.head_dim // 2) * 2
                                      / tcfg.head_dim)
    assert not np.allclose(got, plain)  # the scaling did something
    # the attention factor is folded into query_scale once, and the
    # frequencies do not carry it
    _, att = mla.yarn_frequencies(tcfg, tcfg.head_dim)
    assert att > 1.0
    assert tcfg.query_scale == pytest.approx(
        tcfg.head_dim ** -0.5 * att * att, rel=1e-12)
    assert tcfg.query_scale == jcfg.query_scale


@pytest.mark.parametrize("extra", [{}, {"mscale": 1.0, "mscale_all_dim": 0.7},
                                   {"attention_factor": 1.3}])
def test_yarn_attention_factor_matches_reference(extra):
    hf = hf_config("gptoss")
    hf["rope_scaling"] = dict(hf["rope_scaling"], **extra)
    jcfg, tcfg = _both(hf)
    jf, jatt = jmla.yarn_frequencies(jcfg, 16)
    tf, tatt = mla.yarn_frequencies(tcfg, 16)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    assert tatt == jatt


@pytest.mark.parametrize("window,which", [(32, "short_factor"),
                                          (128, "long_factor")])
def test_longrope_picks_its_factors_by_the_config_window(window, which):
    hf = hf_config("phimoe", max_position_embeddings=window)
    jcfg, tcfg = _both(hf)
    got = _close(jcfg, tcfg)
    half = tcfg.head_dim // 2
    base = 1.0 / 10000.0 ** (np.arange(half, dtype=np.float32) / half)
    ext = np.asarray(hf["rope_scaling"][which], np.float32)
    np.testing.assert_allclose(got, base / ext, rtol=1e-6)
    # the engine's serving window does not change the choice
    np.testing.assert_array_equal(
        llama.rope_frequencies(tcfg.replace(max_seq_len=window), "cpu"),
        got)


def test_phi35_moe_published_window_takes_the_long_factors():
    # Phi-3.5-MoE: max_position_embeddings 131072 over an original 4096
    hf = hf_config("phimoe", max_position_embeddings=131072,
                   head_dim=128)
    rs = dict(hf["rope_scaling"], original_max_position_embeddings=4096)
    rng = np.random.default_rng(0)
    rs["short_factor"] = list(1 + rng.random(64))
    rs["long_factor"] = list(1 + 40 * rng.random(64))
    hf["rope_scaling"] = rs
    jcfg, tcfg = _both(hf)
    got = _close(jcfg, tcfg)
    base = 1.0 / 10000.0 ** (np.arange(64, dtype=np.float32) / 64)
    np.testing.assert_allclose(got, base / np.asarray(rs["long_factor"],
                                                      np.float32), rtol=1e-6)


def test_unknown_rope_scaling_is_refused_by_name():
    hf = hf_config("gptoss", rope_scaling={"type": "dynamic",
                                            "factor": 2.0})
    jcfg, tcfg = _both(hf)
    with pytest.raises(ValueError, match="rope_scaling type 'dynamic'"):
        jllama._rope_frequencies(jcfg)
    with pytest.raises(ValueError, match="rope_scaling type 'dynamic'"):
        llama.rope_frequencies(tcfg, "cpu")


def test_check_supported_admits_the_families_and_refuses_mla():
    for family in FAMILIES:
        check_supported(ModelConfig.from_hf_config(hf_config(family)))
    deepseek = {"architectures": ["DeepseekV3ForCausalLM"],
                "hidden_size": 64, "num_attention_heads": 4,
                "num_hidden_layers": 2, "n_routed_experts": 4,
                "num_experts_per_tok": 2, "n_shared_experts": 1,
                "first_k_dense_replace": 1, "kv_lora_rank": 16,
                "q_lora_rank": 16, "qk_nope_head_dim": 8,
                "qk_rope_head_dim": 8, "v_head_dim": 8, "vocab_size": 64}
    cfg = ModelConfig.from_hf_config(deepseek)
    for name in ("MLA attention", "shared experts", "first_k_dense",
                 "sigmoid_v3", "router_bias"):
        with pytest.raises(NotImplementedError, match=name):
            check_supported(cfg)
    v2 = ModelConfig.from_hf_config(dict(
        deepseek, architectures=["DeepseekV2ForCausalLM"]))
    with pytest.raises(NotImplementedError, match="softmax_v2"):
        check_supported(v2)
