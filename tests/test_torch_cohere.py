"""command-r (Cohere) and command-r7b / command-a (Cohere2) in the port,
against the JAX package, on the CPU.

Tiny models (tests/torch_family_cases.py): command-r with and without
its per-(head, dim) q/k LayerNorms (command-r-plus), and Cohere2 at 4
layers, one period of its pattern P 4 (three sliding layers with a
window of 8 rows, then a global layer without RoPE); weight-only
LayerNorm scales seeded away from 1, tied embeddings, a logit scale.

* logits of `forward` (prefill past the window, per-slot decode) within
  2e-4 of the JAX forward; greedy streams of the engines equal;
* the interleaved (even/odd pair) RoPE and the weight-only LayerNorm
  equal the reference's functions;
* Cohere2's layer plan: layer i global iff (i + 1) % 4 == 0, its RoPE
  skipped; a depth that is not a whole number of periods is refused by
  name;
* transformers checkpoints load leaf for leaf equal through both
  packages' `load_params`; paged KV is refused by name; `serve
  --random-weights` serves both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import check_supported
from torch_family_cases import (_one_thread, check_hf_checkpoint,  # noqa: F401
                                check_logits, check_paged_refused,
                                check_quant_bytes, check_serve, check_streams,
                                hf_config, model, save_hf)


@pytest.mark.parametrize("family", ["cohere", "cohere_qk", "cohere2"])
def test_cohere_logits_match_reference(family):
    _, _, tcfg, tp = model(family)
    assert tcfg.parallel_block and tcfg.rope_interleaved
    assert "mlp_norm" not in tp["layers"]
    assert ("q_norm" in tp["layers"]) == (family == "cohere_qk")
    check_logits(family)


@pytest.mark.parametrize("family", ["cohere", "cohere2"])
def test_cohere_streams_match_jax_engine(family):
    check_streams(family)


def test_interleaved_rope_and_weight_only_layernorm_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    freqs = 1.0 / 10000.0 ** (np.arange(8, dtype=np.float32) / 8)
    ref = jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            jnp.asarray(freqs), interleaved=True)
    got = llama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           torch.from_numpy(freqs), interleaved=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    w = (1 + 0.3 * rng.standard_normal((3, 16))).astype(np.float32)
    ref = jllama.layer_norm(jnp.asarray(x), jnp.asarray(w), None, 1e-5)
    got = llama.layer_norm(torch.from_numpy(x), torch.from_numpy(w), None,
                           1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_cohere2_layer_plan_and_depth_refusal():
    _, _, tcfg, _ = model("cohere2")
    assert llama.layer_windows(tcfg) == [(8, True)] * 3 + [(None, False)]
    bad = ModelConfig.from_hf_config(hf_config("cohere2",
                                               num_hidden_layers=6))
    with pytest.raises(ValueError, match="sliding_pattern 4"):
        check_supported(bad)
    with pytest.raises(ValueError, match="sliding_pattern"):
        llama.layer_windows(bad)


@pytest.mark.parametrize("arch", ["cohere", "cohere_qk", "cohere2"])
def test_cohere_checkpoint_loads_leaf_for_leaf(arch, tmp_path):
    transformers = pytest.importorskip("transformers")
    kw = dict(vocab_size=120, hidden_size=64, intermediate_size=96,
              num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              logit_scale=0.5)
    if arch == "cohere2":
        hf = transformers.Cohere2Config(sliding_window=8,
                                        sliding_window_pattern=4, **kw)
    else:
        hf = transformers.CohereConfig(use_qk_norm=arch == "cohere_qk",
                                       **kw)
    got, cfg = check_hf_checkpoint(save_hf(tmp_path, hf))
    assert "mlp_norm" not in got["layers"] and "lm_head" not in got
    if arch == "cohere_qk":
        assert got["layers"]["q_norm"].shape == (4, 4, 16)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_cohere2_quantized_bytes_match_reference(mode):
    assert check_quant_bytes("cohere2", mode) >= 2


@pytest.mark.parametrize("family", ["cohere", "cohere2"])
def test_cohere_paged_kv_refused_by_name(family):
    words = ["parallel blocks", "layernorm_nobias"]
    if family == "cohere2":
        words.append("alternating sliding windows")
    check_paged_refused(family, words)


@pytest.mark.parametrize("family", ["cohere", "cohere2"])
def test_cohere_serves_random_weights(family, tmp_path):
    engine = check_serve(family, tmp_path)
    assert engine.cfg.logit_scale is not None
