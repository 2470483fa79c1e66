"""Gemma 2 in the port, against the JAX package, on the CPU.

A tiny Gemma 2 (tests/torch_family_cases.py: 2 layers, P 2, a window of
8 rows, softcaps 50 and 30, query_pre_attn_scalar 24, unit-offset norm
scales and post-block norms seeded away from zero, tied embeddings)
runs the reference's weights through both packages:

* logits of `forward` (a 13-row prefill, past the window, then per-slot
  decode over the dense cache) within 2e-4 of the JAX forward;
* greedy streams, `decode_multi` chunks and `verify` steps of the port's
  engine equal the JAX engine's, and so do the streams of an int8-weight
  engine and of an engine decoding with a LoRA adapter on all seven
  targets (the dense MLP's included);
* `embed_scale` rounds sqrt(hidden) to bf16 and multiplies in bf16, bit
  for bit as the reference;
* a transformers checkpoint loads leaf for leaf equal through both
  packages' `load_params`; int8 / int4 / fp8 quantization gives the
  reference's bytes;
* on a CUDA tensor (a CPU tensor reporting is_cuda) at head_dim 256,
  every layer's attention reaches the kernels' entry point with its
  window (4096 on sliding layers, none on global ones), softcap 50 and
  the query_pre_attn_scalar scale;
* paged KV is refused by name, and `serve --random-weights` serves it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params, init_params
from test_torch_lora import write_adapter
from torch_family_cases import (FakeCuda, _one_thread, admit,  # noqa: F401
                                check_decode_multi_and_verify,
                                check_hf_checkpoint, check_logits,
                                check_paged_refused, check_quant_bytes,
                                check_serve, check_streams, engines,
                                hf_config, model, prompts, save_hf, streams)


def test_gemma2_logits_match_reference():
    jcfg, _, tcfg, tp = model("gemma2")
    assert tcfg.alt_sliding_window and tcfg.sliding_pattern == 2
    assert tcfg.query_scale == jcfg.query_scale == 24 ** -0.5
    assert llama.layer_windows(tcfg) == [(8, True), (None, True)]
    assert "attn_post_norm" in tp["layers"] and "lm_head" not in tp
    check_logits("gemma2")


def test_gemma2_streams_match_jax_engine():
    check_streams("gemma2")


def test_gemma2_decode_multi_and_verify_match_jax():
    check_decode_multi_and_verify("gemma2")


def test_gemma2_int8_weight_streams_match_jax():
    jcfg, jp, tcfg, _ = model("gemma2")
    jq = jquant.quantize_params(jp, mode="int8")
    import jax
    tq = from_jax_params(jax.tree.map(np.asarray, jq), "cpu")
    jeng, teng = engines(jq, jcfg, tq, tcfg)
    assert streams(teng, prompts(), 10) == streams(jeng, prompts(), 10)


def test_gemma2_lora_streams_match_jax(tmp_path):
    jcfg, jp, tcfg, tp = model("gemma2")
    d = write_adapter(tmp_path / "a1", tcfg, 5)
    jeng, teng = engines(jp, jcfg, tp, tcfg, lora_slots=2, lora_rank=4)
    for e in (jeng, teng):
        e.register_adapter("a1", d)
    jobs = [None, "a1", "a1"]
    got = streams(teng, prompts(), 10, jobs)
    assert got == streams(jeng, prompts(), 10, jobs)
    assert got[1] != streams(teng, prompts(), 10)[1]


def test_gemma2_embed_scale_rounds_like_the_reference():
    jcfg, _, tcfg, _ = model("gemma2")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((256, 64)).astype(np.float32)
    toks = np.arange(3, 20, dtype=np.int32)[None]
    jx = jnp.asarray(emb, jnp.bfloat16)[toks] \
        * jnp.asarray(64 ** 0.5, jnp.bfloat16)
    tx = llama._embed_scaled(
        {"embed": torch.from_numpy(emb).to(torch.bfloat16)},
        tcfg.replace(dtype=torch.bfloat16), torch.from_numpy(toks))
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tx.view(torch.int16).numpy(),
        np.asarray(jx).view(np.int16))


def test_gemma2_checkpoint_loads_leaf_for_leaf(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.Gemma2Config(
        vocab_size=120, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=64, sliding_window=8,
        query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0)
    got, cfg = check_hf_checkpoint(save_hf(tmp_path, hf), expect=(
        "layers.attn_post_norm", "layers.mlp_post_norm", "layers.mlp_norm"))
    assert cfg.unit_offset_norm and cfg.embed_scale


@pytest.mark.parametrize("mode", ["int8", "int4", "fp8"])
def test_gemma2_quantized_bytes_match_reference(mode):
    assert check_quant_bytes("gemma2", mode) >= 5  # norms kept


def test_gemma2_window_softcap_d256_reach_the_kernel(monkeypatch):
    from ome_tpu_torch.ops import flash
    hf = dict(hf_config("gemma2"), head_dim=256, num_attention_heads=16,
              num_key_value_heads=8, sliding_window=4096,
              query_pre_attn_scalar=256)
    cfg = ModelConfig.from_hf_config(hf).replace(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    seen = []

    def kernels(q, k, v, **kw):
        seen.append((q.shape[-1], kw["sliding_window"], kw["logit_softcap"],
                     kw["scale"]))
        return torch.zeros_like(q)
    monkeypatch.setattr(flash, "flash_attention", kernels)
    h = torch.randn(1, 5, 64).as_subclass(FakeCuda)
    pos = torch.arange(5)[None]
    freqs = llama.rope_frequencies(cfg, "cpu")
    for i, (window, rope) in enumerate(llama.layer_windows(cfg)):
        lp = llama._layer_params(params["layers"], i)
        llama._mha(h, lp, cfg, freqs, pos, None, None, None, window,
                   use_rope=rope)
    assert seen == [(256, 4096, 50.0, 256 ** -0.5),
                    (256, None, 50.0, 256 ** -0.5)]


def test_gemma2_paged_kv_refused_by_name():
    check_paged_refused("gemma2", ["alternating sliding windows"])


def test_gemma2_serves_random_weights(tmp_path):
    engine = check_serve("gemma2", tmp_path)
    assert engine.cfg.final_logit_softcap == 30.0
