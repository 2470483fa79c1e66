"""gpt-oss (GptOssForCausalLM) in the port, against the JAX package, on
the CPU.

A tiny gpt-oss (tests/torch_family_cases.py: 2 layers, P 2 with a window
of 8 rows, seeded per-head sink logits, q/k/v/o biases, 4 experts top-2
behind a biased router, clamped-GLU experts whose seeded gate and up
biases push many values past the +-7 clamps, yarn RoPE):

* the biased router's expert ids equal the reference's and its weights
  are within 1e-6, tied logits included; `gptoss_glu` equals the
  reference's at and around its clamp edges; both MoE impls equal the
  reference's with the expert biases;
* logits of `forward` within 2e-4 of the JAX forward; greedy streams,
  `decode_multi` chunks and `verify` steps of the engines equal, and so
  do the streams under a LoRA adapter on the attention targets;
* on a CUDA tensor (a CPU tensor reporting is_cuda) the sink attention
  reaches the kernels' entry point with the layer's sinks, and the
  kernels' plain versions there give the CPU path's result;
* a transformers checkpoint loads leaf for leaf equal through both
  packages' `load_params`; quantization gives the reference's bytes
  with sinks, biases and the router kept; paged KV is refused by name;
  `serve --random-weights` serves it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu_torch.models import llama
from test_torch_lora import ATTN, write_adapter
from torch_family_cases import (FakeCuda, _one_thread,  # noqa: F401
                                check_decode_multi_and_verify,
                                check_hf_checkpoint, check_logits,
                                check_paged_refused, check_quant_bytes,
                                check_serve, check_streams, engines, model,
                                prompts, save_hf, streams)


def test_biased_router_routes_as_the_reference():
    jcfg, _, tcfg, _ = model("gptoss")
    rng = np.random.default_rng(4)
    E, D = 8, 16
    x = rng.standard_normal((2, 20, D)).astype(np.float32)
    x[0, :3] = 0.0  # logits all equal to the bias: ties where it ties
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 6] = router[:, 2]
    bias = rng.standard_normal(E).astype(np.float32)
    bias[6] = bias[2]
    bias[7] = bias[0]
    jcfg = jcfg.replace(num_experts=E, experts_per_token=3)
    tcfg = tcfg.replace(num_experts=E, experts_per_token=3)
    jw, jidx = jllama._route(jnp.asarray(x), {
        "router": jnp.asarray(router), "router_b": jnp.asarray(bias)}, jcfg)
    tw, tidx = llama._route(torch.from_numpy(x), {
        "router": torch.from_numpy(router),
        "router_b": torch.from_numpy(bias)}, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


def test_gptoss_glu_matches_reference_at_the_clamps():
    jcfg, _, tcfg, _ = model("gptoss")
    edge = np.asarray([-20.0, -7.001, -7.0, -6.999, -1.0, 0.0, 1.0, 6.999,
                       7.0, 7.001, 20.0], np.float32)
    gate, up = np.meshgrid(edge, edge)
    ref = jllama._moe_act(jnp.asarray(gate), jnp.asarray(up), jcfg)
    got = llama._moe_act(torch.from_numpy(gate), torch.from_numpy(up), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_gptoss_moe_with_biases_matches_reference(impl):
    jcfg, jp, tcfg, tp = model("gptoss")
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    x = np.random.default_rng(5).standard_normal((2, 7, 64)).astype(
        np.float32)
    ref = jllama.moe_mlp(jnp.asarray(x), jlp, jcfg.replace(moe_impl=impl))
    got = llama.moe_mlp(torch.from_numpy(x), tlp, tcfg.replace(moe_impl=impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def test_gptoss_logits_match_reference():
    _, _, tcfg, tp = model("gptoss")
    assert tcfg.attn_sinks and tcfg.moe_activation == "gptoss_glu"
    assert {"sinks", "router_b", "we_gate_b", "bo"} <= set(tp["layers"])
    assert tp["layers"]["sinks"].dtype == torch.float32
    check_logits("gptoss")


def test_gptoss_streams_match_jax_engine():
    check_streams("gptoss")


def test_gptoss_decode_multi_and_verify_match_jax():
    check_decode_multi_and_verify("gptoss")


def test_gptoss_lora_on_attention_streams_match_jax(tmp_path):
    jcfg, jp, tcfg, tp = model("gptoss")
    d = write_adapter(tmp_path / "a1", tcfg, 6, targets=ATTN)
    jeng, teng = engines(jp, jcfg, tp, tcfg, lora_slots=2, lora_rank=4)
    for e in (jeng, teng):
        e.register_adapter("a1", d)
    assert not any(n.startswith("w_") for n in teng._lora)
    jobs = ["a1", None, "a1"]
    got = streams(teng, prompts(), 10, jobs)
    assert got == streams(jeng, prompts(), 10, jobs)
    assert got[0] != streams(teng, prompts(), 10)[0]


def test_gptoss_sinks_reach_the_kernels_on_cuda(monkeypatch):
    from ome_tpu_torch.ops import flash
    _, _, tcfg, tp = model("gptoss")
    plain = flash.flash_attention
    seen = []

    def kernels(q, k, v, **kw):
        # the kernels' entry point, through their plain versions (the
        # tensors are CPU tensors that report is_cuda)
        seen.append(kw["sinks"])
        q, k, v = (t.as_subclass(torch.Tensor) for t in (q, k, v))
        return plain(q, k, v, **kw)
    monkeypatch.setattr(flash, "flash_attention", kernels)
    lp = llama._layer_params(tp["layers"], 0)
    h = torch.randn(2, 6, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(6)[None].expand(2, 6)
    freqs = llama.rope_frequencies(tcfg, "cpu")
    want = llama._mha(h, lp, tcfg, freqs, pos, None, None, None, 8)
    got = llama._mha(h.as_subclass(FakeCuda), lp, tcfg, freqs, pos, None,
                     None, None, 8)
    assert len(seen) == 1 and torch.equal(seen[0], lp["sinks"])
    np.testing.assert_allclose(got.as_subclass(torch.Tensor).numpy(),
                               want.numpy(), atol=1e-5, rtol=0)


def test_gptoss_checkpoint_loads_leaf_for_leaf(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.GptOssConfig(
        vocab_size=120, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, max_position_embeddings=64, rope_scaling=None,
        tie_word_embeddings=False)
    got, _ = check_hf_checkpoint(save_hf(tmp_path, hf), expect=(
        "layers.sinks", "layers.router_b", "layers.we_gate_b",
        "layers.we_up_b", "layers.we_down_b", "layers.bo"))
    assert got["layers"]["we_gate"].shape == (2, 4, 64, 96)


@pytest.mark.parametrize("mode", ["int8", "int4", "fp8"])
def test_gptoss_quantized_bytes_match_reference(mode):
    # norms, sinks, router, router and expert biases, q/k/v/o biases
    assert check_quant_bytes("gptoss", mode) >= 12


def test_gptoss_paged_kv_refused_by_name():
    check_paged_refused("gptoss", ["attention sinks", "MoE",
                                   "alternating sliding windows"])


def test_gptoss_serves_random_weights(tmp_path):
    engine = check_serve("gptoss", tmp_path)
    lay = engine.model.params["layers"]
    assert lay["sinks"].dtype == lay["router_b"].dtype == torch.float32
