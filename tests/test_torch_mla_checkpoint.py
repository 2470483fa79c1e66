"""MLA checkpoints in the port, against the JAX package and transformers,
on the CPU.

Tiny transformers DeepSeek models of each MLA shape
(tests/torch_family_cases.py `MLA_FAMILIES`: V2-Lite without q LoRA,
V2 with q LoRA and group-limited greedy, V3 with its seeded
`e_score_correction_bias`, V3 with yarn, Kimi-K2), saved with
`save_pretrained`:

* each loads leaf for leaf equal through both packages' `load_params`
  (fp32): the q projections, `kv_b_proj` split into w_uk / w_uv,
  o_proj as [H, v, D], the DeepSeek `mlp.gate` / `mlp.experts` layout,
  the fp32 selection bias, the shared experts and the `dense_layers`
  block of the first_k_dense layers;
* the port's logits over the loaded weights equal transformers' own
  within 3e-4 (the reference's tests/test_mla.py tolerance);
* `checkpoint.hf_tensors` writes the same tree back under HF names, and
  the file loads bit-equal;
* `quantize_params` gives the reference's bytes for the MLA tree under
  int8, int4 and fp8.
"""

import numpy as np
import pytest
import torch

from ome_tpu_torch.models import checkpoint, llama
from torch_family_cases import (MLA_FAMILIES, _leaves,  # noqa: F401
                                _one_thread, check_hf_checkpoint,
                                check_quant_bytes, hf_config)

transformers = pytest.importorskip("transformers")


def _hf_model(family):
    hf = {k: v for k, v in hf_config(family).items()
          if k not in ("architectures", "model_type", "head_dim")}
    hf["num_key_value_heads"] = hf["num_attention_heads"]
    v3 = hf_config(family)["architectures"][0].startswith("DeepseekV3")
    cls = transformers.DeepseekV3Config if v3 \
        else transformers.DeepseekV2Config
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(cls(**hf)).eval()
    if v3:
        # make the selection bias matter: zeros would be inert
        with torch.no_grad():
            for layer in model.model.layers[1:]:
                layer.mlp.gate.e_score_correction_bias.uniform_(-0.05,
                                                                0.05)
    return model


@pytest.mark.parametrize("family", MLA_FAMILIES)
def test_checkpoint_loads_leaf_for_leaf_and_matches_transformers(
        family, tmp_path):
    model = _hf_model(family)
    d = str(tmp_path / "model")
    model.save_pretrained(d, safe_serialization=True)
    expect = ["dense_layers.w_gate", "layers.w_uk", "layers.w_uv",
              "layers.ws_gate", "layers.we_down"]
    expect.append("layers.wq_a" if hf_config(family)["q_lora_rank"]
                  else "layers.wq")
    if family.startswith(("dsv3", "kimi")):
        expect.append("layers.router_bias")
    params, cfg = check_hf_checkpoint(d, expect)
    assert "router" not in params["dense_layers"]
    toks = torch.tensor([[1, 5, 9, 2, 7, 3, 8, 4]])
    got, _ = llama.forward(params, cfg, toks)
    with torch.no_grad():
        ref = model(toks).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-4,
                               rtol=1e-3)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("family", ["dsv2lite", "dsv3"])
def test_hf_tensors_round_trip(family, tmp_path):
    model = _hf_model(family)
    d = str(tmp_path / "model")
    model.save_pretrained(d, safe_serialization=True)
    params, cfg = checkpoint.load_params(d, dtype=torch.float32,
                                         device="cpu")
    tensors = checkpoint.hf_tensors(params, cfg)
    want = {k: v for k, v in model.state_dict().items()
            if not k.endswith("rotary_emb.inv_freq")}
    assert set(tensors) == set(want)
    out = str(tmp_path / "again")
    checkpoint.save_checkpoint(out, tensors, shards=2)
    (tmp_path / "again" / "config.json").write_text(
        (tmp_path / "model" / "config.json").read_text())
    again, _ = checkpoint.load_params(out, dtype=torch.float32,
                                      device="cpu")
    a, b = _leaves(params), _leaves(again)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("family, mode", [
    ("dsv2lite", "int4"), ("dsv3", "int8"), ("dsv3", "int4"),
    ("dsv3", "fp8")])
def test_quantized_mla_tree_bytes(family, mode):
    kept = check_quant_bytes(family, mode)
    # norms (both blocks' attn/mlp norms, q_a/kv_a norms), routers,
    # the selection bias and the final norm stay full precision
    assert kept >= 8
