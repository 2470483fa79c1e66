"""The port's HF config parser (ome_tpu_torch/hfconfig/) and model API
types (ome_tpu_torch/apis/v1/model.py) against the JAX package's.

* the configs of tests/test_storage_agent.py::TestHFConfig, and one
  config per registered family, give equal `ParsedModelConfig` fields
  (and the same `ConfigParseError` for a directory without a config);
* a checkpoint written by the port's `models/checkpoint.save_checkpoint`
  (bf16, two shards and an index) parses in both packages to the same
  family, and its exact parameter count equals the sum of the written
  tensors' `numel`;
* `parse_parameter_size` / `format_parameter_size` agree.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from ome_tpu.apis.v1 import model as jmodel
from ome_tpu.hfconfig import parser as jparser
from ome_tpu_torch.apis.v1 import model
from ome_tpu_torch.hfconfig import parser
from ome_tpu_torch.models import checkpoint
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import init_params

LLAMA8B = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "vocab_size": 128256, "hidden_size": 4096, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 14336, "max_position_embeddings": 8192}
# tests/test_storage_agent.py::TestHFConfig
CONFIGS = {
    "llama8b": LLAMA8B,
    "mixtral": {"model_type": "mixtral", "vocab_size": 32000,
                "hidden_size": 4096, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "num_local_experts": 8,
                "max_position_embeddings": 32768},
    "deepseek_v3": {"model_type": "deepseek_v3", "vocab_size": 129280,
                    "hidden_size": 7168, "num_hidden_layers": 61,
                    "num_attention_heads": 128, "q_lora_rank": 1536,
                    "kv_lora_rank": 512, "qk_nope_head_dim": 128,
                    "qk_rope_head_dim": 64, "v_head_dim": 128,
                    "intermediate_size": 18432,
                    "moe_intermediate_size": 2048,
                    "n_routed_experts": 256, "n_shared_experts": 1,
                    "first_k_dense_replace": 3,
                    "max_position_embeddings": 163840},
    "bert": {"model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072},
    "gemma3_vlm": {"model_type": "gemma3",
                   "architectures": ["Gemma3ForConditionalGeneration"],
                   "text_config": {"vocab_size": 262144,
                                   "hidden_size": 2560,
                                   "num_hidden_layers": 34,
                                   "num_attention_heads": 8,
                                   "num_key_value_heads": 4,
                                   "intermediate_size": 10240,
                                   "max_position_embeddings": 131072}},
    "fp8": {"model_type": "llama",
            "quantization_config": {"quant_method": "fp8"}},
    "gptq4": {"model_type": "llama",
              "quantization_config": {"quant_method": "gptq", "bits": 4}},
    "bnb8": {"model_type": "llama", "quantization_config": {
        "quant_method": "bitsandbytes", "load_in_8bit": True}},
    "arch_only": {"architectures": ["MistralForCausalLM"],
                  "hidden_size": 1024, "num_hidden_layers": 2},
    "unknown": {"model_type": "not-a-family"},
    "diffusion": {"_class_name": "StableDiffusionXLPipeline",
                  "_diffusers_version": "0.19.0"},
}


def _fields(p):
    d = dataclasses.asdict(p)
    d["parameter_size"] = p.parameter_size
    d["is_moe"] = p.is_moe
    return d


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parsed_fields_equal(name):
    got = _fields(parser.parse_config(CONFIGS[name]))
    want = _fields(jparser.parse_config(CONFIGS[name]))
    assert got == want
    if name == "llama8b":
        assert abs(got["parameter_count"] - 8.03e9) / 8.03e9 < 0.01
        assert "TEXT_GENERATION" in got["capabilities"]


def test_every_family_handler_equal():
    assert parser.supported_model_types() == jparser.supported_model_types()
    base = {k: v for k, v in LLAMA8B.items() if k != "architectures"}
    for t in parser.supported_model_types():
        cfg = {**base, "model_type": t, "num_local_experts": 4,
               "torch_dtype": "float16"}
        assert _fields(parser.parse_config(cfg)) == \
            _fields(jparser.parse_config(cfg)), t


def test_model_dir_without_a_config_raises_in_both(tmp_path):
    for mod in (parser, jparser):
        with pytest.raises(mod.ConfigParseError) as e:
            mod.parse_model_dir(str(tmp_path))
        assert "no config.json" in str(e.value)
    (tmp_path / "config.json").write_text("{not json")
    msgs = []
    for mod in (parser, jparser):
        with pytest.raises(mod.ConfigParseError) as e:
            mod.parse_model_dir(str(tmp_path))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_diffusion_model_index_equal(tmp_path):
    (tmp_path / "model_index.json").write_text(json.dumps(
        CONFIGS["diffusion"]))
    got = _fields(parser.parse_model_dir(str(tmp_path)))
    assert got == _fields(jparser.parse_model_dir(str(tmp_path)))
    assert got["capabilities"] == ["IMAGE_GENERATION"]


@pytest.mark.parametrize("dtype,shards", [(torch.bfloat16, 2),
                                          (torch.float32, 3)])
def test_port_checkpoint_exact_count_in_both(tmp_path, dtype, shards):
    cfg = tiny_test().replace(dtype=dtype, num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tensors = checkpoint.hf_tensors(params, cfg)
    checkpoint.save_checkpoint(str(tmp_path), tensors, shards=shards)
    hf = {"architectures": ["LlamaForCausalLM"],
          "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "num_hidden_layers": cfg.num_layers,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads,
          "intermediate_size": cfg.intermediate_size,
          "max_position_embeddings": cfg.max_seq_len}
    if dtype == torch.float32:
        hf["torch_dtype"] = "float32"
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = _fields(parser.parse_model_dir(str(tmp_path)))
    assert got == _fields(jparser.parse_model_dir(str(tmp_path)))
    assert got["model_type"] == "" and got["architecture"] == \
        "LlamaForCausalLM"
    assert got["parameter_count"] == sum(t.numel() for t in tensors.values())
    # the estimate without the index is the formula's, in both
    assert parser.parse_config(hf).parameter_count == \
        jparser.parse_config(hf).parameter_count


@pytest.mark.parametrize("s", ["8.03B", "670B", "500M", "1.5T", "12K",
                               "7b params", " 3.2 B ", "42", "", None,
                               "abcB"])
def test_parameter_size_helpers_equal(s):
    assert model.parse_parameter_size(s) == jmodel.parse_parameter_size(s)
    n = model.parse_parameter_size(s)
    if n is not None:
        assert model.format_parameter_size(n) == \
            jmodel.format_parameter_size(n)


def test_model_types_equal():
    for name in ("ModelQuantization", "DownloadPolicy", "ModelCapability",
                 "ModelState"):
        assert [(e.name, e.value) for e in getattr(model, name)] == \
            [(e.name, e.value) for e in getattr(jmodel, name)]
    for name in ("ModelFormat", "ModelFrameworkSpec", "StorageSpec",
                 "BaseModelSpec", "ModelStatusSpec", "FineTunedWeightSpec"):
        assert [f.name for f in dataclasses.fields(getattr(model, name))] \
            == [f.name for f in dataclasses.fields(getattr(jmodel, name))]
    for name in ("BaseModel", "ClusterBaseModel", "FineTunedWeight"):
        a, b = getattr(model, name), getattr(jmodel, name)
        assert (a.KIND, a.NAMESPACED) == (b.KIND, b.NAMESPACED)
    rng = np.random.default_rng(0)
    for n in rng.integers(1, 10 ** 13, 50):
        assert model.format_parameter_size(float(n)) == \
            jmodel.format_parameter_size(float(n))
