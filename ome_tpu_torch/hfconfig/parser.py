"""HuggingFace config.json parsing — architecture registry.

Re-designs pkg/hfutil/modelconfig (SURVEY.md §2.7: ~45 per-architecture
parsers implementing the HuggingFaceModel interface,
modelconfig/interface.go:16-47). Instead of one Go file per family,
a registry maps model_type → a FamilyHandler that supplies capability
flags and a parameter-count formula; dense-transformer families share
the generic estimator and only structurally different families (MoE
variants, MLA, SSM, encoder-decoder, encoders, diffusion) override it.

When a safetensors index is available the exact parameter count comes
from its total_size instead of the formula (the reference parses
weights metadata the same way).

Port of ome_tpu/hfconfig/parser.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..apis.v1 import ModelCapability, format_parameter_size


@dataclass
class ParsedModelConfig:
    model_type: str = ""
    architecture: str = ""
    parameter_count: int = 0
    context_length: int = 0
    quantization: Optional[str] = None
    capabilities: List[str] = field(default_factory=list)
    torch_dtype: str = "bfloat16"
    hidden_size: int = 0
    num_layers: int = 0
    num_experts: int = 0
    vision: bool = False
    raw: Dict = field(default_factory=dict)

    @property
    def parameter_size(self) -> str:
        return format_parameter_size(float(self.parameter_count))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


class ConfigParseError(ValueError):
    pass


def _g(cfg: Dict, *keys, default=0):
    for k in keys:
        if cfg.get(k) is not None:
            return cfg[k]
    return default


# -- generic dense-transformer estimator -----------------------------------


def dense_params(cfg: Dict) -> int:
    """Llama-family superset: embeddings + per-layer GQA attention +
    gated MLP + norms (+ biases where the family uses them)."""
    V = _g(cfg, "vocab_size", default=32000)
    D = _g(cfg, "hidden_size", "n_embd", "d_model", default=4096)
    L = _g(cfg, "num_hidden_layers", "n_layer", "num_layers", default=32)
    H = _g(cfg, "num_attention_heads", "n_head", default=32)
    K = _g(cfg, "num_key_value_heads", default=H) or H
    Dh = _g(cfg, "head_dim", default=D // max(H, 1))
    F = _g(cfg, "intermediate_size", "n_inner", "ffn_dim",
           default=4 * D)
    attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
    if _g(cfg, "attention_bias", "qkv_bias", default=False):
        attn += (H + 2 * K) * Dh + D
    gates = 3 if _g(cfg, "hidden_act", "activation_function",
                    default="silu") in ("silu", "swiglu", "gelu_pytorch_tanh",
                                        "gelu") else 2
    mlp = gates * D * F
    norms = 2 * D
    embed = V * D
    if not _g(cfg, "tie_word_embeddings", default=False):
        embed *= 2
    return embed + L * (attn + mlp + norms) + D


def moe_params(cfg: Dict) -> int:
    """Mixtral/Qwen-MoE-style: every layer's MLP replaced by E experts
    + router (+ optional shared experts)."""
    D = _g(cfg, "hidden_size", default=4096)
    L = _g(cfg, "num_hidden_layers", default=32)
    E = _g(cfg, "num_local_experts", "num_experts", "n_routed_experts")
    Fm = _g(cfg, "moe_intermediate_size",
            default=_g(cfg, "intermediate_size", default=4 * D))
    shared = _g(cfg, "n_shared_experts", "num_shared_experts", default=0)
    dense = dense_params(cfg)
    F = _g(cfg, "intermediate_size", default=4 * D)
    dense_mlp = 3 * D * F * L
    expert_mlp = L * (E * 3 * D * Fm + D * E + shared * 3 * D * Fm)
    return dense - dense_mlp + expert_mlp


def deepseek_params(cfg: Dict) -> int:
    """DeepSeek-V2/V3 MLA + MoE with dense first-k layers."""
    V = _g(cfg, "vocab_size", default=102400)
    D = _g(cfg, "hidden_size", default=5120)
    L = _g(cfg, "num_hidden_layers", default=60)
    H = _g(cfg, "num_attention_heads", default=128)
    q_lora = _g(cfg, "q_lora_rank", default=0)
    kv_lora = _g(cfg, "kv_lora_rank", default=512)
    qk_nope = _g(cfg, "qk_nope_head_dim", default=128)
    qk_rope = _g(cfg, "qk_rope_head_dim", default=64)
    v_dim = _g(cfg, "v_head_dim", default=128)
    qk_dim = qk_nope + qk_rope
    if q_lora:
        attn = D * q_lora + q_lora * H * qk_dim
    else:
        attn = D * H * qk_dim
    attn += D * (kv_lora + qk_rope) + kv_lora * H * (qk_nope + v_dim)
    attn += H * v_dim * D
    F = _g(cfg, "intermediate_size", default=12288)
    Fm = _g(cfg, "moe_intermediate_size", default=1536)
    E = _g(cfg, "n_routed_experts", default=0)
    shared = _g(cfg, "n_shared_experts", default=0)
    first_dense = _g(cfg, "first_k_dense_replace", default=0 if E else L)
    moe_layers = L - first_dense if E else 0
    dense_layers = L - moe_layers
    mlp_dense = 3 * D * F
    mlp_moe = E * 3 * D * Fm + D * E + shared * 3 * D * Fm
    total = 2 * V * D + D
    total += L * (attn + 2 * D)
    total += dense_layers * mlp_dense + moe_layers * mlp_moe
    return total


def mamba_params(cfg: Dict) -> int:
    V = _g(cfg, "vocab_size", default=50280)
    D = _g(cfg, "hidden_size", "d_model", default=2560)
    L = _g(cfg, "num_hidden_layers", "n_layer", default=64)
    expand = _g(cfg, "expand", default=2)
    state = _g(cfg, "state_size", "d_state", default=16)
    conv = _g(cfg, "conv_kernel", "d_conv", default=4)
    Di = expand * D
    per_layer = (2 * D * Di          # in_proj
                 + Di * conv         # conv1d
                 + Di * (2 * state)  # x_proj (B,C)
                 + Di                # dt
                 + Di * state        # A
                 + Di * D + D)       # out_proj + norm
    return V * D + L * per_layer + D


def encdec_params(cfg: Dict) -> int:
    """T5-style encoder-decoder."""
    V = _g(cfg, "vocab_size", default=32128)
    D = _g(cfg, "d_model", "hidden_size", default=768)
    Le = _g(cfg, "num_layers", default=12)
    Ld = _g(cfg, "num_decoder_layers", default=Le)
    F = _g(cfg, "d_ff", "intermediate_size", default=4 * D)
    attn = 4 * D * D
    enc = Le * (attn + 2 * D * F + 2 * D)
    dec = Ld * (2 * attn + 2 * D * F + 3 * D)
    return V * D + enc + dec


# -- registry ---------------------------------------------------------------

TEXT_GEN = [ModelCapability.TEXT_GENERATION.value,
            ModelCapability.CHAT.value]
EMBED = [ModelCapability.TEXT_EMBEDDINGS.value]


@dataclass
class FamilyHandler:
    model_type: str
    params: Callable[[Dict], int] = dense_params
    capabilities: List[str] = field(default_factory=lambda: list(TEXT_GEN))
    vision: bool = False
    context_keys: tuple = ("max_position_embeddings",)
    # nested sub-config holding the text model (VLM composites)
    text_config_key: Optional[str] = None


_REGISTRY: Dict[str, FamilyHandler] = {}


def register(handler: FamilyHandler):
    _REGISTRY[handler.model_type] = handler


def _vlm(model_type: str, text_key: str = "text_config") -> FamilyHandler:
    return FamilyHandler(
        model_type, params=dense_params,
        capabilities=TEXT_GEN + [ModelCapability.VISION.value],
        vision=True, text_config_key=text_key)


for _t in ("llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2",
           "phi", "phi3", "stablelm", "internlm2", "baichuan", "yi",
           "olmo", "olmo2", "granite", "starcoder2", "gpt_neox", "mpt",
           "falcon", "exaone", "nemotron", "glm", "glm4", "chatglm",
           "smollm", "gpt_bigcode"):
    register(FamilyHandler(_t))
register(FamilyHandler("gpt2", context_keys=("n_positions", "n_ctx")))
register(FamilyHandler("gemma3_text"))
register(FamilyHandler("cohere"))   # command-r
register(FamilyHandler("cohere2"))
for _t in ("mixtral", "qwen2_moe", "qwen3_moe", "phimoe", "dbrx",
           "jamba", "olmoe", "arctic", "gpt_oss", "grok-1", "minimax",
           "granitemoe"):
    register(FamilyHandler(_t, params=moe_params))
for _t in ("deepseek", "deepseek_v2", "deepseek_v3", "kimi_k2",
           "minicpm3"):
    register(FamilyHandler(_t, params=deepseek_params))
register(FamilyHandler("llama4", params=moe_params,
                       text_config_key="text_config",
                       capabilities=TEXT_GEN
                       + [ModelCapability.VISION.value], vision=True))
for _t, _k in (("qwen2_vl", None), ("qwen2_5_vl", None),
               ("mllama", "text_config"), ("llava", "text_config"),
               ("paligemma", "text_config"), ("gemma3", "text_config"),
               ("idefics3", "text_config"), ("internvl_chat", "llm_config"),
               ("pixtral", "text_config"), ("mistral3", "text_config")):
    register(_vlm(_t, _k) if _k else FamilyHandler(
        _t, capabilities=TEXT_GEN + [ModelCapability.VISION.value],
        vision=True))
for _t in ("bert", "roberta", "xlm-roberta", "distilbert", "nomic_bert",
           "modernbert"):
    register(FamilyHandler(_t, capabilities=list(EMBED)))
register(FamilyHandler("t5", params=encdec_params,
                       capabilities=[ModelCapability.TEXT_GENERATION.value],
                       context_keys=("n_positions",)))
register(FamilyHandler("mamba", params=mamba_params))
register(FamilyHandler("falcon_mamba", params=mamba_params))


# -- entry points -----------------------------------------------------------


def detect_quantization(cfg: Dict) -> Optional[str]:
    q = cfg.get("quantization_config") or {}
    method = q.get("quant_method")
    if method == "fp8":
        return "fbgemm_fp8" if q.get("modules_to_not_convert") else "fp8"
    if method in ("gptq", "awq"):
        bits = q.get("bits", 4)
        return f"int{bits}"
    if method == "bitsandbytes":
        return "int8" if q.get("load_in_8bit") else "int4"
    if method in ("mxfp4", "compressed-tensors"):
        return method
    return None


def safetensors_param_count(model_dir: str, dtype: str) -> Optional[int]:
    """Exact count from model.safetensors.index.json total_size."""
    idx = os.path.join(model_dir, "model.safetensors.index.json")
    if not os.path.exists(idx):
        return None
    try:
        with open(idx) as f:
            meta = json.load(f).get("metadata", {})
        total = meta.get("total_size")
    except (ValueError, OSError):
        return None
    if not total:
        return None
    bytes_per = {"float32": 4, "float16": 2, "bfloat16": 2,
                 "int8": 1, "fp8": 1, "float8_e4m3fn": 1}.get(dtype, 2)
    return int(total) // bytes_per


def parse_config(cfg: Dict, model_dir: Optional[str] = None,
                 ) -> ParsedModelConfig:
    if "_class_name" in cfg or "_diffusers_version" in cfg:
        return _parse_diffusion(cfg)
    model_type = cfg.get("model_type", "")
    archs = cfg.get("architectures") or []
    handler = _REGISTRY.get(model_type)
    if handler is None:
        # fall back on the architecture name's family, then generic
        for t, h in _REGISTRY.items():
            if archs and archs[0].lower().startswith(t.replace("_", "")):
                handler = h
                break
    if handler is None:
        handler = FamilyHandler(model_type or "unknown")

    text_cfg = cfg
    if handler.text_config_key and handler.text_config_key in cfg:
        text_cfg = {**cfg[handler.text_config_key]}
        text_cfg.setdefault("model_type", model_type)

    dtype = cfg.get("torch_dtype") or text_cfg.get("torch_dtype") \
        or "bfloat16"
    count = None
    if model_dir:
        count = safetensors_param_count(model_dir, dtype)
    if count is None:
        count = handler.params(text_cfg)

    ctx = 0
    for k in handler.context_keys + ("max_position_embeddings",):
        v = text_cfg.get(k) or cfg.get(k)
        if v:
            ctx = int(v)
            break

    return ParsedModelConfig(
        model_type=model_type,
        architecture=archs[0] if archs else "",
        parameter_count=int(count),
        context_length=ctx,
        quantization=detect_quantization(cfg),
        capabilities=list(handler.capabilities),
        torch_dtype=str(dtype),
        hidden_size=_g(text_cfg, "hidden_size", "d_model", "n_embd"),
        num_layers=_g(text_cfg, "num_hidden_layers", "n_layer",
                      "num_layers"),
        num_experts=_g(text_cfg, "num_local_experts", "num_experts",
                       "n_routed_experts"),
        vision=handler.vision,
        raw=cfg)


def _parse_diffusion(cfg: Dict) -> ParsedModelConfig:
    """model_index.json (diffusers pipelines: SD/SDXL/Flux...)."""
    cls = cfg.get("_class_name", "DiffusionPipeline")
    return ParsedModelConfig(
        model_type="diffusion",
        architecture=cls,
        capabilities=[ModelCapability.IMAGE_GENERATION.value],
        raw=cfg)


def parse_model_dir(model_dir: str) -> ParsedModelConfig:
    """Find + parse config.json or model_index.json
    (config_parser.go:51-124 behavior)."""
    for name in ("config.json", "model_index.json"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                try:
                    cfg = json.load(f)
                except ValueError as e:
                    raise ConfigParseError(f"{p}: invalid JSON: {e}")
            return parse_config(cfg, model_dir=model_dir)
    raise ConfigParseError(
        f"no config.json or model_index.json under {model_dir!r}")


def supported_model_types() -> List[str]:
    return sorted(_REGISTRY)
