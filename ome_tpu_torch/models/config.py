"""Model configuration for the PyTorch port.

Copy of ome_tpu/models/config.py (ModelConfig, from_hf_config,
_rope_attention_factor and the llama3_8b / tiny_test presets) with
`dtype` a torch dtype. The parsed HF config.json drives the port's
models the same way it drives the JAX ones; fields of architectures
the port does not serve yet are parsed all the same, and the model
refuses them (models/llama.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_word_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # MoE (0 experts -> dense MLP)
    num_experts: int = 0
    experts_per_token: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    # "dense" computes every expert (GSPMD-shardable everywhere);
    # "ragged" sorts tokens by expert and runs grouped matmuls
    # (lax.ragged_dot) — O(k/E) of the dense FLOPs, the serving path
    moe_impl: str = "dense"
    # MLA (DeepSeek-V2/V3, Kimi-K2): compressed-KV attention — the KV
    # cache stores per-token latents [kv_lora_rank + qk_rope_head_dim]
    # instead of per-head K/V (models/mla.py)
    mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense: int = 0     # leading dense layers before MoE blocks
    # routing flavor: "mixtral" (softmax over the selected top-k),
    # "softmax_v2" (full softmax, optional group-limited greedy),
    # "sigmoid_v3" (sigmoid + selection bias + top-2-sum group scores)
    router_scoring: str = "mixtral"
    n_group: int = 0
    topk_group: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    router_bias: bool = False  # e_score_correction_bias tensor present
    # attention extras
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    attn_bias: bool = False  # qwen2-style q/k/v projection biases
    # gemma2-family block shape (models/llama.py pair-scan path)
    mlp_activation: str = "silu"      # "silu" | "gelu_tanh"
    alt_sliding_window: bool = False  # periodic sliding/global layers
    sliding_pattern: int = 2          # period P: every P-th is global
    rope_skip_global: bool = False    # cohere2: global layers are NoPE
    query_scale: Optional[float] = None  # overrides head_dim**-0.5
    post_block_norms: bool = False    # post-attn/post-mlp RMSNorms
    embed_scale: bool = False         # x *= sqrt(hidden) after embed
    unit_offset_norm: bool = False    # RMSNorm scales by (1 + w)
    final_logit_softcap: Optional[float] = None
    # round-5 architecture breadth (r4 verdict #5)
    # "rmsnorm" | "layernorm" (torch LayerNorm, affine+bias: phimoe) |
    # "layernorm_nobias" (mean-centered, weight-only: command-r)
    norm_type: str = "rmsnorm"
    parallel_block: bool = False   # command-r: x + attn(n(x)) + mlp(n(x))
    logit_scale: Optional[float] = None  # command-r final-logit mult
    rope_interleaved: bool = False  # command-r even/odd pair rotation
    attn_sinks: bool = False       # gpt_oss per-head learned sink logit
    lm_head_bias: bool = False     # phimoe
    router_jitter: float = 0.0     # phimoe sparsemixer threshold eps
    moe_activation: str = "silu"   # "silu" | "gptoss_glu" (clamped)
    moe_bias: bool = False         # gpt_oss expert + router biases

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    # KV-cache geometry (engine + KVCache.create): MLA caches ONE
    # latent "head" of kv_lora_rank+rope dims and no separate V rows
    @property
    def kv_cache_heads(self) -> int:
        return 1 if self.mla else self.num_kv_heads

    @property
    def kv_cache_k_dim(self) -> int:
        if self.mla:
            return self.kv_lora_rank + self.qk_rope_head_dim
        return self.head_dim

    @property
    def kv_cache_v_dim(self) -> int:
        return 0 if self.mla else self.head_dim

    @property
    def mla_scale(self) -> float:
        """qk_head_dim**-0.5, yarn-mscale-corrected when rope_scaling
        carries mscale_all_dim (DeepseekV3Attention.__init__)."""
        s = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        rs = self.rope_scaling or {}
        mscale_all = rs.get("mscale_all_dim", 0)
        if mscale_all:
            factor = rs.get("factor", 1.0)
            if factor > 1.0:
                import math
                m = 0.1 * mscale_all * math.log(factor) + 1.0
                s *= m * m
        return s

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "ModelConfig":
        """Build from a HuggingFace config.json dict (llama/qwen2/qwen3/
        mistral/mixtral families — the set models/checkpoint.py
        SUPPORTED_ARCHITECTURES accepts)."""
        hidden = cfg.get("hidden_size", 4096)
        heads = cfg.get("num_attention_heads", 32)
        archs = cfg.get("architectures") or [""]
        arch = archs[0]
        sc_raw = cfg.get("rope_scaling")
        if sc_raw and sc_raw.get("rope_type",
                                 sc_raw.get("type")) == "su":
            # normalize early Phi-3's original spelling ONCE so every
            # downstream reader (_rope_frequencies, the attention
            # factor, mla) sees the canonical name
            cfg = dict(cfg, rope_scaling=dict(sc_raw,
                                              rope_type="longrope"))
        deepseek = arch.startswith("Deepseek")
        mla_kw = {}
        if deepseek:
            # DeepSeek-V2/V3 family (Kimi-K2 ships the V3 architecture):
            # MLA attention + first-k-dense MoE + its routing flavor
            v3 = arch.startswith("DeepseekV3")
            mla_kw = dict(
                mla=True,
                q_lora_rank=cfg.get("q_lora_rank"),
                kv_lora_rank=cfg.get("kv_lora_rank", 512),
                qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
                qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
                v_head_dim=cfg.get("v_head_dim", 128),
                first_k_dense=cfg.get("first_k_dense_replace", 0),
                router_scoring="sigmoid_v3" if v3 else "softmax_v2",
                n_group=cfg.get("n_group", 0) or 0,
                topk_group=cfg.get("topk_group", 0) or 0,
                routed_scaling_factor=cfg.get("routed_scaling_factor",
                                              1.0),
                norm_topk_prob=bool(cfg.get("norm_topk_prob", v3)),
                router_bias=v3,
            )
            if not v3 and cfg.get("topk_method") == "greedy":
                mla_kw["n_group"] = 0  # V2-lite: plain greedy top-k
        # qwen2 uses qkv biases (not spelled out in its config.json);
        # qwen3 replaces them with per-head q/k RMS norms
        attn_bias = cfg.get("attention_bias",
                            cfg.get("qkv_bias", arch.startswith("Qwen2")))
        gemma2 = arch == "Gemma2ForCausalLM"
        qscale = None
        if gemma2 and cfg.get("query_pre_attn_scalar"):
            qscale = cfg["query_pre_attn_scalar"] ** -0.5
        # yarn/longrope multiply cos AND sin by an attention factor;
        # q and k both scale, so logits scale by att^2 — fold it into
        # the query scale (KV cache stays unscaled). MLA models apply
        # their own mscale (models/mla.py) and skip this.
        if not deepseek:
            att = _rope_attention_factor(
                cfg.get("rope_scaling"),
                cfg.get("max_position_embeddings", 8192))
            if att != 1.0:
                head_dim = cfg.get("head_dim") or hidden // heads
                qscale = (qscale if qscale is not None
                          else head_dim ** -0.5) * att * att
        extra = {}
        if arch in ("PhimoeForCausalLM", "PhiMoEForCausalLM"):
            # the official Phi-3.5-MoE repo ships the capital-E
            # spelling; the transformers class uses Phimoe
            # Phi-3.5-MoE: torch LayerNorm (bias) everywhere, optional
            # lm_head bias, sparsemixer top-2 routing
            # (cite ref: pkg/hfutil/modelconfig parses phimoe configs)
            extra = dict(norm_type="layernorm",
                         lm_head_bias=bool(cfg.get("lm_head_bias")),
                         router_scoring="sparsemixer",
                         router_jitter=cfg.get("router_jitter_noise",
                                               0.01) or 0.0)
        elif arch == "Cohere2ForCausalLM":
            # command-r7b / command-a: the cohere parallel block plus
            # a period-4 sliding pattern whose global layers skip RoPE
            # (cite ref: pkg/hfutil/modelconfig parses cohere2)
            extra = dict(norm_type="layernorm_nobias",
                         parallel_block=True,
                         logit_scale=cfg.get("logit_scale", 1.0),
                         rope_interleaved=True,
                         rms_norm_eps=cfg.get("layer_norm_eps", 1e-5),
                         alt_sliding_window=True,
                         sliding_pattern=cfg.get(
                             "sliding_window_pattern", 4),
                         rope_skip_global=True)
        elif arch in ("CohereForCausalLM", "CohereModel"):
            # command-r: weight-only mean-centered LayerNorm, PARALLEL
            # attn+MLP residual off one shared norm, interleaved rope,
            # logit scaling, per-head q/k norms on R+
            # (cite ref: pkg/hfutil/modelconfig/commandr.go)
            extra = dict(norm_type="layernorm_nobias",
                         parallel_block=True,
                         logit_scale=cfg.get("logit_scale", 1.0),
                         rope_interleaved=True,
                         qk_norm=bool(cfg.get("use_qk_norm")),
                         rms_norm_eps=cfg.get("layer_norm_eps", 1e-5))
        elif arch == "GptOssForCausalLM":
            # gpt-oss: attention sinks, alternating sliding layers,
            # top-4 softmax router with bias, clamped-GLU experts with
            # biases (cite ref: pkg/hfutil/modelconfig/gpt_oss.go)
            extra = dict(attn_sinks=True, alt_sliding_window=True,
                         router_bias=True, moe_bias=True,
                         moe_activation="gptoss_glu",
                         moe_intermediate_size=cfg.get(
                             "intermediate_size", 4 * hidden))
        kw = dict(
            vocab_size=cfg.get("vocab_size", 32000),
            hidden_size=hidden,
            num_layers=cfg.get("num_hidden_layers", 32),
            num_heads=heads,
            num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim") or hidden // heads,
            intermediate_size=cfg.get("intermediate_size", 4 * hidden),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_seq_len=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            num_experts=cfg.get("num_local_experts",
                                cfg.get("num_experts",
                                        cfg.get("n_routed_experts", 0))) or 0,
            experts_per_token=cfg.get("num_experts_per_tok", 0) or 0,
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0) or 0,
            num_shared_experts=cfg.get("n_shared_experts", 0) or 0,
            sliding_window=cfg.get("sliding_window")
            if cfg.get("use_sliding_window", True) else None,
            attn_logit_softcap=cfg.get("attn_logit_softcapping"),
            qk_norm=arch.startswith("Qwen3"),
            attn_bias=bool(attn_bias),
            mlp_activation="gelu_tanh" if gemma2 else "silu",
            alt_sliding_window=gemma2,
            query_scale=qscale,
            post_block_norms=gemma2,
            embed_scale=gemma2,
            unit_offset_norm=gemma2,
            final_logit_softcap=cfg.get("final_logit_softcapping"),
        )
        kw.update(mla_kw)
        kw.update(extra)  # per-architecture overrides win
        return cls(**kw)


def _rope_attention_factor(sc: Optional[Dict[str, Any]],
                           max_pos: int) -> float:
    """cos/sin attention factor of yarn/longrope scaling (transformers
    _compute_{yarn,longrope}_parameters)."""
    if not sc:
        return 1.0
    import math
    t = sc.get("rope_type", sc.get("type"))
    if t == "yarn":
        att = sc.get("attention_factor")
        if att is not None:
            return float(att)
        f = sc.get("factor", 1.0)
        return 0.1 * math.log(f) + 1.0 if f > 1 else 1.0
    if t == "longrope":
        att = sc.get("attention_factor")
        if att is not None:
            return float(att)
        orig = sc.get("original_max_position_embeddings") or max_pos
        s = max_pos / orig
        if s <= 1.0:
            return 1.0
        return math.sqrt(1.0 + math.log(s) / math.log(orig))
    return 1.0


# -- presets ---------------------------------------------------------------

def llama3_8b() -> ModelConfig:
    return ModelConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                       num_heads=32, num_kv_heads=8, head_dim=128,
                       intermediate_size=14336, rope_theta=500000.0,
                       max_seq_len=8192)


def tiny_test(moe: bool = False) -> ModelConfig:
    """Structurally-faithful small config for tests and dry runs."""
    return ModelConfig(vocab_size=512, hidden_size=128, num_layers=4,
                       num_heads=8, num_kv_heads=4, head_dim=16,
                       intermediate_size=256, max_seq_len=256,
                       rope_theta=10000.0,
                       num_experts=8 if moe else 0,
                       experts_per_token=2 if moe else 0,
                       moe_intermediate_size=128 if moe else 0)
