"""Shared cases of the port's Gemma 2, command-r, Cohere2, Phi-3.5-MoE
and gpt-oss tests (tests/test_torch_gemma2.py, test_torch_cohere.py,
test_torch_phimoe.py, test_torch_gptoss.py).

The MLA family (DeepSeek-V2-Lite, V2, V3, V3 with yarn, Kimi-K2:
`MLA_FAMILIES`) has 3 layers, the first of them dense, with seeded
MLA norms and selection bias.

Each family is a tiny HuggingFace-style config.json dict parsed by both
packages' `ModelConfig.from_hf_config`: 2 layers (Cohere2 4: one period
of its pattern), hidden 64, 4 heads over 2 KV heads of 16 dims, a
sliding window of 8 rows where the family has one, fp32. Weights are the
JAX init with every leaf the JAX init leaves out added (gpt-oss's sinks,
router and expert biases; Phi-3.5-MoE's LayerNorm, o_proj and head
biases) and every bias, sink and norm scale replaced by seeded non-zero
numpy values, so that a missing or misplaced term shows; the same numpy
tree goes through the JAX functions and, bridged by `from_jax_params`,
through the port's.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import checkpoint as jckpt
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine, PagedKVUnsupported
from ome_tpu_torch.models import checkpoint, llama
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params, to_numpy

ATOL = 2e-4
SLOTS, MAX_SEQ, BUCKETS = 3, 64, [16, 32]
WINDOW = 8
BASE = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False}
LONG_FACTOR = [1.0, 1.25, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0]
SHORT_FACTOR = [1.0, 1.0, 1.0, 1.05, 1.1, 1.2, 1.3, 1.5]
FAMILIES = {
    # query_pre_attn_scalar 24 (not head_dim 16) so that a scale taken
    # from head_dim shows
    "gemma2": dict(architectures=["Gemma2ForCausalLM"], model_type="gemma2",
                   query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, sliding_window=WINDOW,
                   tie_word_embeddings=True),
    "cohere": dict(architectures=["CohereForCausalLM"], model_type="cohere",
                   logit_scale=0.25, layer_norm_eps=1e-5,
                   tie_word_embeddings=True, use_qk_norm=False),
    "cohere_qk": dict(architectures=["CohereForCausalLM"],
                      model_type="cohere", logit_scale=0.8,
                      layer_norm_eps=1e-5, tie_word_embeddings=True,
                      use_qk_norm=True),
    "cohere2": dict(architectures=["Cohere2ForCausalLM"],
                    model_type="cohere2", num_hidden_layers=4,
                    sliding_window=WINDOW, sliding_window_pattern=4,
                    logit_scale=0.5, layer_norm_eps=1e-5,
                    tie_word_embeddings=True),
    # longrope past its original window: the long factors apply
    "phimoe": dict(architectures=["PhimoeForCausalLM"], model_type="phimoe",
                   num_local_experts=4, num_experts_per_tok=2,
                   attention_bias=True, lm_head_bias=True,
                   router_jitter_noise=0.01, rms_norm_eps=1e-5,
                   original_max_position_embeddings=32,
                   rope_scaling={"rope_type": "longrope",
                                 "short_factor": SHORT_FACTOR,
                                 "long_factor": LONG_FACTOR,
                                 "original_max_position_embeddings": 32}),
    "gptoss": dict(architectures=["GptOssForCausalLM"], model_type="gpt_oss",
                   num_local_experts=4, num_experts_per_tok=2,
                   attention_bias=True, sliding_window=WINDOW,
                   rms_norm_eps=1e-5,
                   rope_scaling={"rope_type": "yarn", "factor": 8.0,
                                 "beta_fast": 32.0, "beta_slow": 1.0,
                                 "original_max_position_embeddings": 32}),
}
# the MLA family (tests/test_torch_mla*.py): 3 layers, the first dense
# (first_k_dense_replace 1), 4 query heads of 16 + 8 (nope + rope) dims
# over a 32-value latent, v 16, 4 experts of 48 (8 for V3-shaped ones)
_DEEPSEEK = dict(num_hidden_layers=3, moe_intermediate_size=48,
                 n_shared_experts=1, num_experts_per_tok=2,
                 kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16, first_k_dense_replace=1)
FAMILIES.update({
    # DeepSeek-V2-Lite: no q LoRA, plain greedy top-k, no normalization
    "dsv2lite": dict(_DEEPSEEK, architectures=["DeepseekV2ForCausalLM"],
                     model_type="deepseek_v2", n_routed_experts=4,
                     q_lora_rank=None, topk_method="greedy", n_group=1,
                     topk_group=1, norm_topk_prob=False,
                     routed_scaling_factor=1.0),
    # DeepSeek-V2: q LoRA and group-limited greedy (2 groups, top 1),
    # a scaling factor it applies without normalization
    "dsv2": dict(_DEEPSEEK, architectures=["DeepseekV2ForCausalLM"],
                 model_type="deepseek_v2", n_routed_experts=4,
                 q_lora_rank=24, topk_method="group_limited_greedy",
                 n_group=2, topk_group=1, norm_topk_prob=False,
                 routed_scaling_factor=1.5),
    # DeepSeek-V3: sigmoid scores, seeded selection bias, top-2-sum
    # group scores, normalization and the scaling factor
    "dsv3": dict(_DEEPSEEK, architectures=["DeepseekV3ForCausalLM"],
                 model_type="deepseek_v3", n_routed_experts=8,
                 num_experts_per_tok=3, q_lora_rank=24, n_group=2,
                 topk_group=1, norm_topk_prob=True,
                 routed_scaling_factor=2.5),
    # DeepSeek-V3 with the yarn scaling its checkpoints ship (mscale
    # corrections of the scores and of cos/sin), past the original window
    "dsv3yarn": dict(_DEEPSEEK, architectures=["DeepseekV3ForCausalLM"],
                     model_type="deepseek_v3", n_routed_experts=8,
                     num_experts_per_tok=3, q_lora_rank=24, n_group=2,
                     topk_group=1, norm_topk_prob=True,
                     routed_scaling_factor=2.5,
                     rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                   "beta_fast": 32, "beta_slow": 1,
                                   "mscale": 0.707, "mscale_all_dim": 1.0,
                                   "original_max_position_embeddings": 16}),
    # Kimi-K2 (DeepseekV3ForCausalLM): one group, more experts per token
    "kimik2": dict(_DEEPSEEK, architectures=["DeepseekV3ForCausalLM"],
                   model_type="kimi_k2", n_routed_experts=8,
                   num_experts_per_tok=4, q_lora_rank=24, n_group=1,
                   topk_group=1, norm_topk_prob=True,
                   routed_scaling_factor=2.827),
})
MLA_FAMILIES = ("dsv2lite", "dsv2", "dsv3", "dsv3yarn", "kimik2")
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(family: str, **over) -> dict:
    return {**BASE, **FAMILIES[family], **over}


def seeded_tree(jcfg, seed: int) -> dict:
    """The JAX init of `jcfg` as numpy, completed to the checkpoint
    loader's leaves, its biases, sinks and norm scales seeded away from
    their init values."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    L, D, H, K, Dh = (jcfg.num_layers, jcfg.hidden_size, jcfg.num_heads,
                      jcfg.num_kv_heads, jcfg.head_dim)
    lay = tree["layers"]

    def noise(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def norm_scale(shape):
        # a unit-offset (Gemma) scale is stored as scale - 1
        return noise(shape, 0.3) + (0.0 if jcfg.unit_offset_norm else 1.0)

    if jcfg.parallel_block:
        del lay["mlp_norm"]  # command-r: one norm feeds both branches
    for name in ("attn_norm", "mlp_norm", "attn_post_norm",
                 "mlp_post_norm"):
        if name in lay:
            lay[name] = norm_scale(lay[name].shape)
    tree["final_norm"] = norm_scale((D,))
    if jcfg.qk_norm:
        per_head = jcfg.norm_type == "layernorm_nobias"
        lay["q_norm"] = norm_scale((L, H, Dh) if per_head else (L, Dh))
        lay["k_norm"] = norm_scale((L, K, Dh) if per_head else (L, Dh))
    if jcfg.norm_type == "layernorm":
        lay["attn_norm_bias"] = noise((L, D), 0.3)
        lay["mlp_norm_bias"] = noise((L, D), 0.3)
        tree["final_norm_bias"] = noise((D,), 0.3)
    if jcfg.attn_bias:
        for name in ("bq", "bk", "bv"):
            lay[name] = noise(lay[name].shape, 0.5)
        lay["bo"] = noise((L, D), 0.1)
    if jcfg.attn_sinks:
        lay["sinks"] = noise((L, H), 1.0)
    if jcfg.moe_bias:
        E = jcfg.num_experts
        Fm = jcfg.moe_intermediate_size or jcfg.intermediate_size
        lay.pop("router_bias", None)  # gpt-oss's router bias is router_b
        lay["router_b"] = noise((L, E), 1.0)
        # gate and up biases past the GLU's +-7 clamps
        lay["we_gate_b"] = noise((L, E, Fm), 6.0)
        lay["we_up_b"] = noise((L, E, Fm), 6.0)
        lay["we_down_b"] = noise((L, E, D), 0.1)
    if jcfg.lm_head_bias:
        tree["lm_head_bias"] = noise((jcfg.vocab_size,), 0.5)
    if jcfg.mla:
        # the MLA norms of both blocks, the dense block's layer norms,
        # and V3's selection bias (zero in the init: inert)
        for blk in (lay, tree.get("dense_layers", {})):
            for name in ("q_a_norm", "kv_a_norm", "attn_norm", "mlp_norm"):
                if name in blk and (blk is not lay or "_a_" in name):
                    blk[name] = norm_scale(blk[name].shape)
        if "router_bias" in lay:
            lay["router_bias"] = noise(lay["router_bias"].shape, 0.05)
    return tree


_MODELS = {}


def model(family: str, **over):
    """(jcfg, jax params, port cfg, port params) of a family in fp32,
    MoE families on the ragged dispatch (the served one)."""
    key = (family, tuple(sorted(over.items())))
    if key not in _MODELS:
        hf = hf_config(family, **over)
        jcfg = JaxConfig.from_hf_config(hf).replace(dtype=jnp.float32)
        tcfg = ModelConfig.from_hf_config(hf).replace(dtype=torch.float32)
        if jcfg.is_moe:
            jcfg = jcfg.replace(moe_impl="ragged")
            tcfg = tcfg.replace(moe_impl="ragged")
        tree = seeded_tree(jcfg, 3)
        _MODELS[key] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                        from_jax_params(tree, "cpu"))
    return _MODELS[key]


def tokens(seed, B, S):
    return np.random.default_rng(seed).integers(3, 256, (B, S),
                                                dtype=np.int32)


def check_logits(family: str, S: int = 13, **over):
    """Prefill logits (S rows, longer than the window), then three
    per-slot decode steps over the dense cache at other lengths, against
    the JAX forward, within ATOL."""
    jcfg, jp, tcfg, tp = model(family, **over)
    toks = tokens(S, 2, S)
    ref, _ = jllama.forward(jp, jcfg, jnp.asarray(toks))
    out, _ = llama.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    jc = jllama.KVCache.create(jcfg, 2, 32)
    tc = llama.KVCache.create(tcfg, 2, 32, device="cpu")
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), cache=jc)
    _, tc = llama.forward(tp, tcfg, torch.from_numpy(toks), cache=tc)
    lengths = np.asarray([S, 6], np.int32)
    step = tokens(S + 1, 2, 1)
    for _ in range(3):
        jc = jllama.KVCache(k=jc.k, v=jc.v, index=jnp.asarray(lengths))
        tc = llama.KVCache(k=tc.k, v=tc.v, index=torch.from_numpy(lengths))
        ref, jc = jllama.forward(jp, jcfg, jnp.asarray(step), cache=jc)
        out, tc = llama.forward(tp, tcfg, torch.from_numpy(step), cache=tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        step = np.asarray(ref)[:, -1].argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + 1


def prompts():
    """Three prompts, two of them longer than the window."""
    return [list(map(int, tokens(s, 1, n)[0]))
            for s, n in ((1, 5), (2, 17), (3, 30))]


def admit(eng, ps, adapters=None):
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(ps):
        kw = {"adapter": adapters[slot]} if adapters and adapters[slot] \
            else {}
        tok, kv, n, bucket = eng.prefill(ids, 0.0, 0, 1.0, **kw)
        state = eng.insert(state, kv, slot, n, tok, bucket, **kw)
        out.append([int(tok)])
    return state, out


def streams(eng, ps, steps, adapters=None):
    state, out = admit(eng, ps, adapters)
    for _ in range(steps - 1):
        state, toks = eng.decode(state, *GREEDY)
        for slot, t in enumerate(np.asarray(toks)[:len(ps)]):
            out[slot].append(int(t))
    return out


def engines(jp, jcfg, tp, tcfg, **kw):
    kw = dict(max_slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=BUCKETS,
              **kw)
    return (JaxEngine(jp, jcfg, **kw),
            InferenceEngine(tp, tcfg, device="cpu", **kw))


_ENGINES = {}


def engine_pair(family: str):
    """(JAX engine, port engine) over `model(family)`, built once per
    module: every use starts from a new decode state."""
    if family not in _ENGINES:
        jcfg, jp, tcfg, tp = model(family)
        _ENGINES[family] = engines(jp, jcfg, tp, tcfg)
    return _ENGINES[family]


def check_streams(family: str, steps: int = 12):
    """Greedy streams through the port's engine equal the JAX
    engine's."""
    jeng, teng = engine_pair(family)
    assert streams(teng, prompts(), steps) == streams(jeng, prompts(),
                                                      steps)


def check_decode_multi_and_verify(family: str):
    """One decode_multi chunk of 8 (slot 1 on a budget of 3) and one
    verify step (slot 0's drafts all right, slot 1's first right, slot 2
    without drafts), then a decode step: the port's tokens, advanced
    counts, accepted counts and lengths equal the JAX engine's."""
    jeng, teng = engine_pair(family)
    ps = prompts()
    res = []
    for eng in (jeng, teng):
        state, _ = admit(eng, ps)
        budget = np.asarray([8, 3, 8], np.int32)
        stops = np.full((SLOTS, 4), -1, np.int32)
        _, toks, adv = eng.decode_multi(state, *GREEDY, steps=8,
                                        budget=budget, stop_ids=stops)
        res.append((np.asarray(toks).tolist(), np.asarray(adv).tolist()))
    assert res[1] == res[0]
    true = res[0][0]
    drafts = np.asarray([true[0][:3], [true[1][0], (true[1][1] + 1) % 256,
                                       7], [0, 0, 0]], np.int32)
    dlen = np.asarray([3, 3, 0], np.int32)
    res = []
    for eng in (jeng, teng):
        state, _ = admit(eng, ps)
        state, out, acc = eng.verify(state, drafts, dlen, *GREEDY)
        state, nxt = eng.decode(state, *GREEDY)
        res.append((np.asarray(out).tolist(), np.asarray(acc).tolist(),
                    np.asarray(state.lengths).tolist(),
                    np.asarray(nxt).tolist()))
    assert res[1] == res[0]
    assert res[1][1] == [3, 1, 0]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def check_hf_checkpoint(model_dir: str, expect=()):
    """A checkpoint written by transformers loads leaf for leaf equal
    through both packages' `load_params` (fp32); `expect` names leaves
    that must be there."""
    ref, jcfg = jckpt.load_params(model_dir, dtype=jnp.float32,
                                  device_put=False)
    got, tcfg = checkpoint.load_params(model_dir, dtype=torch.float32,
                                       device="cpu")
    want, have = _leaves(ref), _leaves(got)
    assert want.keys() == have.keys()
    for name, b in want.items():
        assert have[name].dtype == torch.float32, name
        np.testing.assert_array_equal(to_numpy(have[name]), np.asarray(b),
                                      err_msg=name)
    for name in expect:
        assert name in have, name
    return got, tcfg


def save_hf(tmp_path, hf_cfg) -> str:
    """A tiny random transformers model of `hf_cfg`, saved as a
    safetensors checkpoint under tmp_path."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    m = transformers.AutoModelForCausalLM.from_config(hf_cfg)
    d = str(tmp_path / "model")
    m.save_pretrained(d, safe_serialization=True)
    return d


def check_paged_refused(family: str, words):
    """Paged KV is refused for the family, naming what it has, as the
    reference's engine refuses it."""
    jcfg, jp, tcfg, tp = model(family)
    ref = "paged KV supports standard rmsnorm GQA models"
    with pytest.raises(ValueError, match=ref):
        JaxEngine(jp, jcfg, max_slots=2, max_seq=MAX_SEQ, kv_block=16)
    for w in words:
        with pytest.raises(PagedKVUnsupported, match=w):
            InferenceEngine(tp, tcfg, max_slots=2, max_seq=MAX_SEQ,
                            device="cpu", kv_block=16)


def check_serve(family: str, tmp_path):
    """`serve --random-weights --model-dir DIR` builds the family from
    its config.json alone and answers a completion."""
    (tmp_path / "config.json").write_text(json.dumps(hf_config(family)))
    server, _, engine = serve.build_server(
        ["--model-dir", str(tmp_path), "--random-weights", "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "64", "--dtype", "float32"])
    try:
        body = {"prompt": list(range(5, 25)), "max_tokens": 4,
                "temperature": 0.0}
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert 1 <= doc["usage"]["completion_tokens"] <= 4
    finally:
        server.stop()
    return engine


def check_quant_bytes(family: str, mode: str):
    """`quantize_params` of the family's tree gives the reference's bytes
    for every quantized leaf; biases, sinks, norms and the router stay
    full precision and unchanged."""
    from ome_tpu.models import quant as jquant
    from ome_tpu_torch.models import quant
    _, jp, _, tp = model(family)

    def raw(x):  # the reference's bytes as to_numpy gives the port's
        x = np.asarray(x)
        return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x
    ref = jquant.quantize_params(jp, mode=mode)
    got = quant.quantize_params(tp, mode=mode)
    kept = 0
    for top in ref:
        rt, gt = ref[top], got[top]
        pairs = rt.items() if isinstance(rt, dict) else [(top, rt)]
        for name, b in pairs:
            a = gt[name] if isinstance(gt, dict) else gt
            if isinstance(b, jquant.QTensor):
                assert (a.bits, a.axis) == (b.bits, b.axis), name
                np.testing.assert_array_equal(to_numpy(a.q), raw(b.q),
                                              err_msg=name)
                np.testing.assert_array_equal(to_numpy(a.s), raw(b.s),
                                              err_msg=name)
                continue
            assert not isinstance(a, quant.QTensor), name
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b),
                                          err_msg=name)
            kept += 1
    return kept


class FakeCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, so that the dispatch runs
    without a card."""

    @property
    def is_cuda(self):
        return True
