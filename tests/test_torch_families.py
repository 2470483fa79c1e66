"""Qwen2 and Qwen3 in the port, against the JAX package.

Tiny configurations of each family are built from HuggingFace-style
config.json dicts through both packages' `ModelConfig.from_hf_config`
(Qwen2: q/k/v projection biases; Qwen3: per-head q/k RMSNorm; Mixtral's
dict and models are built here too, for tests/test_torch_moe.py), at
the group sizes G = H/K of 2, 3 and 7. Weights are the JAX init in fp32
with the biases and the q/k norm scales replaced by seeded non-zero
values (the init's zeros and ones would hide a missing or misplaced
term), bridged to the port with `from_jax_params`. Then, on the CPU:

* logits of `forward` (prefill, then per-slot decode over the dense
  cache) at G 2, 3, 7 and of `forward_paged` (S = 1 and S = 3) at G 3
  and 7 are within 2e-4 of the JAX functions';
* greedy streams through the engines equal the JAX engine's, dense and
  paged;
* a checkpoint of each family written by the port's `hf_tensors` and
  `save_checkpoint` in `tmp_path` loads leaf for leaf equal to the JAX
  `load_params` and to the tree it was written from;
* int8 and int4 quantization of a bf16 Qwen2 / Qwen3 tree gives the
  reference's bytes for every quantized leaf and leaves the biases and
  the q/k norm scales in full precision, as the reference does;
* the kernels' group-size gates take every whole G (above 16 through
  head chunks) and refuse a group that is not whole by name, before any
  launch; G 17 on a CUDA tensor goes to the kernel, not the plain path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import checkpoint as jckpt
from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models import checkpoint, llama, quant
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params, to_numpy
from ome_tpu_torch.ops import flash

ATOL = 2e-4
BASE = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False}
FAMILIES = {
    "qwen2": dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
                  use_sliding_window=False),
    "qwen3": dict(architectures=["Qwen3ForCausalLM"], model_type="qwen3"),
    "mixtral": dict(architectures=["MixtralForCausalLM"],
                    model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2),
}
SLOTS, MAX_SEQ = 3, 64
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(family: str, G: int = 2) -> dict:
    return dict(BASE, num_attention_heads=2 * G, **FAMILIES[family])


_MODELS = {}


def model(family: str, G: int = 2):
    """(jcfg, jax params, port cfg, port params) of a family at group
    size G: the JAX init with non-zero biases and norm scales."""
    key = (family, G)
    if key not in _MODELS:
        hf = hf_config(family, G)
        jcfg = JaxConfig.from_hf_config(hf).replace(dtype=jnp.float32)
        tcfg = ModelConfig.from_hf_config(hf).replace(dtype=torch.float32)
        if jcfg.is_moe:
            jcfg = jcfg.replace(moe_impl="ragged")
            tcfg = tcfg.replace(moe_impl="ragged")
        tree = jax.tree.map(np.asarray, jllama.init_params(
            jax.random.PRNGKey(G), jcfg))
        rng = np.random.default_rng(G)
        lay = tree["layers"]
        for name in ("bq", "bk", "bv"):
            if name in lay:
                lay[name] = (0.5 * rng.standard_normal(lay[name].shape)
                             ).astype(np.float32)
        for name in ("q_norm", "k_norm"):
            if name in lay:
                lay[name] = (1.0 + 0.3 * rng.standard_normal(
                    lay[name].shape)).astype(np.float32)
        _MODELS[key] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                        from_jax_params(tree, "cpu"))
    return _MODELS[key]


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(3, 256, (B, S),
                                                dtype=np.int32)


def check_forward(family, G):
    """Prefill logits, then two per-slot decode steps over the dense
    cache, against the JAX forward."""
    jcfg, jp, tcfg, tp = model(family, G)
    lay = tp["layers"]
    assert ("bq" in lay) == (family == "qwen2")
    assert ("q_norm" in lay) == (family == "qwen3")
    assert ("we_gate" in lay) == (family == "mixtral")
    toks = _tokens(G, 2, 13)
    ref, _ = jllama.forward(jp, jcfg, jnp.asarray(toks))
    out, _ = llama.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # prefill into a cache, then per-slot decode at other lengths
    jc = jllama.KVCache.create(jcfg, 2, 32)
    tc = llama.KVCache.create(tcfg, 2, 32, device="cpu")
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), cache=jc)
    _, tc = llama.forward(tp, tcfg, torch.from_numpy(toks), cache=tc)
    lengths = np.asarray([13, 6], np.int32)
    step = _tokens(G + 1, 2, 1)
    for _ in range(2):
        jc = jllama.KVCache(k=jc.k, v=jc.v, index=jnp.asarray(lengths))
        tc = llama.KVCache(k=tc.k, v=tc.v, index=torch.from_numpy(lengths))
        ref, jc = jllama.forward(jp, jcfg, jnp.asarray(step), cache=jc)
        out, tc = llama.forward(tp, tcfg, torch.from_numpy(step), cache=tc)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
        step = np.asarray(ref)[:, -1].argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + 1


@pytest.mark.parametrize("G", [2, 3, 7])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_forward_matches_reference(family, G):
    check_forward(family, G)


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("G", [3, 7])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_forward_paged_matches_reference(family, G, S):
    jcfg, jp, tcfg, tp = model(family, G)
    rng = np.random.default_rng(10 * G + S)
    L, K, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    B, bs, M, N = 3, 16, 4, 14
    kp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    table = table.astype(np.int32)
    index = np.asarray([5, 20, 40], np.int32)
    jc = jllama.PagedKVCache(k=jnp.asarray(kp), v=jnp.asarray(vp),
                             index=jnp.asarray(index),
                             table=jnp.asarray(table))
    tc = llama.PagedKVCache(k=torch.from_numpy(kp), v=torch.from_numpy(vp),
                            index=torch.from_numpy(index),
                            table=torch.from_numpy(table))
    toks = _tokens(S, B, S)
    ref, jnew = jllama.forward_paged(jp, jcfg, jnp.asarray(toks), jc)
    out, tnew = llama.forward_paged(tp, tcfg, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(tnew.index.numpy(), np.asarray(jnew.index))


def streams(eng, prompts, steps):
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, n, bucket = eng.prefill(ids, 0.0, 0, 1.0)
        state = eng.insert(state, kv, slot, n, tok, bucket)
        out.append([int(tok)])
    for _ in range(steps - 1):
        state, toks = eng.decode(state, *GREEDY)
        for slot, t in enumerate(np.asarray(toks)[:len(prompts)]):
            out[slot].append(int(t))
    return out


def prompts():
    return [list(map(int, _tokens(s, 1, n)[0]))
            for s, n in ((1, 5), (2, 17), (3, 30))]


@pytest.mark.parametrize("family,cache", [
    ("qwen2", "dense"), ("qwen2", "paged"), ("qwen3", "dense"),
    ("qwen3", "paged")])
def test_greedy_streams_match_jax_engine(family, cache):
    jcfg, jp, tcfg, tp = model(family, 7 if family == "qwen2" else 2)
    kw = dict(kv_block=16, kv_blocks=20) if cache == "paged" else {}
    jeng = JaxEngine(jp, jcfg, max_slots=SLOTS, max_seq=MAX_SEQ, **kw)
    teng = InferenceEngine(tp, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                           device="cpu", **kw)
    assert streams(teng, prompts(), 12) == streams(jeng, prompts(), 12)
    if cache == "paged":
        for slot in range(3):
            teng.free_slot(slot)
        assert teng.kv_conservation()[0]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def check_checkpoint(family, tmp_path):
    """hf_tensors + save_checkpoint (two shards and an index), then both
    packages' load_params: the same tree, equal to the one written."""
    _, _, _, tp = model(family, 3)
    hf = hf_config(family, 3)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    tcfg = ModelConfig.from_hf_config(hf)
    checkpoint.save_checkpoint(str(tmp_path),
                               checkpoint.hf_tensors(tp, tcfg), shards=2)
    ref, _ = jckpt.load_params(str(tmp_path), dtype=jnp.float32,
                               device_put=False)
    got, cfg = checkpoint.load_params(str(tmp_path), dtype=torch.float32,
                                      device="cpu")
    assert cfg.is_moe == (family == "mixtral")
    want, have, orig = _leaves(ref), _leaves(got), _leaves(tp)
    assert want.keys() == have.keys() == orig.keys()
    for name, b in want.items():
        np.testing.assert_array_equal(to_numpy(have[name]), np.asarray(b),
                                      err_msg=name)
        assert torch.equal(have[name], orig[name]), name


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_checkpoint_round_trips_leaf_for_leaf(family, tmp_path):
    check_checkpoint(family, tmp_path)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
def test_quantized_tree_matches_reference_bytes(family, mode):
    jcfg = JaxConfig.from_hf_config(hf_config(family, 3))
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(9), jcfg))
    ref = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), mode=mode)
    got = quant.quantize_params(from_jax_params(tree, "cpu"), mode=mode)
    for name, b in ref["layers"].items():
        a = got["layers"][name]
        if name in ("bq", "bk", "bv", "q_norm", "k_norm", "attn_norm",
                    "mlp_norm"):
            assert not isinstance(a, quant.QTensor), name
            np.testing.assert_array_equal(
                to_numpy(a), tree["layers"][name].view(np.uint16),
                err_msg=name)
            continue
        assert (a.bits, a.axis) == (b.bits, b.axis), name
        np.testing.assert_array_equal(to_numpy(a.q), np.asarray(b.q),
                                      err_msg=name)
        np.testing.assert_array_equal(to_numpy(a.s), np.asarray(b.s),
                                      err_msg=name)
    assert any(n in got["layers"] for n in ("bq", "q_norm"))


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                               14, 15, 16, 17, 24, 32])
def test_group_gates_take_1_to_16_and_refuse_more_by_name(G):
    # every whole G is taken: up to 16 in one launch, more in
    # ceil(G / 16) head chunks (flash.head_split); a group that is not
    # whole is refused by name
    H, K = 2 * G, 2
    flash.check_group("flash_decode", H, K)
    flash.check_paged_coverage(128, 128, H, K)
    chunks = flash.group_chunks(G)
    assert len(chunks) == -(-G // flash.MAX_GROUP)
    assert all(gc <= flash.MAX_GROUP for _, gc in chunks)
    with pytest.raises(NotImplementedError, match="G = H/K"):
        flash.check_group("flash_prefill", H + 1, K)
    with pytest.raises(ValueError, match="G = H/K"):
        flash.check_paged_coverage(128, 128, H + 1, K)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, so that the wrappers' checks run
    without a card (a shape that passes them would go on to build)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("entry", ["decode", "prefill"])
def test_wrappers_refuse_g_over_16_before_any_launch(entry, monkeypatch):
    # G 17 on a CUDA tensor goes to the kernel (split into head chunks),
    # never to the plain path: here the build is stubbed to stop there.
    # A group that is not whole is refused before any launch.
    from ome_tpu_torch.ops import _build

    class Built(Exception):
        pass

    def kernel(name):
        raise Built(name)
    monkeypatch.setattr(_build, "kernel", kernel)
    before = dict(flash.LAUNCHES)
    k = torch.zeros(1, 8, 1, 64)
    q = torch.zeros(1, 1 if entry == "decode" else 4, 17, 64)
    q = q.as_subclass(_FakeCuda)

    def call(q, k):
        if entry == "decode":
            return flash.flash_decode(q, k, k, torch.zeros(1), torch.ones(1),
                                      0.125)
        return flash.flash_prefill(q, k, k, torch.zeros(1), torch.ones(1),
                                   0.125)
    with pytest.raises(Built, match=f"flash_{entry}"):
        call(q, k)
    with pytest.raises(NotImplementedError, match="G = H/K"):
        call(q, torch.zeros(1, 8, 2, 64))
    assert flash.LAUNCHES == before
