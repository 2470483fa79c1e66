"""Group sizes above 16 (MQA-style) in the port, on the CPU.

One kernel launch folds at most 16 query heads of a KV head
(`flash.MAX_GROUP`); for G = H/K > 16 the CUDA wrappers split the query
heads into ceil(G / 16) chunks (`flash.head_split`) and launch the
kernel once per chunk. Here, with the kernels' plain versions as the
launch function:

* the split equals the unsplit plain version within 1e-6 for G 17, 24,
  32, 33 and 64 — dense decode (B1), causal prefill from a base (B2) and
  paged decode over a bf16 and an int8 pool (B3) — and calls the launch
  once per chunk, each with at most 16 heads per KV head;
* the group gates take those G;
* a tiny Llama at H 32, K 1 (G 32) gives greedy streams identical to
  the JAX engine's, dense and paged (fp32; on the CPU the engine runs
  the plain versions, so this holds the model path, not the split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.ops import flash, paged

GROUPS = (17, 24, 32, 33, 64)
D = 16
SLOTS, MAX_SEQ = 3, 64
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _split(launch, q, K, sinks=None):
    """head_split with `launch(qc, sc)`, recording each chunk's head
    count."""
    heads = []

    def counted(qc, sc):
        assert qc.is_contiguous()
        assert (sc is None) == (sinks is None)
        assert sc is None or sc.shape == (qc.shape[2],)
        heads.append(qc.shape[2])
        return launch(qc, sc)
    out = flash.head_split(counted, q, K, sinks)
    return out, heads


def _check(out, want, heads, G, K):
    chunks = flash.group_chunks(G)
    assert len(heads) == len(chunks) == -(-G // flash.MAX_GROUP)
    assert all(h <= K * flash.MAX_GROUP for h in heads)
    assert sum(heads) == K * G
    assert max(heads) - min(heads) <= K  # chunk sizes differ by <= 1
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("G", GROUPS)
def test_split_decode_equals_unsplit(G):
    rng = np.random.default_rng(G)
    B, S, K = 3, 40, 2
    q, k, v = _t(rng, B, 1, K * G, D), _t(rng, B, S, K, D), _t(rng, B, S,
                                                                 K, D)
    lo, hi = torch.tensor([0, 5, 0]), torch.tensor([40, 23, 0])
    want = flash.flash_decode_ref(q, k, v, lo, hi, 0.25, 30.0)
    out, heads = _split(
        lambda qc, _: flash.flash_decode_ref(qc, k, v, lo, hi, 0.25, 30.0),
        q, K)
    _check(out, want, heads, G, K)


@pytest.mark.parametrize("G", GROUPS)
def test_split_with_sinks_equals_unsplit(G):
    # each chunk gets the sinks of its own heads (gpt-oss's sink logits
    # ride through the G > 16 split of B1 and B2)
    rng = np.random.default_rng(300 + G)
    B, S, Sq, K = 2, 30, 5, 2
    k, v = _t(rng, B, S, K, D), _t(rng, B, S, K, D)
    sinks = _t(rng, K * G) * 2.0
    lo, hi = torch.tensor([0, 7]), torch.tensor([30, 19])
    q = _t(rng, B, 1, K * G, D)
    want = flash.flash_decode_ref(q, k, v, lo, hi, 0.25, None, sinks)
    out, heads = _split(
        lambda qc, sc: flash.flash_decode_ref(qc, k, v, lo, hi, 0.25, None,
                                              sc), q, K, sinks)
    _check(out, want, heads, G, K)
    base, kv_hi = torch.tensor([0, 11]), torch.tensor([5, 16])
    q = _t(rng, B, Sq, K * G, D)
    want = flash.flash_prefill_ref(q, k, v, base, kv_hi, 0.25, None, 4,
                                   sinks)
    out, heads = _split(
        lambda qc, sc: flash.flash_prefill_ref(qc, k, v, base, kv_hi, 0.25,
                                               None, 4, sc), q, K, sinks)
    _check(out, want, heads, G, K)


@pytest.mark.parametrize("G", GROUPS)
def test_split_prefill_equals_unsplit(G):
    rng = np.random.default_rng(100 + G)
    B, Sq, S, K = 2, 6, 24, 1
    q, k, v = _t(rng, B, Sq, K * G, D), _t(rng, B, S, K, D), _t(rng, B, S,
                                                                  K, D)
    base, kv_hi = torch.tensor([0, 9]), torch.tensor([6, 15])
    want = flash.flash_prefill_ref(q, k, v, base, kv_hi, 0.25, None, 4)
    out, heads = _split(
        lambda qc, _: flash.flash_prefill_ref(qc, k, v, base, kv_hi, 0.25,
                                              None, 4), q, K)
    _check(out, want, heads, G, K)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("G", GROUPS)
def test_split_paged_decode_equals_unsplit(G, pool):
    rng = np.random.default_rng(200 + G)
    B, K, bs, M, N = 3, 2, 8, 4, 14
    q = _t(rng, B, 1, K * G, D)
    kp, vp = _t(rng, N, bs, K, D), _t(rng, N, bs, K, D)
    if pool == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        ks = vs = None
    else:
        kp, ks = flash.quantize_kv_block(kp)
        vp, vs = flash.quantize_kv_block(vp)
    table = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * M]
                             .reshape(B, M).astype(np.int32))
    lo, hi = torch.zeros(B, dtype=torch.int32), torch.tensor([1, 17, 32])

    def plain(qc, _=None):
        return paged.flash_paged_decode_ref(qc, kp, vp, table, lo, hi, 0.25,
                                            k_scale=ks, v_scale=vs)
    out, heads = _split(plain, q, K)
    _check(out, plain(q), heads, G, K)


@pytest.mark.parametrize("G", GROUPS)
def test_gates_take_every_group_above_16(G):
    for K in (1, 2, 8):
        flash.check_group("flash_decode", K * G, K)
        flash.check_group("flash_prefill", K * G, K)
        flash.check_paged_coverage(128, 128, K * G, K)


def test_group_chunks_are_balanced():
    assert flash.group_chunks(16) == [(0, 16)]
    assert flash.group_chunks(17) == [(0, 9), (9, 8)]
    assert flash.group_chunks(33) == [(0, 11), (11, 11), (22, 11)]
    assert flash.group_chunks(64) == [(0, 16), (16, 16), (32, 16),
                                      (48, 16)]


HF_MQA = {"architectures": ["LlamaForCausalLM"], "vocab_size": 256,
          "hidden_size": 64, "num_hidden_layers": 2,
          "num_attention_heads": 32, "num_key_value_heads": 1,
          "head_dim": 16, "intermediate_size": 96,
          "max_position_embeddings": 128, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-6, "tie_word_embeddings": False}


def _streams(eng, prompts, steps):
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


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_g32_streams_match_jax_engine(cache):
    jcfg = JaxConfig.from_hf_config(HF_MQA).replace(dtype=jnp.float32)
    tcfg = ModelConfig.from_hf_config(HF_MQA).replace(dtype=torch.float32)
    assert tcfg.num_heads // tcfg.num_kv_heads == 32
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.PRNGKey(3), jcfg))
    kw = dict(kv_block=16, kv_blocks=20) if cache == "paged" else {}
    jeng = JaxEngine(jax.tree.map(jnp.asarray, tree), jcfg,
                     max_slots=SLOTS, max_seq=MAX_SEQ, **kw)
    teng = InferenceEngine(from_jax_params(tree, "cpu"), tcfg,
                           max_slots=SLOTS, max_seq=MAX_SEQ, device="cpu",
                           **kw)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(3, 256, n))) for n in (5, 17, 30)]
    assert _streams(teng, prompts, 12) == _streams(jeng, prompts, 12)
    if cache == "paged":
        for slot in range(SLOTS):
            teng.free_slot(slot)
        assert teng.kv_conservation()[0]
