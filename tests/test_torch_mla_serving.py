"""The MLA family's serving paths in the port, against the JAX engine,
on the CPU.

The tiny DeepSeek models of tests/torch_family_cases.py (3 layers, the
first dense), fp32, the same numpy weights in both engines:

* prefix-cache hits, on the device and swapped in from the host tier,
  give the cold prefills' streams, and the cache's counters equal the
  reference's;
* the PD wire blob of a latent cache (a zero-width v plane) is the
  reference's byte for byte in both directions and in bf16 and fp32;
  blobs cross engines into the same streams; the int8 wire, which only
  int8 paged pools ship and MLA never gets, fails on the empty v plane
  in both packages alike;
* a journaled request killed mid-decode and resumed gives the whole
  uninterrupted stream, in both packages;
* the refusals are the reference's, word for word: paged KV for MLA and
  MoE models, multi-LoRA on first_k_dense models; `--task embed`
  serves a DeepSeek model as the reference does (its `layers` block
  alone), within 1e-5 of the reference's embeddings;
* `flash.check_model_head_dim` lets an MLA model's derived head_dim
  (DeepSeek-V3's 56) through on a CUDA device without touching it, and
  refuses the same head_dim for a GQA model.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu import faults as jfaults
from ome_tpu.engine import journal as jjournal
from ome_tpu.engine import pd as jpd
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.embed import EmbeddingEngine as JaxEmbedder
from ome_tpu.engine.scheduler import Request as JaxRequest
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu_torch import faults
from ome_tpu_torch.engine import pd
from ome_tpu_torch.engine.core import (PAGED_REFUSAL, InferenceEngine,
                                       PagedKVUnsupported)
from ome_tpu_torch.engine.embed import EmbeddingEngine
from ome_tpu_torch.engine.journal import RequestJournal
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.ops import flash
from test_torch_journal import _kill_and_resume
from torch_family_cases import (BUCKETS, MAX_SEQ, SLOTS,  # noqa: F401
                                _one_thread, engines, hf_config, model,
                                prompts, streams)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _greedy(engine, prompt, steps=6):
    state = engine.new_state()
    tok, kv, n, bucket = engine.prefill(prompt)
    state = engine.insert(state, kv, 0, n, tok, bucket)
    out = [int(tok)]
    B = engine.max_slots
    for _ in range(steps):
        state, toks = engine.decode(state, np.zeros(B, np.float32),
                                    np.zeros(B, np.int32),
                                    np.ones(B, np.float32))
        out.append(int(np.asarray(toks)[0]))
    return out


def test_prefix_cache_tiers_give_cold_streams():
    jcfg, jp, tcfg, tp = model("dsv2lite")
    kw = dict(max_slots=2, max_seq=128, prefill_buckets=[16, 32, 64, 128])
    base1 = list(range(2, 40))
    base2 = list(range(100, 138))
    p1, p2 = base1 + [77, 78, 79], base1 + [90, 91, 92]
    cold = InferenceEngine(tp, tcfg, device="cpu", **kw)
    want = {tuple(p): _greedy(cold, p) for p in (base1, base2, p1, p2)}
    probe = InferenceEngine(tp, tcfg, device="cpu", prefix_cache_bytes=1
                            << 26, **kw)
    _greedy(probe, base1)
    one_block = probe.prefix_cache.bytes
    # 3 layers x 32 rows x 40 latent values x 4 bytes, no v plane
    assert one_block == 3 * 32 * 40 * 4
    # the device tier alone: the second prompt hits the first's block
    assert _greedy(probe, p1) == want[tuple(p1)]
    assert probe.prefix_cache.hits == 1
    # a one-block device tier spilling to the host, against the
    # reference's counters
    tier = dict(prefix_cache_bytes=one_block, prefix_host_bytes=1 << 26)
    jeng = JaxEngine(jp, jcfg, **tier, **kw)
    teng = InferenceEngine(tp, tcfg, device="cpu", **tier, **kw)
    names = ("bytes", "host_bytes", "hits", "misses", "host_hits",
             "host_swapins", "host_recomputes", "evictions")
    for prompt in (base1, base2, p1, None, p2):
        if prompt is None:
            for eng in (jeng, teng):
                eng.prefix_cache.drain_swapins()
            continue
        assert _greedy(teng, prompt) == want[tuple(prompt)] \
            == _greedy(jeng, prompt)
        assert ({n: getattr(teng.prefix_cache, n) for n in names}
                == {n: getattr(jeng.prefix_cache, n) for n in names})
    pc = teng.prefix_cache
    assert pc.host_swapins >= 1 and pc.hits >= 1
    assert pc.tier_conservation()[0]


def _jax_planes(k, v, dtype):
    return (np.asarray(jnp.asarray(k.float().numpy(), dtype)),
            np.asarray(jnp.asarray(v.float().numpy(), dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pd_blob_bytes_equal_both_ways(dtype):
    jcfg, jp, tcfg, tp = model("dsv3")
    teng = InferenceEngine(tp, tcfg, device="cpu", max_slots=SLOTS,
                           max_seq=MAX_SEQ, prefill_buckets=BUCKETS)
    tok, (k, v), n, b = teng.prefill(prompts()[1])
    assert tuple(v.shape) == (3, 1, 32, 1, 0)
    tdt = getattr(torch, dtype)
    k, v = k.to(tdt), v.to(tdt)
    jk, jv = _jax_planes(k, v, getattr(jnp, dtype))
    blob = pd.serialize_kv(tok, k, v, n, b)
    assert bytes(blob) == jpd.serialize_kv(tok, jk, jv, n, b)
    header = json.loads(blob[4:4 + int.from_bytes(blob[:4], "little")])
    assert header["v_shape"] == [3, 1, 32, 1, 0]
    rtok, rk, rv, rn, rb = jpd.deserialize_kv(blob)
    assert (rtok, rn, rb) == (tok, n, b)
    assert rk.tobytes() == jk.tobytes() and rv.shape == jv.shape
    ttok, tk, tv, tn, tb = pd.deserialize_kv(
        jpd.serialize_kv(tok, jk, jv, n, b))
    assert (ttok, tn, tb) == (tok, n, b)
    assert torch.equal(tk, k) and tuple(tv.shape) == tuple(v.shape)
    # the int8 wire (int8 paged pools only, which MLA is refused): the
    # empty v plane has no amax in either package
    with pytest.raises(ValueError, match="zero-size"):
        jpd.serialize_kv(tok, jk, jv, n, b, quantize=True)
    with pytest.raises(ValueError, match="zero-size"):
        pd.serialize_kv(tok, k, v, n, b, quantize=True)


def test_pd_blobs_cross_engines_into_the_same_streams():
    jcfg, jp, tcfg, tp = model("dsv3")
    jeng, teng = engines(jp, jcfg, tp, tcfg)
    prompt = prompts()[2]
    want = streams(jeng, [prompt], 8)[0]

    def decode_from(eng, blob, reader):
        tok, k, v, n, b = reader(blob)
        state = eng.insert(eng.new_state(), (k, v), 0, n, tok, b)
        out = [int(tok)]
        for _ in range(7):
            state, toks = eng.decode(state, *(a[:SLOTS] for a in (
                np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
                np.ones(SLOTS, np.float32))))
            out.append(int(np.asarray(toks)[0]))
        return out
    jblob = jpd.make_pd_prefill_handler(jeng)({"ids": prompt})
    tblob = pd.make_pd_prefill_handler(teng)({"ids": prompt})
    assert decode_from(teng, jblob, pd.deserialize_kv) == want
    assert decode_from(jeng, bytes(tblob), jpd.deserialize_kv) == want


def test_journal_kill_and_resume(tmp_path):
    jcfg, jp, tcfg, tp = model("dsv2lite")
    prompt, n = [5, 9, 2, 33, 17, 8], 12
    kw = dict(max_slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=BUCKETS)
    port = _kill_and_resume(
        lambda: InferenceEngine(tp, tcfg, device="cpu", **kw),
        RequestJournal, Scheduler, Request, faults,
        str(tmp_path / "port"), prompt, n)
    ref = _kill_and_resume(
        lambda: JaxEngine(jp, jcfg, **kw),
        jjournal.RequestJournal, JaxScheduler, JaxRequest, jfaults,
        str(tmp_path / "jax"), prompt, n)
    assert 0 < len(port[0]) < n
    want = streams(InferenceEngine(tp, tcfg, device="cpu", **kw),
                   [prompt], n)[0]
    assert port[1] == ref[1] == want


def test_refusals_are_the_references():
    jcfg, jp, tcfg, tp = model("dsv3")
    with pytest.raises(ValueError) as ref:
        JaxEngine(jp, jcfg, max_slots=2, max_seq=MAX_SEQ, kv_block=16)
    assert str(ref.value) == PAGED_REFUSAL
    with pytest.raises(PagedKVUnsupported) as got:
        InferenceEngine(tp, tcfg, max_slots=2, max_seq=MAX_SEQ,
                        device="cpu", kv_block=16)
    assert str(got.value).startswith(PAGED_REFUSAL + "; this model has MLA")
    with pytest.raises(ValueError) as ref:
        JaxEngine(jp, jcfg, max_slots=2, max_seq=MAX_SEQ, lora_slots=2)
    with pytest.raises(ValueError) as got:
        InferenceEngine(tp, tcfg, max_slots=2, max_seq=MAX_SEQ,
                        device="cpu", lora_slots=2)
    assert str(got.value) == str(ref.value) == (
        "multi-LoRA does not support first_k_dense models yet")


def test_embed_serves_deepseek_as_the_reference():
    jcfg, jp, tcfg, tp = model("dsv3")
    jcfg, tcfg = jcfg.replace(moe_impl="dense"), tcfg.replace(
        moe_impl="dense")
    ids = [prompts()[1], prompts()[0]]
    ref = JaxEmbedder(jp, jcfg, max_seq=MAX_SEQ).embed(ids)
    got = EmbeddingEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu").embed(ids)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_head_dim_predicate_lets_mla_through_on_cuda():
    cfg = ModelConfig.from_hf_config(dict(
        hf_config("dsv3"), hidden_size=7168, num_attention_heads=128,
        head_dim=None))
    assert cfg.mla and cfg.head_dim == 56
    for dev in ("cuda", torch.device("cuda"), torch.device("cuda", 0)):
        flash.check_model_head_dim(cfg, dev)   # no allocation, no raise
    gqa = cfg.replace(mla=False)
    with pytest.raises(NotImplementedError, match="head_dim 56"):
        flash.check_model_head_dim(gqa, torch.device("cuda"))
    flash.check_model_head_dim(gqa, "cpu")
