"""Paged KV in the port: ops/paged.py, forward_paged, the paged engine.

The same numpy inputs (seeded) go through the JAX package and the port
on the CPU:

* attention: the port's `paged_attention_xla` against the JAX one
  (atol 1e-5), and the kernel's plain version `flash_paged_decode_ref`
  against the Pallas kernel `paged_flash_decode` in interpret mode, as
  tests/test_paged_kv.py runs it (atol 2e-2, that test's tolerance: the
  CPU build's default f32 matmul inside the interpreted kernel is
  reduced-precision);
* the model: `forward_paged` logits against JAX `forward_paged` on the
  same params, pool and table (atol 2e-4);
* the engine: greedy streams of the paged engine equal the port's dense
  engine's and the JAX paged engine's (8 requests through 4 slots,
  across 16-token block boundaries); the capacity, pool-pressure and
  impossible-request cases of tests/test_paged_kv.py; the host block
  allocator's state after the same insert / decode / free script equals
  the JAX engine's, forced preemption included;
* serving: `--kv-block 16 --device cpu` answers over HTTP with the pool
  gauges on /metrics, and the CUDA kernel's coverage check refuses what
  the kernel does not take.

On a CUDA tensor every paged entry launches the kernel or raises; that
is checked without a card through a tensor that reports `is_cuda`.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.scheduler import Request as JaxRequest
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu.ops import paged as jpaged
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine, PagedKVUnsupported
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.ops import flash, paged

JCFG = jax_tiny().replace(dtype=jnp.float32, max_seq_len=128)
TCFG = tiny_test().replace(dtype=torch.float32, max_seq_len=128)
PROMPTS = ["hello world", "a", "the quick brown fox jumps over",
           "xyzzy plugh abc", "short", "another prompt here",
           "yet more text", "z"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams),
                                    "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool(rng, B, H, K, D, bs, M, N):
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kp = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, K, D)).astype(np.float32)
    table = rng.permutation(N)[:B * M].reshape(B, M).astype(np.int32)
    return q, kp, vp, table


def _quantize_pool(pool):
    """tests/test_kv_int8.py's reference quantizer: amax/127 per (row,
    head), scales S-minor [N, K, bs]."""
    x = np.asarray(pool, np.float32)
    sc = np.maximum(np.abs(x).max(axis=-1), 1e-8) / 127.0
    q = np.clip(np.rint(x / sc[..., None]), -127, 127).astype(np.int8)
    return q, np.ascontiguousarray(np.swapaxes(sc, 1, 2))


# -- attention -------------------------------------------------------------


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_paged_attention_xla_matches_jax(pool_dtype):
    rng = np.random.default_rng(0)
    B, H, K, D, bs, M, N = 4, 8, 4, 64, 16, 4, 20
    q, kp, vp, table = _pool(rng, B, H, K, D, bs, M, N)
    kv_len = np.asarray([0, 5, 33, 64], np.int32)
    if pool_dtype == "bf16":
        jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        tk = _t(np.asarray(jk.astype(jnp.float32))).to(torch.bfloat16)
        tv = _t(np.asarray(jv.astype(jnp.float32))).to(torch.bfloat16)
        jks = jvs = tks = tvs = None
    else:
        (kq, ks), (vq, vs) = _quantize_pool(kp), _quantize_pool(vp)
        jk, jv, jks, jvs = map(jnp.asarray, (kq, vq, ks, vs))
        tk, tv, tks, tvs = map(_t, (kq, vq, ks, vs))
    ref = jpaged.paged_attention_xla(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(kv_len),
        logit_softcap=20.0, k_scale=jks, v_scale=jvs)
    out = paged.paged_attention(_t(q), tk, tv, _t(table), _t(kv_len),
                                logit_softcap=20.0, k_scale=tks,
                                v_scale=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_kernel_plain_version_matches_jax_pallas(pool_dtype):
    rng = np.random.default_rng(1)
    B, H, K, D, bs, M, N = 4, 16, 8, 128, 128, 4, 32
    q, kp, vp, table = _pool(rng, B, H, K, D, bs, M, N)
    kv_len = np.asarray([1, 100, 256, 512], np.int32)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    if pool_dtype == "bf16":
        jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        tk = _t(np.asarray(jk.astype(jnp.float32))).to(torch.bfloat16)
        tv = _t(np.asarray(jv.astype(jnp.float32))).to(torch.bfloat16)
        jks = jvs = tks = tvs = None
    else:
        (kq, ks), (vq, vs) = _quantize_pool(kp), _quantize_pool(vp)
        jk, jv, jks, jvs = map(jnp.asarray, (kq, vq, ks, vs))
        tk, tv, tks, tvs = map(_t, (kq, vq, ks, vs))
    ref = jpaged.paged_flash_decode(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray(kv_len), k_scale=jks,
                                    v_scale=jvs, interpret=True)
    hi = _t(kv_len)
    out = paged.flash_paged_decode_ref(tq, tk, tv, _t(table),
                                       torch.zeros_like(hi), hi, D ** -0.5,
                                       k_scale=tks, v_scale=tvs)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2)
    # the wrapper takes the plain version on CPU tensors
    wrapped = paged.paged_flash_decode(tq, tk, tv, _t(table), hi,
                                       k_scale=tks, v_scale=tvs)
    torch.testing.assert_close(wrapped, out, atol=0, rtol=0)


def test_plain_version_trash_slot_and_empty_window_stay_finite():
    # a free engine slot: all-trash table row, length past M * bs
    rng = np.random.default_rng(2)
    q, kp, vp, table = _pool(rng, 2, 8, 4, 64, 32, 2, 8)
    table[1] = 0
    out = paged.paged_flash_decode(_t(q), _t(kp), _t(vp), _t(table),
                                   torch.tensor([0, 500]))
    assert torch.isfinite(out).all()
    assert out[0].abs().max() == 0  # empty window gives 0, not NaN


def test_cuda_tensors_never_take_the_plain_path():
    # on a CUDA tensor the paged entries launch the kernel or raise; a
    # shape the kernel does not take raises before anything is built.
    # Checked with a tensor subclass that reports is_cuda (no card).
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    rng = np.random.default_rng(3)
    q, kp, vp, table = _pool(rng, 2, 8, 4, 16, 16, 2, 8)
    q = _t(q).as_subclass(FakeCuda)
    kv_len = torch.tensor([3, 20])
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_attention(q, _t(kp), _t(vp), _t(table), kv_len)
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_flash_decode(q, _t(kp), _t(vp), _t(table), kv_len)
    kq, ks = flash.quantize_kv_block(_t(kp))
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_decode_quantized(q, kq, kq, ks, ks,
                                     torch.tensor([[2], [9]]))
    assert flash.LAUNCHES["flash_paged_decode"] == 0
    assert flash.LAUNCHES["flash_decode_quantized"] == 0


def test_cuda_coverage_check():
    flash.check_paged_coverage(128, 128, 32, 8)   # Llama-3-8B, bs 128
    flash.check_paged_coverage(32, 64, 8, 8)
    flash.check_paged_coverage(128, 128, 24, 8)   # G 3: Llama-3.2-3B
    flash.check_paged_coverage(128, 128, 28, 4)   # G 7: Qwen2.5-7B
    flash.check_paged_coverage(128, 128, 34, 2)   # G 17: two head chunks
    flash.check_paged_coverage(128, 128, 32, 1)   # G 32 (MQA)
    flash.check_paged_coverage(64, 96, 32, 32)    # Phi-3-mini, bs 64
    flash.check_paged_coverage(128, 256, 16, 8)   # Gemma-2-9B heads
    for bad in ((48, 128, 32, 8), (0, 128, 32, 8), (128, 80, 32, 8),
                (128, 16, 8, 4), (128, 128, 33, 2), (128, 128, 1, 2)):
        with pytest.raises(ValueError, match="kv_block"):
            flash.check_paged_coverage(*bad)


# -- model -----------------------------------------------------------------


def _paged_caches(rng, dtype, B=3, bs=16, M=8, N=30):
    cfg = JCFG
    L, K, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    table = table.astype(np.int32)
    index = np.asarray([5, 40, 100], np.int32)
    ks = vs = None
    if dtype == "int8":
        qk = [_quantize_pool(kp[i]) for i in range(L)]
        qv = [_quantize_pool(vp[i]) for i in range(L)]
        kp = np.stack([a for a, _ in qk])
        vp = np.stack([a for a, _ in qv])
        ks = np.stack([s for _, s in qk])
        vs = np.stack([s for _, s in qv])
    jc = jllama.PagedKVCache(
        k=jnp.asarray(kp), v=jnp.asarray(vp), index=jnp.asarray(index),
        table=jnp.asarray(table),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    tc = llama.PagedKVCache(
        k=_t(kp), v=_t(vp), index=_t(index), table=_t(table),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    return jc, tc


@pytest.mark.parametrize("pool_dtype", ["fp32", "int8"])
def test_forward_paged_logits_match_jax(params, pool_dtype):
    jparams, tparams = params
    rng = np.random.default_rng(4)
    jc, tc = _paged_caches(rng, pool_dtype)
    tokens = rng.integers(3, 500, (3, 1)).astype(np.int32)
    jlogits, jnew = jllama.forward_paged(jparams, JCFG,
                                         jnp.asarray(tokens), jc)
    tlogits, tnew = llama.forward_paged(tparams, TCFG, _t(tokens), tc)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=2e-4)
    np.testing.assert_array_equal(tnew.index.numpy(),
                                  np.asarray(jnew.index))
    # the appended rows land where the reference's do: same pool
    # bytes outside the three written rows, and close values inside
    blk = np.asarray(jc.table)[np.arange(3), np.asarray(jc.index) // 16]
    off = np.asarray(jc.index) % 16
    for tpool, jpool in ((tnew.k, jnew.k), (tnew.v, jnew.v)):
        a, b = tpool.numpy().copy(), np.asarray(jpool).copy()
        if pool_dtype == "fp32":
            np.testing.assert_allclose(a[:, blk, off], b[:, blk, off],
                                       atol=1e-4)
        else:
            assert np.abs(a[:, blk, off].astype(np.int32)
                          - b[:, blk, off]).max() <= 1
        a[:, blk, off] = 0
        b[:, blk, off] = 0
        np.testing.assert_array_equal(a, b)


def test_forward_paged_refuses_multi_token_steps(params):
    """Multi-token steps (the speculative verify's S = k+1 rows) are
    served now, through the plain `paged_attention_multi`: their logits
    and lengths equal the JAX forward_paged's on the same pool."""
    jparams, tparams = params
    rng = np.random.default_rng(5)
    jc, tc = _paged_caches(rng, "fp32")
    tokens = rng.integers(3, 500, (3, 3)).astype(np.int32)
    jlogits, jnew = jllama.forward_paged(jparams, JCFG,
                                         jnp.asarray(tokens), jc)
    tlogits, tnew = llama.forward_paged(tparams, TCFG, _t(tokens), tc)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=2e-4)
    np.testing.assert_array_equal(tnew.index.numpy(),
                                  np.asarray(jnew.index))


# -- engine and scheduler --------------------------------------------------


def _port_run(engine, prompts, max_new=24):
    tok = ByteTokenizer()
    sched = Scheduler(engine)
    reqs = [sched.submit(Request(prompt_ids=tok.encode(p),
                                 max_new_tokens=max_new, temperature=0.0,
                                 stop_ids=[tok.eos_id]))
            for p in prompts]
    for _ in range(5000):
        if all(r.done.is_set() for r in reqs):
            break
        sched.step()
    assert all(r.done.is_set() for r in reqs)
    sched.stop()
    return [r.output_ids for r in reqs], sched


def _jax_run(engine, prompts, max_new=24):
    tok = ByteTokenizer()
    sched = JaxScheduler(engine)
    reqs = [sched.submit(JaxRequest(prompt_ids=tok.encode(p),
                                    max_new_tokens=max_new,
                                    temperature=0.0,
                                    stop_ids=[tok.eos_id]))
            for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        sched.step()
    return [r.output_ids for r in reqs]


def _port(tparams, **kw):
    kw.setdefault("prefill_buckets", [16, 32])
    return InferenceEngine(tparams, TCFG, device="cpu", **kw)


def test_paged_streams_equal_dense_and_jax_paged(params):
    """Greedy tokens identical: the port's paged engine, its dense
    engine and the JAX paged engine, incl. slot reuse (8 requests
    through 4 slots) and growth across 16-token block boundaries."""
    jparams, tparams = params
    out_d, _ = _port_run(_port(tparams, max_slots=4), PROMPTS)
    eng = _port(tparams, max_slots=4, kv_block=16)
    out_p, _ = _port_run(eng, PROMPTS)
    out_j = _jax_run(JaxEngine(jparams, JCFG, max_slots=4,
                               prefill_buckets=[16, 32], kv_block=16),
                     PROMPTS)
    assert out_p == out_d
    assert out_p == out_j
    assert eng.kv_pool_stats["kv_blocks_free"] == eng.kv_blocks - 1
    assert eng.kv_conservation() == (True, 0)


def test_double_slots_same_memory_budget(params):
    """Dense 4 slots x 128 rows = 512 cache rows; a paged pool with the
    same 512-row budget serves 8 slots of mixed-length sequences."""
    _, tparams = params
    rows_budget = 4 * TCFG.max_seq_len
    eng = _port(tparams, max_slots=8, kv_block=16,
                kv_blocks=rows_budget // 16 + 1)
    k_bytes = eng.new_state().k.nbytes
    dense_bytes = _port(tparams, max_slots=4).new_state().k.nbytes
    assert k_bytes <= dense_bytes + eng.kv_block * 16 * 1024
    out, _ = _port_run(eng, PROMPTS, max_new=20)
    assert all(len(o) == 20 for o in out)


def test_pool_pressure_preempts_and_recovers(params):
    """An undersized pool is a normal condition: requests are requeued
    or preempted with their progress carried as prompt, and all
    finish."""
    _, tparams = params
    eng = _port(tparams, max_slots=4, prefill_buckets=[16], kv_block=16,
                kv_blocks=5)
    tok = ByteTokenizer()
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt_ids=tok.encode(p)[:16],
                                 max_new_tokens=25, temperature=0.0,
                                 stop_ids=[tok.eos_id]))
            for p in PROMPTS[:4]]
    for _ in range(2000):
        if all(r.done.is_set() for r in reqs):
            break
        sched.step()
    assert all(r.done.is_set() for r in reqs)
    for r in reqs:
        if r.finish_reason == "stop":
            assert r.output_ids[-1] == tok.eos_id
            assert len(r.output_ids) <= 25
        else:
            assert r.finish_reason == "length"
            assert len(r.output_ids) == 25, len(r.output_ids)
    assert sched.stats["preemptions_total"] > 0
    # counted once per request held back, not once per admission retry
    assert 0 < sched.stats["kv_requeues_total"] <= len(reqs)
    assert sum(r.pool_requeued for r in reqs) == \
        sched.stats["kv_requeues_total"]
    assert eng.kv_pool_stats["kv_blocks_free"] == eng.kv_blocks - 1
    assert eng.kv_conservation() == (True, 0)
    sched.stop()


def test_impossible_request_rejected_upfront(params):
    _, tparams = params
    eng = _port(tparams, max_slots=2, prefill_buckets=[16], kv_block=16,
                kv_blocks=3)  # 2 usable blocks = 32 rows
    tok = ByteTokenizer()
    sched = Scheduler(eng)
    req = sched.submit(Request(prompt_ids=tok.encode("hi"),
                               max_new_tokens=100, temperature=0.0,
                               stop_ids=[tok.eos_id]))
    for _ in range(50):
        if req.done.is_set():
            break
        sched.step()
    assert req.done.is_set() and req.finish_reason == "error"
    sched.stop()


def test_paged_rejects_unsupported_models(params):
    _, tparams = params
    # alternating sliding/global windows (gemma2-style) stay dense; one
    # model-wide window is served paged (test_torch_headdim.py)
    with pytest.raises(PagedKVUnsupported, match="paged KV"):
        InferenceEngine(tparams, TCFG.replace(sliding_window=8,
                                              alt_sliding_window=True),
                        max_slots=2, kv_block=16, device="cpu")


def _alloc_state(eng):
    return (eng._table.tolist(), [list(o) for o in eng._owned],
            list(eng._free_blocks), eng._host_len.tolist(),
            list(eng._preempted))


def test_allocator_state_equals_jax_engine(params, monkeypatch):
    """The same insert / decode / free script on both engines leaves the
    same block table, owned lists, free list, host lengths and
    preemptions, across block growth, pool pressure (a victim is
    preempted) and the explicit self-preemption corner."""
    jparams, tparams = params
    kw = dict(max_slots=3, prefill_buckets=[16, 32], kv_block=16,
              kv_blocks=8)
    engines = [JaxEngine(jparams, JCFG, **kw), _port(tparams, **kw)]
    states = [e.new_state() for e in engines]
    rng = np.random.default_rng(6)
    L, K, D = JCFG.num_layers, JCFG.num_kv_heads, JCFG.head_dim
    greedy = (np.zeros(3, np.float32), np.zeros(3, np.int32),
              np.ones(3, np.float32))

    def insert(slot, true_len, bucket):
        kv = rng.standard_normal((2, L, 1, bucket, K, D)).astype(np.float32)
        for i, eng in enumerate(engines):
            arr = jnp.asarray if i == 0 else _t
            states[i] = eng.insert(states[i], (arr(kv[0]), arr(kv[1])),
                                   slot, true_len, 7, bucket)

    def decode(n):
        for _ in range(n):
            for i, eng in enumerate(engines):
                states[i], _ = eng.decode(states[i], *greedy)

    def same(where):
        a, b = (_alloc_state(e) for e in engines)
        assert a == b, where
        assert [e.kv_conservation() for e in engines] == \
            [engines[0].kv_conservation()] * 2, where

    insert(0, 20, 32)
    insert(1, 5, 16)
    same("after inserts")
    decode(14)                      # slot 0 grows into its third block
    same("after growth")
    for eng in engines:
        eng.free_slot(1)
    insert(2, 30, 32)
    insert(1, 31, 32)
    same("after reuse")
    decode(20)                      # the 7-block pool runs dry: preempt
    same("under pressure")
    jpre, tpre = (e.take_preempted() for e in engines)
    assert tpre == jpre and tpre, (tpre, jpre)
    # the self-preemption corner (tests/test_paged_kv.py:219): the pool
    # is empty and no victim is evictable
    insert(0, 40, 32)
    for eng in engines:
        eng._free_blocks.clear()
        monkeypatch.setattr(eng, "_preempt_victim", lambda: False)
        eng._host_len[0] = 48       # slot 0's next write needs a block
        eng._grow_blocks()
    same("after forced preemption")
    jpre, tpre = (e.take_preempted() for e in engines)
    assert tpre == jpre and 0 in tpre, (tpre, jpre)


# -- serving ---------------------------------------------------------------

TINY = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 10000.0}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_serve_paged_on_cpu(tmp_path, kv_dtype):
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    server, sched, engine = serve.build_server(
        ["--model-dir", str(tmp_path), "--random-weights", "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "128", "--dtype", "float32", "--kv-block", "16",
         "--kv-blocks", "9", "--kv-dtype", kv_dtype,
         "--debug-endpoints"])
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert engine.kv_block == 16 and engine.kv_blocks == 9
        assert engine.kv_quantized == (kv_dtype == "int8")
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps({"prompt": "paged port", "max_tokens": 20,
                             "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
        assert 1 <= doc["usage"]["completion_tokens"] <= 20
        for _ in range(200):
            if sched.drain_idle():
                break
            time.sleep(0.01)
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        # block 0, the trash block, is never free: utilization 1/9 idle
        for gauge, value in (("ome_engine_kv_blocks_free", 8),
                             ("ome_engine_kv_block_utilization_ratio",
                              1 / 9),
                             ("ome_engine_kv_blocks_owned", 0),
                             ("ome_engine_kv_conservation_ok", 1)):
            line = next(ln for ln in text.splitlines()
                        if ln.startswith(gauge + " "))
            assert float(line.split()[1]) == value, line
        with urllib.request.urlopen(url + "/debug/state", timeout=10) as r:
            state = json.loads(r.read())
        assert state["kv_pool"] == {"kv_blocks": 9, "kv_blocks_free": 8,
                                    "kv_block_tokens": 16}
    finally:
        server.stop()


def test_serve_paged_refusals(tmp_path, capsys):
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    base = ["--model-dir", str(tmp_path), "--random-weights", "--device",
            "cpu", "--port", "0"]
    with pytest.raises(SystemExit) as e:
        serve.build_server(base + ["--kv-dtype", "int8"])
    assert "--kv-dtype" in str(e.value.code) and "--kv-block" in \
        str(e.value.code)
    with pytest.raises(SystemExit) as e:
        serve.build_server(base + ["--kv-block", "-16"])
    assert "--kv-block" in str(e.value.code)


def test_serve_names_kv_block_only_for_paged_guards(tmp_path, monkeypatch):
    """A refusal of the paged guards exits naming --kv-block; any other
    engine error keeps its own type instead of pointing at that flag."""
    from ome_tpu_torch.engine import core
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    base = ["--model-dir", str(tmp_path), "--random-weights", "--device",
            "cpu", "--port", "0"]

    def refusing(error):
        def engine(*a, **kw):
            raise error
        return engine
    monkeypatch.setattr(core, "InferenceEngine", refusing(
        PagedKVUnsupported("paged KV supports standard models")))
    with pytest.raises(SystemExit) as e:
        serve.build_server(base + ["--kv-block", "16"])
    assert str(e.value.code).startswith("--kv-block 16: paged KV")
    monkeypatch.setattr(core, "InferenceEngine",
                        refusing(ValueError("unrelated")))
    with pytest.raises(ValueError, match="unrelated"):
        serve.build_server(base)
    with pytest.raises(ValueError, match="unrelated"):
        serve.build_server(base + ["--kv-block", "16"])
