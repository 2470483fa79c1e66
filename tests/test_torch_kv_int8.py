"""int8 KV in the port: quantization, the int8 decode kernels' plain
versions, and the int8 paged engine, against the JAX package.

* bytes: `flash.quantize_kv_block`, the quantize-on-append of
  `forward_paged` (`llama._append`) and the quantize-on-insert of the
  engine give the SAME int8 bytes and f32 scales as the JAX package on
  the same numpy input (amax with a 1e-8 floor over 127, fp32 division,
  round half to even, clip to +-127, scales S-minor). The reference is
  taken as XLA compiles it, which is how its engine runs it: under jit
  the division by the constant 127 becomes a product with f32(1/127),
  which differs from the eager division in the last bit of a few
  scales;
* numerics: `flash_decode_quantized_ref` (B5's plain version) against
  the JAX Pallas kernel `flash_decode_quantized` in interpret mode
  (atol 2e-2, tests/test_paged_kv.py's tolerance for interpreted
  kernels on this CPU build);
* the engine: greedy streams of the port's int8 paged engine equal the
  JAX int8 engine's, and every first token equals the dense engine's
  (prefill never sees the pool); the state layout and the per-row byte
  model; the flag is refused without the paged pool.
"""

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
from ome_tpu.ops import flash as jflash
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params, init_params
from ome_tpu_torch.ops import flash

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


def _slab(seed, shape, dtype):
    """Seeded values spanning several decades, rounded through `dtype`
    once so both packages see the same input."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-6, 3, shape))
    jx = jnp.asarray(x.astype(np.float32)).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == jnp.bfloat16 else
                     torch.float32)


# -- bytes -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_kv_block_bytes_equal_jax(dtype):
    jx, tx = _slab(0, (3, 40, 4, 64), dtype)
    jq, js = jax.jit(jflash.quantize_kv_block)(jx)
    tq, ts = flash.quantize_kv_block(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (3, 4, 40)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # all-zero rows take the 1e-8 floor, and no value leaves +-127
    zq, zs = flash.quantize_kv_block(torch.zeros(1, 2, 1, 8))
    assert zq.abs().max() == 0
    assert torch.all(zs == np.float32(1e-8) * np.float32(1 / 127))
    assert tq.abs().max() <= 127


def test_quantize_on_append_bytes_equal_jax():
    """forward_paged's _append writes quantize_kv_block's bytes and
    scales at (block, offset) — the JAX _append rule on the same rows."""
    B, K, D, N, bs = 5, 4, 64, 6, 32
    jx, tx = _slab(1, (B, K, D), jnp.float32)
    jq, js = jax.jit(jflash.quantize_kv_block)(jx[:, None])  # [B,1,K,D]
    pool = torch.zeros(N, bs, K, D, dtype=torch.int8)
    scale = torch.zeros(N, K, bs)
    blk = torch.tensor([3, 1, 0, 0, 5])               # two trash writes
    off = torch.tensor([0, 31, 7, 7, 16])
    llama._append(pool, scale, tx, blk, off)
    for b in (0, 1, 4):
        np.testing.assert_array_equal(pool[blk[b], off[b]].numpy(),
                                      np.asarray(jq[b, 0]))
        np.testing.assert_array_equal(scale[blk[b], :, off[b]].numpy(),
                                      np.asarray(js[b, :, 0]))
    written = {(int(b), int(o)) for b, o in zip(blk, off)}
    for b in range(N):
        for o in range(bs):
            if (b, o) not in written:
                assert pool[b, o].abs().max() == 0
                assert scale[b, :, o].abs().max() == 0


def test_quantize_on_insert_bytes_equal_jax(params):
    """The same prefilled KV slab inserted into both int8 engines lands
    as the same int8 bytes and scales in the same pool blocks."""
    jparams, tparams = params
    kw = dict(max_slots=2, prefill_buckets=[16, 32], kv_block=16,
              kv_dtype="int8")
    jeng = JaxEngine(jparams, JCFG, **kw)
    teng = InferenceEngine(tparams, TCFG, device="cpu", **kw)
    js, ts = jeng.new_state(), teng.new_state()
    L, K, D = JCFG.num_layers, JCFG.num_kv_heads, JCFG.head_dim
    (jk, tk), (jv, tv) = (_slab(s, (L, 1, 32, K, D), jnp.float32)
                          for s in (2, 3))
    js = jeng.insert(js, (jk, jv), 1, 27, 5, 32)
    ts = teng.insert(ts, (tk, tv), 1, 27, 5, 32)
    owned = teng._owned[1]
    assert owned == jeng._owned[1] and len(owned) == 2
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(ts, name)[:, owned].numpy()
        b = np.asarray(getattr(js, name))[:, owned]
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- numerics --------------------------------------------------------------


@pytest.mark.parametrize("window,softcap", [(None, None), (64, 30.0)])
def test_quantized_decode_plain_version_matches_jax_pallas(window,
                                                           softcap):
    rng = np.random.default_rng(4)
    B, S, H, K, D = 4, 256, 8, 4, 128
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, S, K, D)), jnp.float32)
    kq, ks = jflash.quantize_kv_block(k)
    vq, vs = jflash.quantize_kv_block(v)
    lens = np.asarray([1, 70, 200, 256], np.int32)
    pos = (lens - 1)[:, None]
    ref = jflash.flash_decode_quantized(
        q, kq, vq, ks, vs, jnp.asarray(pos), jnp.asarray(lens),
        sliding_window=window, logit_softcap=softcap, interpret=True)
    tq = _t(np.asarray(q.astype(jnp.float32))).to(torch.bfloat16)
    args = [tq] + [_t(a) for a in (kq, vq, ks, vs)]
    out = flash.flash_decode_quantized(*args, _t(pos), _t(lens),
                                       sliding_window=window,
                                       logit_softcap=softcap)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2)
    # on CPU tensors the wrapper is the plain version
    lo, hi = flash._decode_limits(_t(pos), _t(lens), S, window)
    plain = flash.flash_decode_quantized_ref(*args, lo, hi, D ** -0.5,
                                             softcap)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


# -- engine ----------------------------------------------------------------


def _port_run(engine, prompts, max_new):
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
    return [r.output_ids for r in reqs]


def test_int8_streams_equal_jax_first_tokens_equal_dense(params):
    """8 requests through 4 slots, 18 tokens each across the 16-token
    block boundary: the port's int8 engine gives the JAX int8 engine's
    greedy streams, and every first token equals the dense engine's."""
    jparams, tparams = params
    kw = dict(max_slots=4, prefill_buckets=[16, 32], kv_block=16,
              kv_dtype="int8")
    tok = ByteTokenizer()
    jsched = JaxScheduler(JaxEngine(jparams, JCFG, **kw))
    jreqs = [jsched.submit(JaxRequest(prompt_ids=tok.encode(p),
                                      max_new_tokens=18, temperature=0.0,
                                      stop_ids=[tok.eos_id]))
             for p in PROMPTS]
    while not all(r.done.is_set() for r in jreqs):
        jsched.step()
    eng = InferenceEngine(tparams, TCFG, device="cpu", **kw)
    out_q = _port_run(eng, PROMPTS, 18)
    assert out_q == [r.output_ids for r in jreqs]
    out_d = _port_run(InferenceEngine(tparams, TCFG, device="cpu",
                                      max_slots=4,
                                      prefill_buckets=[16, 32]),
                      PROMPTS, 18)
    assert [o[0] for o in out_q] == [o[0] for o in out_d]
    assert all(len(o) == 18 for o in out_q)
    assert eng.kv_pool_stats["kv_blocks_free"] == eng.kv_blocks - 1


def test_int8_pool_layout(params):
    """int8 pools plus two DISTINCT f32 scale planes [L, N, K, bs]; the
    model-dtype pool has none."""
    _, tparams = params
    eng = InferenceEngine(tparams, TCFG, max_slots=2, prefill_buckets=[16],
                          kv_block=16, kv_dtype="int8", device="cpu")
    st = eng.new_state()
    assert st.k.dtype == torch.int8 and st.v.dtype == torch.int8
    want = (TCFG.num_layers, eng.kv_blocks, TCFG.kv_cache_heads,
            eng.kv_block)
    for sc in (st.k_scale, st.v_scale):
        assert sc.shape == want and sc.dtype == torch.float32
    assert st.k_scale.data_ptr() != st.v_scale.data_ptr()
    plain = InferenceEngine(tparams, TCFG, max_slots=2,
                            prefill_buckets=[16], kv_block=16, device="cpu")
    stp = plain.new_state()
    assert stp.k_scale is None and stp.v_scale is None
    assert stp.k.nbytes == TCFG.dtype.itemsize * st.k.nbytes


def test_kv_row_bytes_byte_model(params):
    _, tparams = params
    eng = InferenceEngine(tparams, TCFG, max_slots=2, prefill_buckets=[16],
                          kv_block=16, kv_dtype="int8", device="cpu")
    L, K = TCFG.num_layers, TCFG.kv_cache_heads
    dkv = TCFG.kv_cache_k_dim + TCFG.kv_cache_v_dim
    assert eng.kv_row_bytes() == L * K * (dkv + 8)
    plain = InferenceEngine(tparams, TCFG, max_slots=2,
                            prefill_buckets=[16], kv_block=16, device="cpu")
    assert plain.kv_row_bytes() == L * K * dkv * 4  # fp32 test dtype
    # serving shape: bf16 model dtype, head_dim 128
    big = tiny_test().replace(dtype=torch.bfloat16, head_dim=128,
                              max_seq_len=128)
    gen = torch.Generator()
    gen.manual_seed(0)
    bparams = init_params(big, gen, "cpu")
    b16 = InferenceEngine(bparams, big, max_slots=2, prefill_buckets=[16],
                          kv_block=16, device="cpu")
    bq = InferenceEngine(bparams, big, max_slots=2, prefill_buckets=[16],
                         kv_block=16, kv_dtype="int8", device="cpu")
    assert b16.kv_row_bytes() / bq.kv_row_bytes() >= 1.9


def test_int8_refused_without_paged_pool(params):
    _, tparams = params
    with pytest.raises(ValueError, match="kv-block"):
        InferenceEngine(tparams, TCFG, max_slots=2, prefill_buckets=[16],
                        kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(tparams, TCFG, max_slots=2, prefill_buckets=[16],
                        kv_block=16, kv_dtype="fp8", device="cpu")
