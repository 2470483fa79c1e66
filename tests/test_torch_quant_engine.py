"""Logits and greedy streams of the port on quantized weights, against
the JAX package on the same quantized tree (`ome_tpu.models.quant.
quantize_params`, bridged with `from_jax_params`), in fp32 on the CPU.

* logits: the port's `forward` (a prefill into a dense cache, then a
  decode step at per-slot lengths) and `forward_paged` against the JAX forward,
  for int8, int4 and fp8 on a kernel-eligible config (hidden 1024, FFN
  1024, head_dim 128, GQA 8/2, 2 layers). For int4 the JAX side runs its
  kernel branch in interpret mode (`OME_INT4_KERNEL_INTERPRET`, set for
  the JAX side only), whose bf16 rounding the port's plain path
  reproduces; without it the reference's CPU path dequantizes in fp32.
  Tolerances: int8 and fp8 2e-4 (the fp32 logits standard of
  tests/test_torch_llama.py). int4 5e-3: the int4 product rounds its
  input x to bf16, so an fp32 difference of one ulp upstream can move an
  element of x across a bf16 rounding boundary, a 2^-8 relative step of
  that element (the JAX forward itself moves by 2.6e-4 when one norm
  weight is scaled by 1 + 2^-22); the single projection is held to 1e-5
  of max |y| in tests/test_torch_int4_matmul.py;
* greedy streams: the port's InferenceEngine and the JAX one give
  identical int4 streams (the eligible config, dense cache, the JAX
  kernel branch in interpret mode); the int8 streams are in
  tests/test_torch_quant_streams.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

MODES = ("int8", "int4", "fp8")
ATOL = {"int8": 2e-4, "fp8": 2e-4, "int4": 5e-3}
KW = dict(hidden_size=1024, intermediate_size=1024, num_layers=2,
          num_heads=8, num_kv_heads=2, head_dim=128, max_seq_len=128)
JCFG = jax_tiny().replace(dtype=jnp.float32, **KW)
TCFG = tiny_test().replace(dtype=torch.float32, **KW)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quantized(cfg, modes):
    """mode -> (the JAX quantized tree, the port's bridge of it)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), cfg)
    out = {}
    for mode in modes:
        jq = jquant.quantize_params(jp, mode=mode)
        out[mode] = (jq, from_jax_params(jax.tree.map(np.asarray, jq),
                                         "cpu"))
    return out


@pytest.fixture(scope="module")
def quantized():
    return _quantized(JCFG, MODES)


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged(rng, B=3, bs=16, M=8, N=30):
    L, K, D = JCFG.num_layers, JCFG.num_kv_heads, JCFG.head_dim
    kp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    vp = rng.standard_normal((L, N, bs, K, D)).astype(np.float32)
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    table = table.astype(np.int32)
    index = np.asarray([5, 40, 100], np.int32)
    jc = jllama.PagedKVCache(k=jnp.asarray(kp), v=jnp.asarray(vp),
                             index=jnp.asarray(index),
                             table=jnp.asarray(table))
    tc = llama.PagedKVCache(k=_t(kp), v=_t(vp), index=_t(index),
                            table=_t(table))
    return jc, tc


@pytest.mark.parametrize("mode", MODES)
def test_logits_equal_jax(quantized, mode, monkeypatch):
    if mode == "int4":
        monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    jq, tq = quantized[mode]
    atol = ATOL[mode]
    rng = np.random.default_rng(1)
    toks = rng.integers(3, JCFG.vocab_size, (2, 12)).astype(np.int32)
    # prefill into a dense cache, then decode one step at per-slot
    # lengths
    jc = jllama.KVCache.create(JCFG, 2, 64)
    tc = llama.KVCache.create(TCFG, 2, 64, device="cpu")
    ref, jc = jllama.forward(jq, JCFG, jnp.asarray(toks), cache=jc)
    out, tc = llama.forward(tq, TCFG, _t(toks), cache=tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)
    lengths = np.asarray([12, 7], np.int32)
    jc = jllama.KVCache(k=jc.k, v=jc.v, index=jnp.asarray(lengths))
    tc = llama.KVCache(k=tc.k, v=tc.v, index=_t(lengths))
    step = np.asarray(ref)[:, -1].argmax(-1).astype(np.int32)[:, None]
    ref, _ = jllama.forward(jq, JCFG, jnp.asarray(step), cache=jc)
    out, _ = llama.forward(tq, TCFG, _t(step), cache=tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)
    # one paged decode step over random pools
    jpc, tpc = _paged(rng)
    step = rng.integers(3, JCFG.vocab_size, (3, 1)).astype(np.int32)
    ref, _ = jllama.forward_paged(jq, JCFG, jnp.asarray(step), jpc)
    out, _ = llama.forward_paged(tq, TCFG, _t(step), tpc)
    assert out.dtype == torch.float32 and out.shape == (3, 1,
                                                        JCFG.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def _streams(eng, prompts, steps):
    """Greedy streams of `prompts` admitted into slots 0.. of a fresh
    state, then `steps` decode steps of every slot."""
    n = eng.max_slots
    greedy = (np.zeros(n, np.float32), np.zeros(n, np.int32),
              np.ones(n, np.float32))
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, true_len, bucket = eng.prefill(ids, 0.0, 0, 1.0)
        state = eng.insert(state, kv, slot, true_len, tok, bucket)
        out.append([int(tok)])
    for _ in range(steps):
        state, toks = eng.decode(state, *greedy)
        toks = np.asarray(toks)
        for slot in range(len(prompts)):
            out[slot].append(int(toks[slot]))
    return out


def _prompt(seed, n):
    return [int(t) for t in
            np.random.default_rng(seed).integers(3, 512, n)]


def test_int4_streams_equal_jax(quantized, monkeypatch):
    monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    jq, tq = quantized["int4"]
    kw = dict(max_slots=2, max_seq=128, prefill_buckets=[16, 32])
    prompts = [_prompt(30, 5), _prompt(31, 15)]
    ref = _streams(JaxEngine(jq, JCFG, **kw), prompts, 12)
    got = _streams(InferenceEngine(tq, TCFG, device="cpu", **kw), prompts,
                   12)
    assert got == ref
