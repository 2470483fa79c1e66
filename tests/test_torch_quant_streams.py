"""Greedy streams of the port's int8-quantized engine against the JAX
engine on the same quantized tree (`ome_tpu.models.quant.
quantize_params` of the JAX init of `tiny_test()` in fp32, bridged with
`from_jax_params`): identical with the dense cache and with a paged pool
whose 16-row blocks the 20-step streams cross. The int4 streams and the
quantized logits are in tests/test_torch_quant_engine.py.
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
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

JCFG = jax_tiny().replace(dtype=jnp.float32, max_seq_len=128)
TCFG = tiny_test().replace(dtype=torch.float32, max_seq_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def int8_params():
    jq = jquant.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), JCFG), mode="int8")
    return jq, from_jax_params(jax.tree.map(np.asarray, jq), "cpu")


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


@pytest.mark.parametrize("kv_block", [0, 16], ids=["dense", "paged"])
def test_int8_streams_equal_jax(int8_params, kv_block):
    jq, tq = int8_params
    kw = dict(max_slots=3, max_seq=128, prefill_buckets=[16, 32],
              kv_block=kv_block)
    prompts = [_prompt(20, 5), _prompt(21, 14), _prompt(22, 30)]
    ref = _streams(JaxEngine(jq, JCFG, **kw), prompts, 20)
    got = _streams(InferenceEngine(tq, TCFG, device="cpu", **kw), prompts,
                   20)
    assert got == ref
