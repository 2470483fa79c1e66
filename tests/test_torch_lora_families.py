"""Multi-LoRA greedy streams on quantized weights and a MoE model, the
port against the JAX package (fp32, CPU); the helpers are
tests/test_torch_lora.py's.

* int4 weights (`quantize_params(mode="int4")` on a kernel-eligible
  config, bridged with `from_jax_params`): base and adapter streams in
  one batch identical to `ome_tpu.engine.core.InferenceEngine`'s, the
  JAX side's int4 kernel in interpret mode (`OME_INT4_KERNEL_INTERPRET`,
  as tests/test_torch_quant_engine.py runs it); the delta is added to
  the int4 product's output;
* a Mixtral config: the stacks hold the attention targets only, an
  adapter with MLP targets is refused with the reference's message, and
  attention-only adapter streams are identical to the JAX engine's.
"""

import os
import sys

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

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_lora import (ATTN, KW, MAX_SEQ, P, _one_thread,  # noqa: E402
                             streams, write_adapter)

__all__ = ["_one_thread"]  # fixture


def test_int4_streams_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    kw = dict(hidden_size=1024, intermediate_size=1024, num_layers=1,
              num_heads=8, num_kv_heads=2, head_dim=128, max_seq_len=128)
    jcfg = jax_tiny().replace(dtype=jnp.float32, **kw)
    tcfg = tiny_test().replace(dtype=torch.float32, **kw)
    jq = jquant.quantize_params(jllama.init_params(jax.random.PRNGKey(0),
                                                   jcfg), mode="int4")
    tq = from_jax_params(jax.tree.map(np.asarray, jq), "cpu")
    ad = write_adapter(tmp_path / "a1", tcfg, 7, scale=0.05)
    ekw = dict(max_slots=2, max_seq=128, prefill_buckets=[16],
               lora_slots=1, lora_rank=4)
    je = JaxEngine(jq, jcfg, **ekw)
    te = InferenceEngine(tq, tcfg, device="cpu", **ekw)
    for e in (je, te):
        e.register_adapter("a1", ad)
    jobs = [(P, None), (P, "a1")]
    want = streams(je, jobs, steps=4)
    assert streams(te, jobs, steps=4) == want
    assert want[0] != want[1]


def test_mixtral_attention_adapters_equal_jax(tmp_path):
    jcfg = jax_tiny(moe=True).replace(dtype=jnp.float32,
                                      max_seq_len=MAX_SEQ, num_layers=2)
    tcfg = tiny_test(moe=True).replace(dtype=torch.float32,
                                       max_seq_len=MAX_SEQ, num_layers=2)
    jp = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    attn = write_adapter(tmp_path / "attn", tcfg, 9, targets=ATTN,
                         scale=0.3)
    full = write_adapter(tmp_path / "full", tcfg, 9)
    je = JaxEngine(jp, jcfg, **KW)
    te = InferenceEngine(tp, tcfg, device="cpu", **KW)
    assert sorted(k for k in te._lora if k.endswith("_a")) == sorted(
        f"{w}_lora_a" for w in ("wq", "wk", "wv", "wo"))
    for e in (je, te):
        e.register_adapter("a1", attn)
    with pytest.raises(ValueError) as got:
        te.register_adapter("a2", full)
    with pytest.raises(ValueError) as want:
        je.register_adapter("a2", full)
    assert str(got.value) == str(want.value)
    jobs = [(P, None), (P, "a1")]
    want = streams(je, jobs, steps=6)
    assert streams(te, jobs, steps=6) == want
    assert want[0] != want[1]
