"""The MLA family through the port's engine, against the JAX engine, on
the CPU: the streams.

The tiny DeepSeek models of tests/torch_family_cases.py (3 layers, the
first dense; V2-Lite, V3 and Kimi-K2 shapes), fp32 unless named, the
same numpy weights in both engines: greedy streams equal the JAX
engine's through single decode steps (the absorbed path over the latent
cache), in fp32, bf16, and under int8 and int4 weights (the JAX side's
int4 kernel in interpret mode); a `decode_multi` chunk and a `verify`
step (the materialized path over the cache) equal the reference's
tokens, counts and lengths.

The prefix cache, PD, the journal and the refusals:
tests/test_torch_mla_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import quant as jquant
from ome_tpu_torch.models.params import from_jax_params
from torch_family_cases import (_one_thread,  # noqa: F401
                                check_decode_multi_and_verify,
                                check_streams, engines, model, prompts,
                                streams)


@pytest.mark.parametrize("family", ["dsv2lite", "dsv3", "kimik2"])
def test_streams_equal_jax(family):
    check_streams(family)


@pytest.mark.parametrize("family", ["dsv2lite", "dsv3"])
def test_decode_multi_and_verify_equal_jax(family):
    check_decode_multi_and_verify(family)


def _bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == jnp.float32 and a.ndim > 1 else a,
                        tree)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_streams_equal_jax_in_bf16_and_quantized(mode, monkeypatch):
    monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    jcfg, jp, tcfg, _ = model("dsv3")
    if mode == "bf16":
        jcfg, tcfg = jcfg.replace(dtype=jnp.bfloat16), tcfg.replace(
            dtype=torch.bfloat16)
        jq = _bf16(jp)
    else:
        jq = jquant.quantize_params(jp, mode=mode)
    tq = from_jax_params(jax.tree.map(np.asarray, jq), "cpu")
    jeng, teng = engines(jq, jcfg, tq, tcfg)
    assert streams(teng, prompts(), 10) == streams(jeng, prompts(), 10)
