"""GPipe pipeline parallelism of the port (ome_tpu_torch/parallel/
pipeline.py) against the dense forward and the JAX package's
`pipeline_forward`, in fp32 on the CPU.

* `pipeline_forward` over stage-stacked params in one process (M + pp -
  1 ticks) gives the dense forward's logits and the JAX
  `pipeline_forward`'s (mesh=None) within 2e-4, for Llama, the MoE and
  Gemma 2's block (alternating windows through the layer-pair body,
  GeGLU, post-block norms, softcaps, scaled embeddings).
* The reference's three refusals, in its words and exception types.
* One process per stage (pp = 2, a gloo pair, `StageSchedule`): the
  last stage's logits equal the dense forward's, and the loss and every
  parameter's gradient equal autograd through the one-process
  pipeline's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu.parallel import pipeline as jpipeline
from ome_tpu.parallel import sharding as jsharding
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.parallel import pipeline, sharding
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers

ATOL = 2e-4

GEMMA2 = dict(alt_sliding_window=True, sliding_window=8,
              mlp_activation="gelu_tanh", post_block_norms=True,
              embed_scale=True, unit_offset_norm=True,
              attn_logit_softcap=50.0, final_logit_softcap=30.0,
              query_scale=16 ** -0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(moe=False, **kw):
    jcfg = jtiny(moe=moe).replace(dtype=jnp.float32, **kw)
    tcfg = tiny_test(moe=moe).replace(dtype=torch.float32, **kw)
    whole = jax.tree.map(np.asarray,
                         jllama.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, whole


@pytest.mark.parametrize("family,moe,kw,shape,M", [
    ("llama", False, {}, (4, 16), 2),
    ("moe", True, {}, (4, 8), 4),
    ("gemma2", False, GEMMA2, (4, 16), 2)])
def test_pipeline_matches_dense_and_jax(family, moe, kw, shape, M):
    jcfg, tcfg, whole = _models(moe, **kw)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, shape).astype(np.int32)
    params = from_jax_params(whole, "cpu")
    with torch.no_grad():
        dense, _ = llama.forward(params, tcfg, torch.from_numpy(tokens))
        got = pipeline.pipeline_forward(sharding.stack_to_stages(params, 2),
                                        tcfg, torch.from_numpy(tokens), 2, M)
    want = jpipeline.pipeline_forward(
        jsharding.stack_to_stages(jax.tree.map(jnp.asarray, whole), 2),
        jcfg, jnp.asarray(tokens), pp=2, num_microbatches=M)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_refusals_in_the_reference_words():
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    jtokens = jnp.zeros((2, 8), jnp.int32)
    cases = [
        (dict(moe=True, first_k_dense=1), 2, NotImplementedError,
         "first_k_dense"),
        (dict(alt_sliding_window=True, sliding_pattern=4, num_layers=4), 2,
         NotImplementedError, "P=2 alternating pattern"),
        (dict(alt_sliding_window=True, rope_skip_global=True), 2,
         NotImplementedError, "P=2 alternating pattern"),
        (dict(alt_sliding_window=True, num_layers=4), 4, ValueError,
         "even layer count"),
    ]
    for kw, pp, exc, words in cases:
        moe = kw.pop("moe", False)
        tcfg = tiny_test(moe=moe).replace(**kw)
        jcfg = jtiny(moe=moe).replace(**kw)
        with pytest.raises(exc, match=words) as got:
            pipeline.pipeline_forward({}, tcfg, tokens, pp, 2)
        with pytest.raises(exc, match=words) as want:
            jpipeline.pipeline_forward({}, jcfg, jtokens, pp=pp,
                                       num_microbatches=2)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
def test_stage_per_rank_matches_one_process(tied):
    _, tcfg, whole = _models()
    if tied:
        tcfg = tcfg.replace(tie_word_embeddings=True)
        whole = {k: v for k, v in whole.items() if k != "lm_head"}
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (4, 16)).astype(np.int32)
    M = 2
    got = tp_workers.run_group(workers.stage_logits_and_grads, tcfg, whole,
                               tokens, M, size=2)
    params = from_jax_params(whole, "cpu")
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        dense, _ = llama.forward(params, tcfg, tok)
    np.testing.assert_allclose(got[1]["logits"], dense.numpy(), atol=ATOL,
                               rtol=ATOL)
    assert [g["stage_layers"] for g in got] == [tcfg.num_layers // 2] * 2
    # the one-process pipeline's loss and gradients, sliced by stage
    staged = {k: (v.requires_grad_() if not isinstance(v, dict) else
                  {n: t.requires_grad_() for n, t in v.items()})
              for k, v in sharding.stack_to_stages(params, 2).items()}
    loss = pipeline.pipeline_loss_fn(staged, tcfg, tok, tok, 2, M)
    loss.backward()
    np.testing.assert_allclose(got[1]["loss"], float(loss.detach()), rtol=1e-6)
    for stage, g in enumerate(got):
        for path, grad in g["grads"].items():
            block, _, name = path.rpartition(".")
            want = staged[block][name].grad[stage] if block else \
                staged[name].grad
            if name == "embed" and tied:
                continue  # each stage holds a part: summed below
            np.testing.assert_allclose(grad, want.numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{stage} {path}")
    if tied:
        np.testing.assert_allclose(
            got[0]["grads"]["embed"] + got[1]["grads"]["embed"],
            staged["embed"].grad.numpy(), atol=1e-6, rtol=1e-5)
