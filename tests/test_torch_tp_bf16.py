"""bf16 logits at tp=2: the port's gap from tp=1 is no larger than the
reference's.

The same tiny weights (the port's seeded fp32 init, cast to bfloat16 by
each package: both round to nearest even) run one whole-prompt forward
— the step that samples a stream's first token — at tp=1 and at tp=2,
in bf16, in both packages: the port's ranks are a spawned gloo group
(tests/torch_tp_workers.py), the reference's tp=2 is its
ShardedInferenceEngine's sharded params through its forward on a
two-device slice of the CPU mesh. The first token's logits of tp=2 may
differ from tp=1's (two bf16 partial sums where tp=1 has one); the
port's largest gap must not exceed the reference's by more than one
bf16 ulp of the largest logit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ome_tpu.engine.sharded import ShardedInferenceEngine as JaxSharded
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params, init_params
from tests import torch_tp_workers as workers

PROMPT = [[5, 17, 200, 33, 8, 91, 140, 7, 12, 300, 41, 66, 9, 250, 3, 77]]


def _tree(cfg, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    tree = init_params(cfg, gen, "cpu")
    return {k: {kk: vv.numpy() for kk, vv in v.items()}
            if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def test_tp2_bf16_logit_gap_no_larger_than_reference():
    tree = _tree(tiny_test().replace(dtype=torch.float32), seed=11)
    toks = np.asarray(PROMPT, np.int32)
    cfg = tiny_test().replace(dtype=torch.bfloat16)

    # the port: tp=2 ranks, and tp=1 in this process
    ranks = workers.run_group(workers.bf16_last_logits, tree, cfg, toks)
    params = {k: {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(torch.bfloat16)
              for k, v in from_jax_params(tree, "cpu").items()}
    with torch.no_grad():
        one, _ = llama.forward(params, cfg, torch.from_numpy(toks))
    one = one[:, -1].float().numpy()
    np.testing.assert_array_equal(ranks[0], ranks[1])
    port_gap = float(np.abs(ranks[0] - one).max())

    # the reference: tp=1 forward, and its tp=2 engine's sharded params
    jcfg = jtiny().replace(dtype=jnp.bfloat16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    fwd = jax.jit(lambda p, t: jllama.forward(p, jcfg, t))
    jone = np.asarray(fwd(jparams, toks)[0][:, -1], np.float32)
    eng = JaxSharded(jparams, jcfg, tp=2, max_slots=1, max_seq=64)
    jtwo = np.asarray(fwd(eng.params, toks)[0][:, -1], np.float32)
    ref_gap = float(np.abs(jtwo - jone).max())

    ulp = _bf16_ulp(float(np.abs(one).max()))
    print(f"first-step bf16 logit gap tp=2 vs tp=1: port {port_gap:.6g}, "
          f"reference {ref_gap:.6g}, one ulp of max |logit| {ulp:.6g}")
    assert np.isfinite(one).all() and np.isfinite(jone).all()
    assert port_gap <= ref_gap + ulp
