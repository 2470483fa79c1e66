"""The port's training step over pipeline stages: (dp, pp, tp) =
(1, 2, 1) in a gloo group of 2 rank processes, against the JAX
package's `make_train_step` on its (1, 2, 1) mesh of CPU devices, in
fp32 (tests/test_torch_train_mesh8.py runs (2, 2, 2)): 3 steps of
`tiny_test(moe=True)` at lr 3e-4 from identical params give losses
within 1e-5 relative, and updated params within PARAM_ATOL = lr
(tests/test_torch_train_step.py says why). The port runs one process
per stage, activations and their gradients over send/recv; the
reference rotates a stage-sharded state buffer."""

import numpy as np
import pytest
import torch

from ome_tpu_torch.models.config import tiny_test
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers
from tests import train_reference as ref


@pytest.fixture(scope="module")
def jax_ref():
    return ref.jax_run((1, 2, 1))


@pytest.mark.parametrize("mesh", [(1, 2, 1)], ids=["pp2"])
def test_stages_match_jax(jax_ref, mesh):
    cfg = tiny_test(moe=True).replace(dtype=torch.float32)
    got = tp_workers.run_group(
        workers.train_losses, cfg, mesh, jax_ref["whole"],
        jax_ref["tokens"], jax_ref["targets"], ref.STEPS,
        ref.MICROBATCHES, ref.LR, size=int(np.prod(mesh)))
    for r in got:
        assert r["losses"] == got[0]["losses"]
    np.testing.assert_allclose(got[0]["losses"], jax_ref["losses"],
                               rtol=1e-5)
    params = dict(ref.leaves(got[0]["params"]))
    for name, a in ref.leaves(jax_ref["after"]):
        np.testing.assert_allclose(params[name], a, rtol=0, atol=ref.LR,
                                   err_msg=name)
