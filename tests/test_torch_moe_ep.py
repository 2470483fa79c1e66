"""Expert-parallel ragged MoE of the port (ome_tpu_torch/parallel/
moe.py) in gloo groups of ep = 2 and 4 rank processes: each rank's
output over its E/ep experts, after the one sum over the group, equals
the dense all-experts MoE (the port's `moe_mlp_dense`) and the JAX
package's `moe_mlp_ragged_ep` on its ep-device mesh within 1e-5 (the
reference's own tolerance, tests/test_moe_ep.py), from the same
params and input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu.parallel.mesh import MeshConfig, build_mesh
from ome_tpu.parallel.moe import moe_mlp_ragged_ep as jax_ep
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.parallel.moe import moe_mlp_ragged_ep
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers


@pytest.fixture(scope="module")
def layer():
    jcfg = jtiny(moe=True).replace(dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    lp = jax.tree.map(lambda a: np.array(a[0]), params["layers"])
    x = np.random.default_rng(1).standard_normal(
        (2, 8, jcfg.hidden_size)).astype(np.float32)
    return jcfg, lp, x


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_matches_dense_and_jax(layer, ep):
    jcfg, lp, x = layer
    cfg = tiny_test(moe=True).replace(dtype=torch.float32)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    with torch.no_grad():
        dense = llama.moe_mlp_dense(torch.from_numpy(x), tlp, cfg).numpy()
    mesh = build_mesh(MeshConfig(tp=ep), jax.devices()[:ep])
    want = np.asarray(jax.jit(lambda x, lp: jax_ep(x, lp, jcfg, mesh))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, lp)))
    got = tp_workers.run_group(workers.ep_moe, cfg, lp, x, size=ep)
    for r, out in enumerate(got):
        np.testing.assert_allclose(out, dense, atol=1e-5,
                                   err_msg=f"ep={ep} rank {r} vs dense")
        np.testing.assert_allclose(out, want, atol=1e-5,
                                   err_msg=f"ep={ep} rank {r} vs JAX")


def test_one_rank_is_the_ragged_dispatch(layer):
    _, lp, x = layer
    cfg = tiny_test(moe=True).replace(dtype=torch.float32)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(moe_mlp_ragged_ep(xt, tlp, cfg).numpy(),
                               llama.moe_mlp_ragged(xt, tlp, cfg).numpy(),
                               atol=1e-6)
