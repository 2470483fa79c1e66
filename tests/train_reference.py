"""The JAX package's training step as the yardstick of the port's
training tests: `jax_run` trains `tiny_test(moe=True)` in fp32 from
PRNGKey(0) on a JAX mesh and returns the whole initial tree, the losses
and the whole updated tree as numpy, with the batch it used."""

import jax
import jax.numpy as jnp
import numpy as np

from ome_tpu.compat import set_mesh
from ome_tpu.models.config import tiny_test
from ome_tpu.parallel import sharding
from ome_tpu.parallel.mesh import MeshConfig, build_mesh
from ome_tpu.train import step as ts

STEPS = 3
LR = 3e-4
MICROBATCHES = 2
BATCH, SEQ = 8, 16


def batch(seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32))


def jax_run(mesh=(1, 1, 1), steps=STEPS, lr=LR, **cfg_kw):
    cfg = tiny_test(moe=True).replace(dtype=jnp.float32, **cfg_kw)
    mc = MeshConfig(*mesh)
    jmesh = build_mesh(mc, jax.devices()[:mc.size])
    step, init_state = ts.make_train_step(cfg, jmesh, mc, MICROBATCHES,
                                          lr=lr)
    tokens, targets = batch()
    with set_mesh(jmesh):
        params, opt = init_state(jax.random.PRNGKey(0))
        whole = jax.tree.map(np.asarray, sharding.unstack_stages(params))
        sh = ts.data_sharding(jmesh)
        tok, tgt = jax.device_put((tokens, targets), sh)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, tok, tgt)
            losses.append(float(loss))
        after = jax.tree.map(np.asarray, sharding.unstack_stages(params))
    return {"whole": whole, "losses": losses, "after": after,
            "tokens": tokens, "targets": targets}


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)
