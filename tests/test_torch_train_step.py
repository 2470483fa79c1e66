"""The port's training step (ome_tpu_torch/train/step.py) against the
JAX package's `make_train_step`, in fp32 on the CPU.

From identical params (the JAX init bridged with `from_jax_params`) and
one numpy batch, 3 steps of `tiny_test(moe=True)` at lr 3e-4 give
losses within 1e-5 relative of the JAX step's, at (dp, pp, tp) =
(1, 1, 1) in one process and (2, 1, 1), (1, 1, 2) in gloo groups
(tests/test_torch_train_mesh.py runs (1, 2, 1) and (2, 2, 2)). The
updated params agree within PARAM_ATOL = lr: AdamW divides each
gradient by its own running rms, so an element whose gradient sits at
fp32's rounding noise moves by up to lr a step in either direction in
either package. Also: AdamW against optax's on one tree, the
reference's "loss drops sharply on constant targets" at lr 1e-2, and
the refusals (quantized leaves, LoRA stacks, a mesh without a group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params, init_params
from ome_tpu_torch.models.quant import quantize_params
from ome_tpu_torch.parallel.mesh import MeshConfig
from ome_tpu_torch.train import step as ts
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers
from tests import train_reference as ref

LOSS_RTOL = 1e-5
PARAM_ATOL = ref.LR


@pytest.fixture(scope="module")
def jax_ref():
    return ref.jax_run((1, 1, 1))


def _cfg():
    return tiny_test(moe=True).replace(dtype=torch.float32)


def _check(got_losses, got_params, want):
    np.testing.assert_allclose(got_losses, want["losses"], rtol=LOSS_RTOL)
    got = dict(ref.leaves(got_params))
    for name, a in ref.leaves(want["after"]):
        np.testing.assert_allclose(got[name], a, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


def test_one_process_matches_jax(jax_ref):
    torch.set_num_threads(1)
    step, init_state = ts.make_train_step(_cfg(), MeshConfig(),
                                          ref.MICROBATCHES, lr=ref.LR,
                                          device="cpu")
    params, opt = init_state(from_jax_params(jax_ref["whole"], "cpu"))
    losses = []
    for _ in range(ref.STEPS):
        params, opt, loss = step(params, opt, jax_ref["tokens"],
                                 jax_ref["targets"])
        losses.append(float(loss))
    whole, _ = step.whole(params, opt)
    _check(losses, workers._tree_np(whole), jax_ref)
    assert int(opt["count"]) == ref.STEPS


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 1, 2)],
                         ids=["dp2", "tp2"])
def test_group_matches_jax(jax_ref, mesh):
    got = tp_workers.run_group(
        workers.train_losses, _cfg(), mesh, jax_ref["whole"],
        jax_ref["tokens"], jax_ref["targets"], ref.STEPS,
        ref.MICROBATCHES, ref.LR, size=int(np.prod(mesh)))
    for r in got:
        assert r["losses"] == got[0]["losses"]  # one loss on every rank
    _check(got[0]["losses"], got[0]["params"], jax_ref)


def test_adamw_matches_optax():
    rng = np.random.default_rng(3)
    p = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), p) for _ in range(3)]
    opt = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.01)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = opt.init(jp)
    tp = {"a": torch.from_numpy(p["a"].copy()),
          "b": {"c": torch.from_numpy(p["b"]["c"].copy())}}
    topt = ts.make_optimizer(1e-2)
    tstate = topt.init(tp)
    for g in grads:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, {"a": torch.from_numpy(g["a"]),
                         "b": {"c": torch.from_numpy(g["b"]["c"])}}, tstate)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp["b"]["c"].numpy(),
                               np.asarray(jp["b"]["c"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tstate["mu"]["a"].numpy(),
                               np.asarray(js[0].mu["a"]), rtol=1e-6)
    assert tstate["mu"]["a"].dtype == torch.float32


def test_loss_drops_sharply_on_constant_targets():
    """The reference's sharded check (tests/test_parallel.py:146-166) in
    one process: tiny_test(moe=True) in its bf16, lr 1e-2, 4
    microbatches, targets all 7."""
    torch.set_num_threads(1)
    cfg = tiny_test(moe=True)
    step, init_state = ts.make_train_step(cfg, MeshConfig(), 4, lr=1e-2,
                                          device="cpu")
    params, opt = init_state(seed=0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 16))
    targets = np.full_like(tokens, 7)
    losses = []
    for _ in range(6):
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 1.0, losses


def test_refusals():
    cfg = tiny_test().replace(dtype=torch.float32)
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step, init_state = ts.make_train_step(cfg, MeshConfig(), 1,
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="quantized"):
        init_state(quantize_params(whole, mode="int8"))
    lora = dict(whole, layers=dict(
        whole["layers"], wq_lora_a=torch.zeros(cfg.num_layers, 2, 4, 8)))
    with pytest.raises(NotImplementedError, match="LoRA adapter stack"):
        init_state(lora)
    with pytest.raises(ValueError, match="needs a group of 2 ranks"):
        ts.make_train_step(cfg, MeshConfig(tp=2), 1, device="cpu")
