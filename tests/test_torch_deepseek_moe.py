"""DeepSeek's MoE in the port, against the JAX package, on the CPU.

* `_route`'s DeepSeek flavors: softmax_v2 (DeepSeek-V2: a softmax over
  every expert; group-limited greedy where 1 < n_group and
  0 < topk_group < n_group; routed_scaling_factor skipped when it
  normalizes) and sigmoid_v3 (DeepSeek-V3, Kimi-K2: sigmoid scores, the
  fp32 selection bias used to choose only, groups scored by the sum of
  their best two), with and without groups, bias, norm_topk_prob and
  scaling, tied scores included: expert ids equal the reference's,
  weights within 1e-6;
* the shared experts under int8 and int4 weights in an fp32 model: the
  reference calls its dense MLP there without the model config, so the
  weights dequantize to bf16 and an int4 product (B4's plain version;
  the JAX side runs its kernel in interpret mode) leaves as bf16; the
  port's `_shared_mlp` gives the same dtypes and values, and `moe_mlp`
  (routed plus shared) equals the reference's on both MoE impls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params
from torch_family_cases import _one_thread  # noqa: F401

E, K, D = 16, 4, 16
ROUTES = {
    # DeepSeek-V2-Lite: plain greedy, no normalization
    "v2lite": dict(router_scoring="softmax_v2", routed_scaling_factor=1.0),
    # DeepSeek-V2: group-limited greedy, scaled
    "v2_groups": dict(router_scoring="softmax_v2", n_group=4, topk_group=2,
                      routed_scaling_factor=1.5),
    # normalized softmax_v2: the scaling factor is skipped
    "v2_norm": dict(router_scoring="softmax_v2", n_group=4, topk_group=2,
                    norm_topk_prob=True, routed_scaling_factor=2.0),
    # as many groups picked as there are: no group limit
    "v2_all_groups": dict(router_scoring="softmax_v2", n_group=4,
                          topk_group=4, routed_scaling_factor=1.0),
    # DeepSeek-V3: sigmoid, bias, top-2-sum groups, normalized, scaled
    "v3": dict(router_scoring="sigmoid_v3", router_bias=True, n_group=4,
               topk_group=2, norm_topk_prob=True,
               routed_scaling_factor=2.5),
    # Kimi-K2: one group
    "kimi": dict(router_scoring="sigmoid_v3", router_bias=True, n_group=1,
                 topk_group=1, norm_topk_prob=True,
                 routed_scaling_factor=2.827),
    # sigmoid_v3 without the bias leaf, not normalized
    "v3_nobias": dict(router_scoring="sigmoid_v3", n_group=4, topk_group=1,
                      routed_scaling_factor=1.0),
}


def _cfgs(**kw):
    base = dict(num_experts=E, experts_per_token=K, hidden_size=D, **kw)
    return (JaxConfig(dtype=jnp.float32, **base),
            ModelConfig(dtype=torch.float32, **base))


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_matches_the_reference(name):
    kw = ROUTES[name]
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    x[0, :3] = 0.0  # every logit 0: the scores tie everywhere
    router = rng.standard_normal((D, E)).astype(np.float32)
    router[:, 9] = router[:, 1]  # a tied pair across two groups
    p = {"router": router}
    if kw.get("router_bias"):
        bias = (0.05 * rng.standard_normal(E)).astype(np.float32)
        bias[9] = bias[1]
        p["router_bias"] = bias
    jw, jidx = jllama._route(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                             jcfg)
    tw, tidx = llama._route(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    assert tw.dtype == torch.float32
    if kw.get("n_group", 0) > 1 and kw["topk_group"] < kw["n_group"]:
        # every pick lies in one of the topk_group chosen groups
        groups = tidx // (E // kw["n_group"])
        per_row = [len(set(g.tolist())) for g in groups.reshape(-1, K)]
        assert max(per_row) <= kw["topk_group"]


# int8: fp32 products of bf16-rounded weights; int4: a bf16 chain (B4's
# bf16 out, SiLU, the product, the int8 down projection) rounded at
# other points by XLA than by torch, a few bf16 ulps of the ~0.02 outputs
ATOL = {"int8": 2e-6, "int4": 5e-4}
# shapes B4's dispatch rule takes: K 256 in two groups of 128, N 128
SHARED = dict(hidden_size=256, intermediate_size=256, num_layers=1,
              num_heads=4, num_kv_heads=4, head_dim=64, vocab_size=64,
              num_experts=4, experts_per_token=2, moe_intermediate_size=128,
              num_shared_experts=1, router_scoring="softmax_v2",
              routed_scaling_factor=1.0)


@pytest.fixture(scope="module")
def shared_trees():
    jcfg = JaxConfig(dtype=jnp.float32, **SHARED)
    tree = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    out = {}
    for mode in ("int8", "int4"):
        jq = jquant.quantize_params(tree, mode=mode)
        jl = jax.tree.map(lambda a: a[0], jq["layers"])
        tl = {k: v[0] for k, v in from_jax_params(
            jax.tree.map(np.asarray, jq), "cpu")["layers"].items()}
        out[mode] = (jl, tl)
    return out


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_shared_experts_keep_the_reference_dtypes(shared_trees, mode,
                                                  monkeypatch):
    monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    jl, tl = shared_trees[mode]
    assert isinstance(tl["ws_gate"], llama.QTensor)
    assert tl["ws_gate"].bits == (4 if mode == "int4" else 8)
    assert llama.int4_eligible((3, 256), tl["ws_gate"]) == (mode == "int4")
    x = np.random.default_rng(2).standard_normal((1, 3, 256)).astype(
        np.float32)
    shared = {"w_gate": jl["ws_gate"], "w_up": jl["ws_up"],
              "w_down": jl["ws_down"]}
    ref = jllama.dense_mlp(jnp.asarray(x), shared)
    got = llama._shared_mlp(torch.from_numpy(x), tl)
    # int8: bf16 weights promoted against fp32 x; int4: B4's bf16 out
    assert str(got.dtype)[6:] == np.asarray(ref).dtype.name == (
        "bfloat16" if mode == "int4" else "float32")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=ATOL[mode], rtol=1e-5)


@pytest.mark.parametrize("impl", ["ragged", "dense"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_moe_with_shared_experts_matches(shared_trees, mode, impl,
                                         monkeypatch):
    monkeypatch.setenv("OME_INT4_KERNEL_INTERPRET", "1")
    jl, tl = shared_trees[mode]
    jcfg = JaxConfig(dtype=jnp.float32, moe_impl=impl, **SHARED)
    tcfg = ModelConfig(dtype=torch.float32, moe_impl=impl, **SHARED)
    x = np.random.default_rng(5).standard_normal((2, 3, 256)).astype(
        np.float32)
    ref = jllama.moe_mlp(jnp.asarray(x), jl, jcfg)
    got = llama.moe_mlp(torch.from_numpy(x), tl, tcfg)
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL[mode], rtol=1e-5)
