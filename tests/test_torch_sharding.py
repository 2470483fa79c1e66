"""The port's tensor-parallel layout (ome_tpu_torch/parallel/) against
the JAX package's mesh and sharding rules.

* `MeshConfig.auto` factors 1-16 devices as the reference does.
* `param_specs` gives every family's tiny tree (tests/torch_family_cases
  .py) the reference's specs; Phi-3.5-MoE and gpt-oss, whose leaves the
  rules do not all name, are refused naming the leaf the reference's
  KeyError names.
* Rank r's slice of every leaf, plain, int8 and int4 `QTensor`, equals
  the shard the reference's `NamedSharding` puts on CPU device r of its
  tp=2 mesh (the 8-device CPU mesh of tests/conftest.py).
* The port's own loaders make the same slices without the whole tree:
  `init_params(shard=...)`, the checkpoint loader (mapped reads) and
  `merge_lora(shard=...)` equal `shard_params` of the whole.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu.parallel import mesh as jmesh
from ome_tpu.parallel import sharding as jsharding
from ome_tpu_torch.models import checkpoint
from ome_tpu_torch.models.config import ModelConfig, tiny_test
from ome_tpu_torch.models.lora import merge_lora
from ome_tpu_torch.models.params import (from_jax_params, init_params,
                                         to_numpy)
from ome_tpu_torch.models.quant import QTensor
from ome_tpu_torch.parallel import mesh, sharding
from tests import torch_family_cases as fc

REFUSED = ("phimoe", "gptoss")


def test_mesh_auto_equals_reference():
    for n in range(1, 17):
        for layers in (0, 3, 4, 32):
            for want_pp in (True, False):
                got = mesh.MeshConfig.auto(n, layers, want_pp)
                ref = jmesh.MeshConfig.auto(n, layers, want_pp)
                assert (got.dp, got.pp, got.tp, got.size) == \
                    (ref.dp, ref.pp, ref.tp, ref.size), (n, layers, want_pp)
    assert mesh.AXES == jmesh.AXES


def test_rank_devices_and_backend():
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")
    assert mesh.choose_backend("cpu") == "gloo"
    assert mesh.choose_backend("cuda") == "nccl"     # a card per rank
    # a named card is a pod's own unless the caller knows it is shared
    assert mesh.choose_backend("cuda:0") == "nccl"
    assert mesh.choose_backend("cuda:0", shared_card=True) == "gloo"
    info = mesh.describe(2, 1, 1, "cpu")
    assert (info.tp, info.rank, info.local_rank, info.backend) == \
        (2, 1, 1, "gloo") and not info.is_leader
    assert mesh.describe(2, 1, 1, "cpu", backend="nccl").backend == "nccl"
    with pytest.raises(ValueError, match="outside a group"):
        mesh.describe(2, 2, 0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.rank_device("cuda", 0)


def _family_tree(family):
    hf = fc.hf_config(family)
    jcfg = JaxConfig.from_hf_config(hf).replace(dtype=jnp.float32)
    return fc.seeded_tree(jcfg, 3)


def _structure(tree):
    """The keys of a tree, leaves replaced by None (param_specs reads
    names only)."""
    return {k: _structure(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


@pytest.mark.parametrize("family", sorted(fc.FAMILIES))
def test_param_specs_cover_the_families(family):
    # the port's init makes every leaf of the family's checkpoint (the
    # seeded JAX tree of tests/torch_family_cases.py has the same names)
    cfg = ModelConfig.from_hf_config(fc.hf_config(family)).replace(
        dtype=torch.float32)
    port_tree = init_params(cfg, torch.Generator(), "cpu")
    tree = _structure(port_tree)
    if family in REFUSED:
        with pytest.raises(KeyError) as jerr:
            jsharding.param_specs(tree)
        with pytest.raises(sharding.UnshardableLeaf) as perr:
            sharding.param_specs(port_tree)
        assert perr.value.leaf.split(".")[-1] == jerr.value.args[0]
        assert perr.value.leaf.split(".")[-1] in str(perr.value)
        return
    ref = jsharding.param_specs(tree)
    got = sharding.param_specs(port_tree)
    assert set(got) == set(ref)
    for name, spec in ref.items():
        if isinstance(spec, dict):
            assert set(got[name]) == set(spec)
            for k, s in spec.items():
                assert got[name][k] == tuple(s), (name, k)
        else:
            assert got[name] == tuple(spec), name


def _bytes(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


_TREES = {}


def _tree(label):
    """The numpy JAX tree of a layout the slices are held on: tiny_test
    dense in bf16 plain, dense and MoE under int4 (whose QTensors are
    int4 for wq/wk/wv/w_gate/w_up/experts and int8 for wo, w_down,
    embed and lm_head), and an MLA family (DeepSeek-V2-Lite widths,
    fp32)."""
    if label not in _TREES:
        if label == "dsv2lite fp32":
            tree = jax.tree.map(jnp.asarray, _family_tree("dsv2lite"))
        else:
            moe = "moe" in label
            tree = jllama.init_params(jax.random.PRNGKey(0),
                                      jtiny(moe=moe))
            if label.endswith("int4"):
                tree = jquant.quantize_params(tree, mode="int4")
        _TREES[label] = tree
    return _TREES[label]


@pytest.mark.parametrize("label", ["tiny dense bf16", "tiny dense int4",
                                   "tiny moe int4", "dsv2lite fp32"])
def test_rank_slices_equal_the_reference_shards(label):
    tree = _tree(label)
    jmesh2 = jmesh.build_mesh(jmesh.MeshConfig(tp=2))
    devices = list(jmesh2.devices.flatten())
    jtree = jsharding.shard_params(tree, jmesh2)
    port = from_jax_params(jax.tree.map(np.asarray, tree), "cpu")
    slices = [sharding.shard_params(port, r, 2) for r in range(2)]

    def check(jarr, parts, name):
        for shard in jarr.addressable_shards:
            if shard.device not in devices:
                continue
            r = devices.index(shard.device)
            np.testing.assert_array_equal(
                to_numpy(parts[r]), _bytes(shard.data), err_msg=name)

    def walk(jnode, pnodes, name):
        if isinstance(jnode, dict):
            for k in jnode:
                walk(jnode[k], [p[k] for p in pnodes], f"{name}.{k}")
        elif isinstance(jnode, jquant.QTensor):
            assert all(isinstance(p, QTensor) for p in pnodes)
            check(jnode.q, [p.q for p in pnodes], name + ".q")
            check(jnode.s, [p.s for p in pnodes], name + ".s")
        else:
            check(jnode, pnodes, name)
    walk(jtree, slices, label)


CFGS = {"dense": tiny_test(), "moe": tiny_test(moe=True),
        "mla": ModelConfig.from_hf_config(fc.hf_config("dsv3"))}


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_init_params_shard_equals_the_whole_trees_slice(kind):
    cfg = CFGS[kind].replace(dtype=torch.float32)

    def draw(shard=None):
        gen = torch.Generator()
        gen.manual_seed(5)
        return init_params(cfg, gen, "cpu", shard=shard)
    whole = draw()
    for r in range(2):
        ref = sharding.shard_params(whole, r, 2)
        got = draw((r, 2))
        for name, leaf in ref.items():
            if isinstance(leaf, dict):
                assert set(got[name]) == set(leaf)
                for k, v in leaf.items():
                    assert torch.equal(got[name][k], v), (kind, name, k)
            else:
                assert torch.equal(got[name], leaf), (kind, name)


def test_refusals_name_the_leaf_and_the_dim():
    phimoe = ModelConfig.from_hf_config(fc.hf_config("phimoe")).replace(
        dtype=torch.float32)
    with pytest.raises(sharding.UnshardableLeaf, match="attn_norm_bias"):
        init_params(phimoe, torch.Generator(), "cpu", shard=(0, 2))
    with pytest.raises(ValueError, match="must divide dim 0 of parameter "
                                         "embed"):
        init_params(tiny_test().replace(dtype=torch.float32),
                    torch.Generator(), "cpu", shard=(0, 3))
    with pytest.raises(ValueError, match="must divide dim 2 of parameter "
                                         "layers.wq"):
        sharding.shard_params({"layers": {"wq": torch.zeros(1, 4, 3, 2)}},
                              0, 2)


@pytest.mark.parametrize("moe", [False, True])
def test_checkpoint_reads_the_rank_slices(tmp_path, moe):
    cfg = tiny_test(moe=moe).replace(dtype=torch.float32, num_layers=2)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = init_params(cfg, gen, "cpu")
    checkpoint.save_checkpoint(str(tmp_path),
                               checkpoint.hf_tensors(params, cfg), shards=2)
    whole = checkpoint.convert_llama(checkpoint.Checkpoint(str(tmp_path)),
                                     cfg, dtype=torch.bfloat16)
    for r in range(2):
        ref = sharding.shard_params(whole, r, 2)
        got = checkpoint.convert_llama(checkpoint.Checkpoint(str(tmp_path)),
                                       cfg, dtype=torch.bfloat16,
                                       shard=(r, 2))
        for k, v in ref["layers"].items():
            assert torch.equal(got["layers"][k], v), k
        for k in ("embed", "final_norm", "lm_head"):
            assert torch.equal(got[k], ref[k]), k


def test_merge_lora_into_rank_slices(tmp_path):
    from tests.test_torch_lora import write_adapter
    cfg = tiny_test().replace(dtype=torch.float32, num_layers=2)
    gen = torch.Generator()
    gen.manual_seed(4)
    whole = init_params(cfg, gen, "cpu")
    d = write_adapter(str(tmp_path / "a"), cfg, seed=1)
    parts = [sharding.shard_params(whole, r, 2) for r in range(2)]
    merge_lora(whole, cfg, d)
    for r in range(2):
        merge_lora(parts[r], cfg, d, shard=(r, 2))
        ref = sharding.shard_params(whole, r, 2)
        for k, v in ref["layers"].items():
            assert torch.equal(parts[r]["layers"][k], v), k


def test_stages_reshape_as_the_reference():
    tree = jllama.init_params(jax.random.PRNGKey(1), jtiny())
    port = from_jax_params(jax.tree.map(np.asarray, tree), "cpu")
    ref = jsharding.stack_to_stages(tree, 2)
    got = sharding.stack_to_stages(port, 2)
    for k, v in ref["layers"].items():
        np.testing.assert_array_equal(to_numpy(got["layers"][k]), _bytes(v))
    back = sharding.unstack_stages(got)
    for k, v in port["layers"].items():
        assert torch.equal(back["layers"][k], v)
    specs = sharding.param_specs(got, pipeline=True)
    assert specs["layers"]["wq"] == ("pp", None, None, "tp", None)
