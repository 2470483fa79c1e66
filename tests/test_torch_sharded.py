"""Tensor-parallel serving (ome_tpu_torch/engine/sharded.py) against the
JAX package's ShardedInferenceEngine.

The port's ranks are processes: each test's group is two spawned gloo
CPU processes (tests/torch_tp_workers.py), run once for the module; the
JAX engine runs tp=2 on the 8-device CPU mesh of tests/conftest.py.

* tp=2 greedy fp32 streams equal the JAX ShardedInferenceEngine(tp=2)'s
  and the port's tp=1 engine's, with the prompts of
  tests/test_sharded_engine.py; every rank emits the same streams.
* tiny_test(moe=True) logits (experts split over the ranks) are within
  1e-5 of the JAX forward's.
* An MLA family (DeepSeek-V2-Lite widths: heads split, the latent cache
  whole on each rank) gives the JAX tp=2 engine's streams.
* At temperature 0.8 with top-k and top-p, both ranks emit the same
  tokens (every rank takes rank 0's sampled ids).
* A rank quantizing its own slices (scales of a split contraction taken
  over the group) gets its slices of the whole tree's quantization.
* Gemma 2, command-r (with per-head q/k norms) and Cohere2 at tp=2
  give the port's tp=1 streams.
* The KV cache of a tp=4 engine holds K/4 heads per rank; the
  divisibility errors are the reference's.
* int4 weights at tp=2: each rank sends its column slices of w_gate
  and w_up through B4's wrapper, and the streams equal the port's tp=1
  int4 engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.sharded import ShardedInferenceEngine as JaxSharded
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
from ome_tpu_torch.models.config import ModelConfig, tiny_test
from ome_tpu_torch.models.params import (from_jax_params, init_params,
                                         to_numpy)
from ome_tpu_torch.parallel import comm
from ome_tpu_torch.parallel.sharding import shard_params
from tests import torch_family_cases as fc
from tests import torch_tp_workers as workers

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17]]
STEPS = 12
SAMPLED = (np.full(4, 0.8, np.float32), np.full(4, 20, np.int32),
           np.full(4, 0.9, np.float32))


def _jax_greedy(engine, prompts, steps):
    state = engine.new_state()
    outs = []
    for slot, prompt in enumerate(prompts):
        tok, kv, true_len, bucket = engine.prefill(prompt)
        state = engine.insert(state, kv, slot, true_len, tok, bucket)
        outs.append([int(tok)])
    B = engine.max_slots
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int32),
              np.ones(B, np.float32))
    for _ in range(steps - 1):
        state, toks = engine.decode(state, *greedy)
        toks = np.asarray(toks)
        for slot in range(len(prompts)):
            outs[slot].append(int(toks[slot]))
    return outs


FAMILIES = ("gemma2", "cohere", "cohere_qk", "cohere2")
# int4 at tp=2: K 256 holds two 128-row groups, so w_gate / w_up's rank
# slices (N 256) are shapes B4 takes (`int4_eligible`)
INT4_SEED = 5


def _int4_cfg():
    return tiny_test().replace(dtype=torch.float32, hidden_size=256,
                               intermediate_size=512)


def _family_cfg(family):
    return ModelConfig.from_hf_config(fc.hf_config(family)).replace(
        dtype=torch.float32)


def _suite(group, dense, moe, mla, mla_cfg, mla_prompts, families):
    """Every rank-side check of this module, in one group."""
    kw = dict(max_slots=4, max_seq=64)
    fkw = dict(max_slots=fc.SLOTS, max_seq=fc.MAX_SEQ,
               prefill_buckets=fc.BUCKETS)
    cfg = tiny_test().replace(dtype=torch.float32)
    mcfg = tiny_test(moe=True).replace(dtype=torch.float32)
    toks = np.arange(1, 9, dtype=np.int32)[None]
    return {
        "dense": workers.engine_streams(group, dense, cfg, PROMPTS, STEPS,
                                        kw),
        "sampled": workers.engine_streams(group, dense, cfg, PROMPTS, 8,
                                          kw, sampling=SAMPLED),
        "moe_logits": workers.forward_logits(group, moe, mcfg, toks),
        "mla": workers.engine_streams(
            group, mla, mla_cfg, mla_prompts, STEPS,
            dict(max_slots=fc.SLOTS, max_seq=fc.MAX_SEQ,
                 prefill_buckets=fc.BUCKETS)),
        "quant": {mode: workers.quantized_slices(group, mcfg, mode)
                  for mode in ("int8", "fp8", "int4")},
        "int4": workers.int4_streams(group, _int4_cfg(), INT4_SEED,
                                     PROMPTS, STEPS, kw),
        "families": {f: workers.engine_streams(
            group, tree, _family_cfg(f), mla_prompts, STEPS, fkw)
            ["streams"] for f, tree in families.items()},
    }


def _np_tree(cfg, seed):
    """The port's seeded init of `cfg` as numpy, the tree both packages
    run (the JAX init is slow to trace on the CPU)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    tree = init_params(cfg, gen, "cpu")
    return {k: {kk: to_numpy(vv) for kk, vv in v.items()}
            if isinstance(v, dict) else to_numpy(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def trees():
    from ome_tpu.models.config import ModelConfig as JaxConfig
    f32 = torch.float32
    hf = fc.hf_config("dsv2lite")
    mla_cfg = ModelConfig.from_hf_config(hf).replace(dtype=f32)
    return {"dense": _np_tree(tiny_test().replace(dtype=f32), 0),
            "moe": _np_tree(tiny_test(moe=True).replace(dtype=f32), 0),
            "mla": _np_tree(mla_cfg, 3), "mla_cfg": mla_cfg,
            "jmla": JaxConfig.from_hf_config(hf).replace(dtype=jnp.float32),
            "families": {f: _np_tree(_family_cfg(f), 4) for f in FAMILIES}}


@pytest.fixture(scope="module")
def ranks(trees):
    return workers.run_group(_suite, trees["dense"], trees["moe"],
                             trees["mla"], trees["mla_cfg"], fc.prompts(),
                             trees["families"])


def test_tp2_greedy_streams_equal_jax_tp2_and_port_tp1(trees, ranks):
    cfg = jtiny().replace(dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, trees["dense"])
    ref = _jax_greedy(JaxSharded(params, cfg, tp=2, max_slots=4,
                                 max_seq=64), PROMPTS, STEPS)
    one = workers.greedy(InferenceEngine(
        from_jax_params(trees["dense"], "cpu"),
        tiny_test().replace(dtype=torch.float32), max_slots=4, max_seq=64,
        device="cpu"), PROMPTS, STEPS)
    assert one == ref
    for rank in ranks:
        assert rank["dense"]["streams"] == ref


def test_tp2_moe_logits_match_jax(trees, ranks):
    cfg = jtiny(moe=True).replace(dtype=jnp.float32)
    ref, _ = jllama.forward(jax.tree.map(jnp.asarray, trees["moe"]), cfg,
                            jnp.arange(1, 9, dtype=jnp.int32)[None])
    for rank in ranks:
        np.testing.assert_allclose(rank["moe_logits"], np.asarray(ref),
                                   atol=1e-5)


def test_mla_streams_equal_jax_tp2(trees, ranks):
    jcfg = trees["jmla"].replace(moe_impl="dense")
    ref = _jax_greedy(JaxSharded(jax.tree.map(jnp.asarray, trees["mla"]),
                                 jcfg, tp=2, max_slots=fc.SLOTS,
                                 max_seq=fc.MAX_SEQ,
                                 prefill_buckets=fc.BUCKETS),
                      fc.prompts(), STEPS)
    for rank in ranks:
        assert rank["mla"]["streams"] == ref
        # the latent cache is whole on every rank: one latent "head"
        assert rank["mla"]["kv_shape"][3] == 1


def test_sampled_tokens_agree_across_ranks(ranks):
    a, b = (r["sampled"]["streams"] for r in ranks)
    assert a == b
    greedy = ranks[0]["dense"]["streams"]
    # temperature 0.8 actually sampled: not the greedy stream
    assert [s[:8] for s in greedy] != a


def test_rank_quantization_equals_the_whole_trees_slices(ranks):
    for rank in ranks:
        for mode, leaves in rank["quant"].items():
            assert leaves and all(leaves.values()), (mode, leaves)
    # the split contractions are the ones that needed the group's max
    from ome_tpu_torch.parallel.sharding import split_contraction
    assert split_contraction() == {"wo", "w_down", "ws_down"}


def test_tp4_kv_head_sharding_layout():
    cfg = tiny_test().replace(dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cpu")
    for r in range(4):
        # no op runs: a group object of 4 without a process group
        eng = ShardedInferenceEngine(shard_params(params, r, 4), cfg, tp=4,
                                     group=comm.Group(r, 4), max_slots=2,
                                     max_seq=32, device="cpu")
        state = eng.new_state()
        K = cfg.num_kv_heads
        assert state.k.shape[3] == K // 4 and state.v.shape[3] == K // 4
        assert eng.cfg.num_heads == cfg.num_heads // 4
        assert eng.model_cfg == cfg
        wq = eng.model.params["layers"]["wq"]
        assert wq.shape[2] == cfg.num_heads // 4


def test_tp_requires_divisible_heads():
    cfg = tiny_test()  # 8 heads, 4 kv heads
    with pytest.raises(ValueError, match="num_kv_heads"):
        ShardedInferenceEngine({}, cfg, tp=3)
    with pytest.raises(ValueError, match="must divide num_heads=8"):
        ShardedInferenceEngine({}, cfg.replace(num_kv_heads=1, mla=True),
                               tp=3)
    with pytest.raises(ValueError, match="needs the ranks' group"):
        ShardedInferenceEngine({}, cfg, tp=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_streams_equal_tp1(trees, ranks, family):
    """Gemma 2 (post-block norms, softcaps, the scaled tied embedding),
    command-r (the parallel block, LayerNorm, logit scale; with its
    per-head q/k norms, which stay whole and are cut to a rank's heads)
    and Cohere2 (alternating windows, NoPE layers) at tp=2 give the
    port's tp=1 streams (which the family tests hold to the JAX
    engine's)."""
    one = workers.greedy(InferenceEngine(
        from_jax_params(trees["families"][family], "cpu"),
        _family_cfg(family), device="cpu", max_slots=fc.SLOTS,
        max_seq=fc.MAX_SEQ, prefill_buckets=fc.BUCKETS), fc.prompts(), STEPS)
    for rank in ranks:
        assert rank["families"][family] == one


def test_tp2_int4_streams_take_b4_on_each_rank(ranks):
    """int4 under tp=2 runs B4's wrapper on each rank's column slices
    (w_gate / w_up: K 256 whole, N 256 of 512), and the streams equal
    the port's tp=1 int4 engine's over the whole tree (the same seeded
    init, quantized whole)."""
    from ome_tpu_torch.models.quant import quantize_params
    cfg = _int4_cfg()
    gen = torch.Generator()
    gen.manual_seed(INT4_SEED)
    one = workers.greedy(InferenceEngine(
        quantize_params(init_params(cfg, gen, "cpu"), mode="int4"), cfg,
        max_slots=4, max_seq=64, device="cpu"), PROMPTS, STEPS)
    for rank in ranks:
        assert rank["int4"]["streams"] == one
        # packed [K/2, N/tp] of w_gate and w_up
        assert (128, 256) in rank["int4"]["int4_shapes"]


def test_tp_ops_run_under_the_group():
    """A tp engine's ops run under its group's collectives; a tp=1
    engine's under none."""
    cfg = tiny_test().replace(dtype=torch.float32)
    params = init_params(cfg, torch.Generator(), "cpu")
    seen = []
    for tp, group in ((2, comm.Group(0, 2)), (1, None)):
        eng = ShardedInferenceEngine(shard_params(params, 0, tp), cfg,
                                     tp=tp, group=group, max_slots=2,
                                     max_seq=32, device="cpu")
        with eng._ctx():
            seen.append(comm.current() is group)
    assert seen == [True, True]
    assert comm.current() is None
