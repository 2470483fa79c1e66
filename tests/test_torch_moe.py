"""The Mixtral MoE MLP in the port, against the JAX package.

* `moe_mlp_ragged` and `moe_mlp_dense` of `tiny_test(moe=True)` (8
  experts, top 2) on one layer's weights, in fp32, are each within 1e-5
  of the JAX functions: on random inputs and in the reference's
  one-expert hotspot case (tests/test_moe.py: every token routed to
  expert 3, so seven experts get no rows);
* the router's ties are taken lower expert id first, as `lax.top_k`
  takes them, and its weights equal the reference's;
* int8 and int4 quantization of a bf16 MoE tree gives the reference's
  `quantize_params` bytes and scales, leaf for leaf (experts quantized
  over D, the router left in full precision), and the int8 and int4 MoE
  forwards stay within 2e-4 of the reference's logits;
* a tiny Mixtral (from its config.json dict, top-2 of 4 experts) at
  G 2, 3 and 7: `forward` logits within 2e-4 of the JAX forward (the
  ragged dispatch), greedy streams equal the JAX engine's (dense cache:
  paged KV refuses MoE in both packages, in the same words), and a
  `tmp_path` checkpoint loads leaf for leaf equal to the JAX
  `load_params`;
* a `decode_multi` chunk on the ragged model makes no host read (it
  runs on tensors that refuse `.item()`, `.tolist()`, `.cpu()` and
  `.numpy()`) and gives the single steps' tokens, and a served Mixtral
  (`--random-weights`) runs the ragged dispatch.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine, PagedKVUnsupported
from ome_tpu_torch.models import llama, quant
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params, to_numpy
from test_torch_families import (GREEDY, MAX_SEQ, SLOTS, check_checkpoint,
                                 check_forward, hf_config, model, prompts,
                                 streams)

MOE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """One layer of the JAX init of tiny_test(moe=True) in fp32, as
    (jcfg, jax layer, port cfg, port layer)."""
    jcfg = jax_tiny(moe=True).replace(dtype=jnp.float32)
    tcfg = tiny_test(moe=True).replace(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(0), jcfg))
    lp = {k: v[0] for k, v in tree["layers"].items()}
    return jcfg, lp, tcfg


def _pair(lp, router=None):
    lp = dict(lp)
    if router is not None:
        lp["router"] = router
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            from_jax_params(lp, "cpu"))


@pytest.mark.parametrize("case", ["random", "hotspot"])
@pytest.mark.parametrize("impl", ["ragged", "dense"])
def test_moe_mlp_matches_reference(layer, impl, case):
    jcfg, lp, tcfg = layer
    router = None
    if case == "hotspot":
        # the reference's degenerate case: expert 3 wins every token
        router = np.zeros(lp["router"].shape, np.float32)
        router[:, 3] = 10.0
        router[:, 5] = 5.0
    jlp, tlp = _pair(lp, router)
    x = np.random.default_rng(1).standard_normal(
        (2, 9, jcfg.hidden_size)).astype(np.float32)
    jfn = getattr(jllama, f"moe_mlp_{impl}")
    tfn = getattr(llama, f"moe_mlp_{impl}")
    want = np.asarray(jfn(jnp.asarray(x), jlp, jcfg))
    have = tfn(torch.from_numpy(x), tlp, tcfg)
    assert have.dtype == torch.float32 and have.shape == want.shape
    np.testing.assert_allclose(have.numpy(), want, atol=MOE_ATOL, rtol=0)


def test_router_ties_and_weights_match_reference(layer):
    jcfg, lp, tcfg = layer
    E = jcfg.num_experts
    # experts 1, 4 and 6 share one router column and 2, 5 another: the
    # logits tie exactly, and lax.top_k keeps the lower id first
    router = np.random.default_rng(2).standard_normal(
        (jcfg.hidden_size, E)).astype(np.float32)
    router[:, 4] = router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 2]
    jlp, tlp = _pair(lp, router)
    x = np.random.default_rng(3).standard_normal(
        (3, 11, jcfg.hidden_size)).astype(np.float32)
    jw, jidx = jllama._route(jnp.asarray(x), jlp, jcfg)
    tw, tidx = llama._route(torch.from_numpy(x), tlp, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    tied = np.isin(np.asarray(jidx), [1, 2, 4, 5, 6])
    assert tied.any()


@pytest.fixture(scope="module")
def bf16_moe_tree():
    jcfg = jax_tiny(moe=True)
    return jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(4), jcfg))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_moe_leaves_match_reference_bytes(bf16_moe_tree, mode):
    ref = jquant.quantize_params(
        jax.tree.map(jnp.asarray, bf16_moe_tree), mode=mode)
    got = quant.quantize_params(from_jax_params(bf16_moe_tree, "cpu"),
                                mode=mode)
    assert not isinstance(got["layers"]["router"], quant.QTensor)
    np.testing.assert_array_equal(to_numpy(got["layers"]["router"]),
                                  bf16_moe_tree["layers"]["router"]
                                  .view(np.uint16))
    for name in ("we_gate", "we_up", "we_down"):
        a, b = got["layers"][name], ref["layers"][name]
        assert (a.bits, a.axis) == (b.bits, b.axis), name
        assert a.bits == (4 if mode == "int4" else 8), name
        np.testing.assert_array_equal(to_numpy(a.q), np.asarray(b.q),
                                      err_msg=name)
        np.testing.assert_array_equal(to_numpy(a.s), np.asarray(b.s),
                                      err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_moe_forward_matches_reference(mode):
    jcfg = jax_tiny(moe=True).replace(dtype=jnp.float32)
    tcfg = tiny_test(moe=True).replace(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(5), jcfg))
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), mode=mode)
    tq = quant.quantize_params(from_jax_params(tree, "cpu"), mode=mode)
    toks = np.random.default_rng(6).integers(3, 500, (2, 7)).astype(
        np.int32)
    want, _ = jllama.forward(jq, jcfg, jnp.asarray(toks))
    have, _ = llama.forward(tq, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(have.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("G", [2, 3, 7])
def test_mixtral_forward_matches_reference(G):
    check_forward("mixtral", G)


def test_mixtral_greedy_streams_match_jax_engine():
    jcfg, jp, tcfg, tp = model("mixtral")
    jeng = JaxEngine(jp, jcfg, max_slots=SLOTS, max_seq=MAX_SEQ)
    teng = InferenceEngine(tp, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                           device="cpu")
    assert streams(teng, prompts(), 12) == streams(jeng, prompts(), 12)


def test_mixtral_checkpoint_round_trips_leaf_for_leaf(tmp_path):
    check_checkpoint("mixtral", tmp_path)


def test_paged_kv_refuses_moe_in_the_references_words():
    jcfg, jp, tcfg, tp = model("mixtral")
    words = "paged KV supports standard rmsnorm GQA models"
    with pytest.raises(ValueError, match=words):
        JaxEngine(jp, jcfg, max_slots=2, max_seq=MAX_SEQ, kv_block=16)
    with pytest.raises(PagedKVUnsupported, match=words):
        InferenceEngine(tp, tcfg, max_slots=2, max_seq=MAX_SEQ,
                        device="cpu", kv_block=16)


class _NoHostRead(torch.Tensor):
    """A tensor whose host reads raise while `armed`."""

    armed = False

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if cls.armed and func in (torch.Tensor.item, torch.Tensor.tolist,
                                  torch.Tensor.cpu, torch.Tensor.numpy):
            raise AssertionError(f"host read {func.__name__} in a chunk")
        return super().__torch_function__(func, types, args, kwargs or {})


def test_ragged_decode_multi_chunk_makes_no_host_read():
    _, _, tcfg, tp = model("mixtral", 3)
    assert tcfg.moe_impl == "ragged"
    eng = InferenceEngine(tp, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cpu")
    ids = prompts()
    ref = streams(eng, ids, 7)
    for slot in range(len(ids)):
        eng.free_slot(slot)
    st = eng.new_state()
    first = []
    for slot, p in enumerate(ids):
        tok, kv, n, bucket = eng.prefill(p, 0.0, 0, 1.0)
        st = eng.insert(st, kv, slot, n, tok, bucket)
        first.append(int(tok))
    st.tokens = st.tokens.as_subclass(_NoHostRead)
    st.lengths = st.lengths.as_subclass(_NoHostRead)
    budget = np.full(SLOTS, 6, np.int32)
    stops = np.full((SLOTS, 4), -1, np.int32)
    args = [torch.from_numpy(a).as_subclass(_NoHostRead)
            for a in (*GREEDY, budget, stops)]
    _NoHostRead.armed = True
    try:
        st, out, adv = eng.decode_multi(st, *args[:3], steps=6,
                                        budget=args[3], stop_ids=args[4])
    finally:
        _NoHostRead.armed = False
    out = np.asarray(out)
    assert np.asarray(adv).tolist() == [6] * SLOTS
    for slot in range(len(ids)):
        assert [first[slot]] + out[slot].tolist() == ref[slot], slot


def test_served_mixtral_runs_the_ragged_dispatch(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(hf_config("mixtral")))
    server, sched, engine = serve.build_server(
        ["--model-dir", str(tmp_path), "--random-weights", "--device",
         "cpu", "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "64", "--dtype", "float32"])
    try:
        assert engine.cfg.moe_impl == "ragged"
        body = {"prompt": [5, 6, 7, 8], "max_tokens": 4, "temperature": 0.0}
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            doc = json.loads(r.read())
        assert 1 <= doc["usage"]["completion_tokens"] <= 4
    finally:
        server.stop()
