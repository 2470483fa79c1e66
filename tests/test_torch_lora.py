"""Multi-LoRA serving in the port, against the JAX package (fp32, CPU).

The same numpy-seeded base weights (the JAX init, bridged with
`from_jax_params`) and the same PEFT directories, written in `tmp_path`
with the port's `save_safetensors`, go through both packages:

* `models/lora.py`: `load_adapter_matrices` and `merge_lora` (numpy and
  torch trees, fp32 and bf16) give the reference's arrays bit for bit,
  and every refusal carries the reference's message;
* the delta: `select_adapters` gathers each row's factors, and
  `_lora_delta` and `_proj_lora` over them (flatten 1 and 2, ids mixed
  with the base's 0) are within 1e-6 of the JAX functions; the forwards
  with adapter ids within 2e-4 (logits);
* greedy streams of base, a1 and a2 in one decode batch are identical
  to `ome_tpu.engine.core.InferenceEngine`'s for the dense, paged and
  int8-KV engines, and through `decode_multi` and `verify`; each stream
  equals its request alone;
* hot swap: unregister refused while in flight, then unregister and
  re-register by name; the rank cap and the slot count; a re-register
  between two layers of a step, or from other threads while a stream
  decodes, gives every step the old adapter's logits or the new one's,
  never a mix.

tests/test_torch_lora_serve.py holds the int4 and Mixtral streams, the
prefix tiers, the scheduler, server, serve flags, journal and PD.
"""

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ome_tpu import faults as jfaults
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import checkpoint as jck
from ome_tpu.models import llama as jllama
from ome_tpu.models import lora as jlora
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch import faults
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models import checkpoint, llama, lora
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params, to_numpy

MAX_SEQ = 64
KW = dict(max_slots=4, max_seq=MAX_SEQ, prefill_buckets=[16, 32],
          lora_slots=3, lora_rank=8)
JCFG = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ,
                          num_layers=2)
TCFG = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ,
                           num_layers=2)
ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
ALL = ATTN + ("gate_proj", "up_proj", "down_proj")
P = [5, 6, 7, 8, 9, 10]
P2 = [11, 3, 300, 41, 7, 7, 90, 2, 13]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _shapes(cfg):
    D, H, K, Dh, F = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim, cfg.intermediate_size)
    return {"q_proj": (H * Dh, D), "k_proj": (K * Dh, D),
            "v_proj": (K * Dh, D), "o_proj": (D, H * Dh),
            "gate_proj": (F, D), "up_proj": (F, D), "down_proj": (D, F)}


def write_adapter(d, cfg, seed, r=4, alpha=8.0, targets=ALL, scale=0.1,
                  layers=None, extra=None, config=None):
    """A PEFT adapter dir: lora_A [r, in] / lora_B [out, r] per target
    and layer, drawn from a numpy seed, written with the port's
    `save_safetensors`."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    shapes = _shapes(cfg)
    tensors = {}
    for layer in (range(cfg.num_layers) if layers is None else layers):
        for m in targets:
            out, inp = shapes[m]
            part = "self_attn" if m in ATTN else "mlp"
            pre = f"base_model.model.model.layers.{layer}.{part}.{m}."
            for ab, shape in (("A", (r, inp)), ("B", (out, r))):
                tensors[pre + f"lora_{ab}.weight"] = torch.from_numpy(
                    (rng.standard_normal(shape) * scale).astype(np.float32))
    tensors.update(extra or {})
    checkpoint.save_safetensors(os.path.join(d, "adapter_model.safetensors"),
                                tensors)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump(config or {"r": r, "lora_alpha": alpha,
                             "target_modules": list(targets)}, f)
    return str(d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    root = tmp_path_factory.mktemp("adapters")
    dirs = {name: write_adapter(root / name, TCFG, seed)
            for name, seed in (("a1", 11), ("a2", 22))}
    return jp, tp, dirs


def _engines(world, **kw):
    """(JAX engine, port engine) over the same weights, a1 and a2
    registered in both."""
    jp, tp, dirs = world
    je = JaxEngine(jp, JCFG, **{**KW, **kw})
    te = InferenceEngine(tp, TCFG, device="cpu", **{**KW, **kw})
    for e in (je, te):
        for name in ("a1", "a2"):
            e.register_adapter(name, dirs[name])
    return je, te


def _greedy(n):
    return (np.zeros(n, np.float32), np.zeros(n, np.int32),
            np.ones(n, np.float32))


def _admit(eng, jobs):
    """A fresh state with jobs [(prompt, adapter)] prefilled and
    inserted into slots 0..; returns (state, first tokens)."""
    state = eng.new_state()
    first = []
    for slot, (p, ad) in enumerate(jobs):
        kw = {} if ad is None else {"adapter": ad}
        tok, kv, tl, b = eng.prefill(p, **kw)
        state = eng.insert(state, kv, slot, tl, tok, b, **kw)
        first.append([int(tok)])
    return state, first


def streams(eng, jobs, steps=8):
    """Greedy streams of jobs [(prompt, adapter)] in one decode batch."""
    state, out = _admit(eng, jobs)
    for _ in range(steps):
        state, toks = eng.decode(state, *_greedy(eng.max_slots))
        toks = np.asarray(toks)
        for i in range(len(jobs)):
            out[i].append(int(toks[i]))
    return out


JOBS = [(P, None), (P, "a1"), (P2, "a2")]


# -- models/lora.py -----------------------------------------------------------


def test_adapter_matrices_bit_equal(world):
    _, _, dirs = world
    got = lora.load_adapter_matrices(dirs["a1"], TCFG, rank_pad=8)
    want = jlora.load_adapter_matrices(dirs["a1"], JCFG, rank_pad=8)
    assert sorted(got) == sorted(want) == sorted(
        ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"])
    for leaf, (a, b) in want.items():
        np.testing.assert_array_equal(got[leaf][0], a)
        np.testing.assert_array_equal(got[leaf][1], b)
        assert got[leaf][0].shape == (2, 8) + a.shape[2:]


def _tiny_checkpoint(d, cfg_hf):
    """A tiny Llama checkpoint (F32, seeded numpy) and its config."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(5)
    D, L, V = cfg_hf["hidden_size"], cfg_hf["num_hidden_layers"], \
        cfg_hf["vocab_size"]
    H, K = cfg_hf["num_attention_heads"], cfg_hf["num_key_value_heads"]
    Dh, F = D // H, cfg_hf["intermediate_size"]

    def w(*s):
        return torch.from_numpy((rng.standard_normal(s) * 0.02).astype(
            np.float32))
    T = {"model.embed_tokens.weight": w(V, D), "lm_head.weight": w(V, D),
         "model.norm.weight": torch.ones(D)}
    for i in range(L):
        p = f"model.layers.{i}."
        T.update({p + "input_layernorm.weight": torch.ones(D),
                  p + "post_attention_layernorm.weight": torch.ones(D),
                  p + "self_attn.q_proj.weight": w(H * Dh, D),
                  p + "self_attn.k_proj.weight": w(K * Dh, D),
                  p + "self_attn.v_proj.weight": w(K * Dh, D),
                  p + "self_attn.o_proj.weight": w(D, H * Dh),
                  p + "mlp.gate_proj.weight": w(F, D),
                  p + "mlp.up_proj.weight": w(F, D),
                  p + "mlp.down_proj.weight": w(D, F)})
    checkpoint.save_safetensors(os.path.join(d, "model.safetensors"), T)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg_hf, f)
    return str(d)


TINY_HF = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512,
           "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 128, "max_position_embeddings": 128,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
           "tie_word_embeddings": False}


def _bits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_bit_equal(tmp_path, dtype):
    """The port's merge of a torch tree (and of a numpy tree) equals the
    reference's merge of its numpy tree, leaf for leaf, bit for bit."""
    base = _tiny_checkpoint(tmp_path / "base", TINY_HF)
    tcfg = checkpoint.load_config(base)
    ad = write_adapter(tmp_path / "ad", tcfg, 3, targets=("q_proj",
                                                          "o_proj",
                                                          "down_proj"),
                       layers=[1])
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tp, tcfg = checkpoint.load_params(base, dtype=tdt, device="cpu")
    jp, jcfg = jck.load_params(base, dtype=jdt, device_put=False)
    assert lora.merge_lora(tp, tcfg, ad) == jlora.merge_lora(jp, jcfg,
                                                             ad) == 3
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(to_numpy(tp["layers"][name]),
                                      _bits(leaf), err_msg=name)
    # the numpy form of the port's copy
    np_tree = {"layers": {k: np.asarray(v) for k, v in
                          jck.load_params(base, dtype=jdt,
                                          device_put=False)[0][
                                              "layers"].items()}}
    lora.merge_lora(np_tree, tcfg, ad)
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(_bits(np_tree["layers"][name]),
                                      _bits(leaf), err_msg=name)


def _bad_dirs(tmp_path):
    """name -> (adapter dir, rank_pad, loader) of each refusal."""
    cfg = TCFG
    q = _shapes(cfg)["q_proj"]
    pre = "base_model.model.model.layers.0.self_attn.q_proj."
    A = torch.zeros(4, q[1])
    return {
        "unmatched": write_adapter(
            tmp_path / "u", cfg, 1, targets=("q_proj",),
            extra={"base_model.model.lm_head.lora_A.weight": A}),
        "incomplete": write_adapter(
            tmp_path / "i", cfg, 1, targets=(),
            extra={pre + "lora_A.weight": A}),
        "pair_rank": write_adapter(
            tmp_path / "p", cfg, 1, targets=(),
            extra={pre + "lora_A.weight": A,
                   pre + "lora_B.weight": torch.zeros(q[0], 3)}),
        "config_rank": write_adapter(
            tmp_path / "c", cfg, 1, targets=("q_proj",),
            config={"r": 8, "lora_alpha": 8}),
        "slot_rank": write_adapter(tmp_path / "s", cfg, 1, r=16),
        "layer_range": write_adapter(tmp_path / "l", cfg, 1,
                                     targets=("q_proj",), layers=[5]),
        "empty": write_adapter(tmp_path / "e", cfg, 1, targets=()),
    }


def test_refusals_carry_the_reference_messages(tmp_path):
    for name, d in _bad_dirs(tmp_path).items():
        with pytest.raises(ValueError) as got:
            lora.load_adapter_matrices(d, TCFG, rank_pad=8)
        with pytest.raises(ValueError) as want:
            jlora.load_adapter_matrices(d, JCFG, rank_pad=8)
        assert str(got.value) == str(want.value), name


# -- the delta ----------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name,flatten", [("wq", 1), ("wo", 2)])
def test_delta_and_proj_lora_equal_jax(name, flatten):
    rng = np.random.default_rng(0)
    B, S, n, r = 4, 3, 4, 8
    if flatten == 1:
        x = rng.standard_normal((B, S, 32)).astype(np.float32)
        w = rng.standard_normal((32, 4, 6)).astype(np.float32)
        K, N, out_dims = 32, 24, (4, 6)
    else:
        x = rng.standard_normal((B, S, 4, 6)).astype(np.float32)
        w = rng.standard_normal((4, 6, 32)).astype(np.float32)
        K, N, out_dims = 24, 32, None
    # factors at an adapter's scale (the PEFT dirs here draw 0.1)
    a = (rng.standard_normal((n, r, K)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((n, r, N)) * 0.1).astype(np.float32)
    a[0] = b[0] = 0  # slot 0: the base model
    ids = np.asarray([0, 2, 0, 3], np.int32)
    jlp = {name: jnp.asarray(w), name + "_lora_a": jnp.asarray(a),
           name + "_lora_b": jnp.asarray(b)}
    tlp = {k: _t(v) for k, v in jlp.items()}
    # the rows' factors gathered for every layer (here one), as the
    # forwards pass them
    sel = llama.select_adapters(
        {name + "_lora_a": _t(a)[None], name + "_lora_b": _t(b)[None]},
        _t(ids))
    assert set(sel) == {name}
    sa, sb = sel[name]
    np.testing.assert_array_equal(sa[0].numpy(), a[ids])
    np.testing.assert_array_equal(sb[0].numpy(), b[ids])
    assert llama.select_adapters({name + "_lora_a": _t(a)[None]},
                                 None) == {}
    assert llama.select_adapters(None, _t(ids)) == {}
    want = np.asarray(jllama._lora_delta(jnp.asarray(x), jlp, name,
                                         jnp.asarray(ids), flatten))
    got = llama._lora_delta(_t(x), sa[0], sb[0], flatten)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert not np.any(want[[0, 2]])
    want = np.asarray(jllama._proj_lora(
        jnp.asarray(x), jlp, name, jnp.asarray(ids), jnp.float32,
        out_dims=out_dims, flatten=flatten))
    got = llama._proj_lora(_t(x), tlp, name, {name: (sa[0], sb[0])},
                           torch.float32, out_dims=out_dims,
                           flatten=flatten)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _stacked(world, ids_slots=4):
    """The JAX tree with adapter stacks among its layer leaves (the
    reference's layout), and the port's tree with the same stacks beside
    it (a1 in slot 1, a2 in slot 2, as the engines register them)."""
    jp, tp, dirs = world
    jl, tl = dict(jp["layers"]), {}
    n = ids_slots
    for slot, name in ((1, "a1"), (2, "a2")):
        mats = jlora.load_adapter_matrices(dirs[name], JCFG, rank_pad=8)
        for leaf, (A, B) in mats.items():
            for sfx, m in (("_lora_a", A), ("_lora_b", B)):
                cur = jl.get(leaf + sfx)
                if cur is None:
                    cur = np.zeros((JCFG.num_layers, n) + m.shape[1:],
                                   np.float32)
                cur = np.array(cur)
                cur[:, slot] = m
                jl[leaf + sfx] = cur
    for k in list(jl):
        if "_lora_" in k:
            tl[k] = _t(jl[k])
            jl[k] = jnp.asarray(jl[k])
    return dict(jp, layers=jl), tp, tl


def test_forwards_with_adapter_ids_equal_jax(world):
    jp, tp, stacks = _stacked(world)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 512, (3, 12)).astype(np.int32)
    ids = np.asarray([1, 0, 2], np.int32)
    jc = jllama.KVCache.create(JCFG, 3, 32)
    tc = llama.KVCache.create(TCFG, 3, 32, device="cpu")
    ref, jc = jllama.forward(jp, JCFG, jnp.asarray(toks), cache=jc,
                             adapter_ids=jnp.asarray(ids))
    out, tc = llama.forward(tp, TCFG, _t(toks), cache=tc,
                            adapter_ids=_t(ids), lora_stacks=stacks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    base, _ = llama.forward(tp, TCFG, _t(toks))
    assert not np.allclose(base.numpy()[0], out.numpy()[0], atol=1e-2)
    np.testing.assert_array_equal(base.numpy()[1], llama.forward(
        tp, TCFG, _t(toks), adapter_ids=_t(ids),
        lora_stacks=stacks)[0].numpy()[1])
    # one paged decode step over random pools
    L, K, Dh, N, bs = 2, 4, 16, 12, 8
    kp = rng.standard_normal((L, N, bs, K, Dh)).astype(np.float32)
    vp = rng.standard_normal((L, N, bs, K, Dh)).astype(np.float32)
    table = (rng.permutation(N - 1)[:9] + 1).reshape(3, 3).astype(np.int32)
    index = np.asarray([5, 17, 9], np.int32)
    step = rng.integers(3, 512, (3, 1)).astype(np.int32)
    ref, _ = jllama.forward_paged(
        jp, JCFG, jnp.asarray(step), jllama.PagedKVCache(
            k=jnp.asarray(kp), v=jnp.asarray(vp), index=jnp.asarray(index),
            table=jnp.asarray(table)), adapter_ids=jnp.asarray(ids))
    out, _ = llama.forward_paged(
        tp, TCFG, _t(step), llama.PagedKVCache(
            k=_t(kp), v=_t(vp), index=_t(index), table=_t(table)),
        adapter_ids=_t(ids), lora_stacks=stacks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


# -- streams ------------------------------------------------------------------


POOLS = {"dense": {}, "paged": {"kv_block": 16},
         "paged_int8": {"kv_block": 16, "kv_dtype": "int8"}}


@pytest.mark.parametrize("pool", list(POOLS))
def test_streams_equal_jax(world, pool):
    je, te = _engines(world, **POOLS[pool])
    want = streams(je, JOBS)
    got = streams(te, JOBS)
    assert got == want
    assert want[0] != want[1] and want[0][:3] != want[2][:3]
    # each request alone gives its stream in the batch
    for i, job in enumerate(JOBS):
        assert streams(te, [job])[0] == got[i]
    if pool != "dense":
        for slot in range(3):
            te.free_slot(slot)
        assert te.kv_conservation()[0]


def _multi(eng, jobs, steps, k=4):
    """Greedy streams through `decode_multi` chunks of k."""
    n = eng.max_slots
    state, out = _admit(eng, jobs)
    stops = np.full((n, 2), -1, np.int32)
    while min(len(s) for s in out) < steps + 1:
        budget = np.zeros(n, np.int32)
        for i, s in enumerate(out):
            budget[i] = min(steps + 1 - len(s), k)
        state, toks, adv = eng.decode_multi(state, *_greedy(n), steps=k,
                                            budget=budget, stop_ids=stops)
        toks, adv = np.asarray(toks), np.asarray(adv)
        for i in range(len(jobs)):
            out[i] += [int(t) for t in toks[i, :int(adv[i])]]
            eng.commit_spec(i, int(adv[i]))
    return out


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_decode_multi_and_verify_equal_jax(world, pool):
    je, te = _engines(world, **POOLS[pool])
    want = streams(je, JOBS)
    assert _multi(te, JOBS, 8) == want
    # verify: drafts from the reference streams, slot 1's third draft
    # wrong, slot 2 without drafts; both engines from the same state
    k = 4
    drafts = np.zeros((4, k), np.int32)
    dlen = np.asarray([k, k, 0, 0], np.int32)
    for i in range(2):
        drafts[i] = want[i][1:1 + k]
    drafts[1, 2] = (drafts[1, 2] + 1) % 512
    got = []
    for eng in (je, te):
        state, _ = _admit(eng, JOBS)
        outs = []
        for _ in range(2):
            state, out, acc = eng.verify(state, drafts, dlen,
                                         *_greedy(4))
            outs.append((np.asarray(out)[:3].tolist(),
                         np.asarray(acc)[:3].tolist()))
            if pool == "paged":
                for i in range(3):
                    eng.commit_spec(i, int(np.asarray(acc)[i]) + 1)
        got.append(outs)
    assert got[0] == got[1]
    (out, acc), _ = got[1]
    assert acc[0] == k and acc[1] == 2 and acc[2] == 0
    assert out[1][:3] == want[1][1:4]


# -- hot swap -----------------------------------------------------------------


def test_unregister_in_flight_then_reregister(world):
    jp, tp, dirs = world
    te = InferenceEngine(tp, TCFG, device="cpu", **KW)
    assert te.register_adapter("a1", dirs["a1"]) == 1
    assert te.register_adapter("a2", dirs["a2"]) == 2
    assert te.adapter_names == ["a1", "a2"]
    want_a2 = streams(te, [(P, "a2")])[0]
    state, _ = _admit(te, [(P, "a1")])
    with pytest.raises(ValueError, match="in-flight"):
        te.unregister_adapter("a1")
    te.free_slot(0)
    te.unregister_adapter("a1")
    te.unregister_adapter("a1")  # unknown: a no-op
    with pytest.raises(ValueError, match="unknown adapter"):
        te.adapter_id("a1")
    assert all(not t[:, 1].any() for t in te._lora.values())
    assert te.register_adapter("a1", dirs["a2"]) == 1
    assert streams(te, [(P, "a1")])[0] == want_a2
    with pytest.raises(ValueError, match="exceeds"):
        te.register_adapter("big", write_adapter(
            os.path.join(os.path.dirname(dirs["a1"]), "big"), TCFG, 1,
            r=16))
    te.register_adapter("a3", dirs["a1"])
    with pytest.raises(ValueError, match="all 3 LoRA slots in use"):
        te.register_adapter("a4", dirs["a1"])
    with pytest.raises(ValueError, match="without LoRA slots"):
        InferenceEngine(tp, TCFG, device="cpu", max_slots=2,
                        max_seq=MAX_SEQ).register_adapter("a1", dirs["a1"])


def _logits_under(te, snap, stacks):
    """The decode step's logits from the state snapshot `snap` under the
    adapter stacks `stacks`."""
    k, v, lengths, tokens, adapters = snap
    cache = llama.KVCache(k=k.clone(), v=v.clone(), index=lengths)
    with torch.no_grad():
        logits, _ = te.model(tokens[:, None], cache=cache,
                             adapter_ids=adapters, lora=stacks)
    return logits[:, -1]


def _recording(te):
    """Record each decode step's state before it and its logits."""
    seen = []
    sample, step = te._sample, te._forward_step

    def forward_step(state, tokens, lora=None):
        seen.append([(state.k.clone(), state.v.clone(),
                      state.lengths.clone(), state.tokens.clone(),
                      state.adapters.clone())])
        return step(state, tokens, lora)

    def rec_sample(logits, *a):
        seen[-1].append(logits.clone())
        return sample(logits, *a)
    te._forward_step, te._sample = forward_step, rec_sample
    return seen


def test_reregister_between_layers_never_mixes(world):
    """A re-register of the name a slot decodes with, issued between two
    layers of a step, leaves that step on the old factors; the next
    step runs on the new ones."""
    _, tp, dirs = world
    te = InferenceEngine(tp, TCFG, device="cpu", **KW)
    te.register_adapter("x", dirs["a1"])
    old = te._lora
    state, _ = _admit(te, [(P, "x"), (P2, None)])
    seen = _recording(te)
    layer = llama._layer
    calls = []

    def swapping_layer(*a, **kw):
        calls.append(1)
        if len(calls) == 2:  # inside the first step, after layer 0
            te.register_adapter("x", dirs["a2"])
        return layer(*a, **kw)
    llama._layer = swapping_layer
    try:
        for _ in range(2):
            state, _ = te.decode(state, *_greedy(4))
    finally:
        llama._layer = layer
    new = te._lora
    assert new is not old and len(calls) == 4
    for (snap, got), stacks in zip(seen, (old, new)):
        want = _logits_under(te, snap, stacks)
        assert torch.equal(got, want)
        other = _logits_under(te, snap, new if stacks is old else old)
        assert not torch.equal(got[0], other[0])


def test_reregister_from_another_thread_never_mixes(world):
    """Stress: a thread re-registers the name (a1's and a2's factors in
    turns) while the stream decodes, under a short switch interval;
    every step's logits equal one version's exactly."""
    _, tp, dirs = world
    te = InferenceEngine(tp, TCFG, device="cpu", **KW)
    te.register_adapter("x", dirs["a1"])
    versions = [te._lora]
    state, _ = _admit(te, [(P, "x"), (P2, None), (P, None)])
    seen = _recording(te)
    stop = threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            i += 1
            te.register_adapter("x", dirs["a2" if i % 2 else "a1"])
            versions.append(te._lora)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=churn) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for _ in range(12):
            state, _ = te.decode(state, *_greedy(4))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(versions) > 2
    # two distinct contents: a1's factors and a2's
    kinds = [versions[0], next(v for v in versions
                               if not torch.equal(v["wq_lora_a"],
                                                  versions[0]["wq_lora_a"]))]
    for snap, got in seen:
        assert any(torch.equal(got, _logits_under(te, snap, s))
                   for s in kinds)
