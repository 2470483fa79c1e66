"""Weight-only quantization in the port against ome_tpu.models.quant.

* bytes: `quantize_params` of the port and of the JAX package, on the
  same weights, give equal `q` bytes, equal f32 scales, equal `bits`
  and `axis` and equal `quantized_bytes`, for int8, int4 and fp8, on a
  kernel-eligible config (hidden 1024, FFN 1024, head_dim 128, GQA 8/2,
  2 layers, fp32 weights), and for int4 on `tiny_test()` in bf16, where
  every int4 axis is one group;
* `QTensor.dequant` and `QTensor.take` are bit-identical to the
  reference's, in fp32 and bf16;
* the `Llama` module keeps a quantized leaf as two buffers and gives
  the same QTensor back.

Logits and greedy streams on quantized weights are in
tests/test_torch_quant_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.models import llama, quant
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import (from_jax_params, param_count,
                                         to_numpy)

MODES = ("int8", "int4", "fp8")
KW = dict(hidden_size=1024, intermediate_size=1024, num_layers=2,
          num_heads=8, num_kv_heads=2, head_dim=128, max_seq_len=128)
JCFG = jax_tiny().replace(dtype=jnp.float32, **KW)
TCFG = tiny_test().replace(dtype=torch.float32, **KW)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's bridge of them) for the eligible config
    in fp32 and tiny_test() in bf16."""
    out = {}
    for name, cfg in (("eligible", JCFG),
                      ("tiny", jax_tiny().replace(dtype=jnp.bfloat16))):
        jp = jllama.init_params(jax.random.PRNGKey(0), cfg)
        out[name] = (jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                         "cpu"))
    return out


@pytest.fixture(scope="module")
def quantized(weights):
    """mode -> (the JAX quantized tree, the port's bridge of it), on the
    eligible config."""
    jp, _ = weights["eligible"]
    out = {}
    for mode in MODES:
        jq = jquant.quantize_params(jp, mode=mode)
        out[mode] = (jq, from_jax_params(jax.tree.map(np.asarray, jq),
                                         "cpu"))
    return out


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("config,mode", [
    ("eligible", "int8"), ("eligible", "int4"), ("eligible", "fp8"),
    ("tiny", "int4")])
def test_quantizer_bytes_equal_jax(weights, config, mode):
    jp, tp = weights[config]
    jq = jquant.quantize_params(jp, mode=mode)
    ref = _leaves(from_jax_params(jax.tree.map(np.asarray, jq), "cpu"))
    got = _leaves(quant.quantize_params(tp, mode=mode))
    assert got.keys() == ref.keys()
    n_quant = 0
    for name, a in got.items():
        b = ref[name]
        assert type(a) is type(b), name
        if not isinstance(a, quant.QTensor):  # norms stay as they were
            assert torch.equal(a, b), name
            continue
        n_quant += 1
        assert (a.bits, a.axis) == (b.bits, b.axis), name
        assert a.q.dtype == b.q.dtype and a.s.dtype == torch.float32, name
        np.testing.assert_array_equal(to_numpy(a.q), to_numpy(b.q),
                                      err_msg=name)
        np.testing.assert_array_equal(to_numpy(a.s), to_numpy(b.s),
                                      err_msg=name)
    # embed, lm_head and the seven layer matmuls
    assert n_quant == 2 + 7
    qt = quant.quantize_params(tp, mode=mode)
    assert quant.quantized_bytes(qt) == jquant.quantized_bytes(jq)
    assert param_count(qt) == param_count(tp)
    if mode == "int4":
        layers = _leaves(qt)
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            leaf = layers[f"layers.{name}"]
            # packed along D (axis 1 of [L, D, ...]), stored negative
            assert leaf.bits == 4 and leaf.axis == 1 - leaf.q.dim()
            assert leaf.s.shape[1] == (1 if config == "tiny" else 8)
        for name in ("wo", "w_down"):
            assert layers[f"layers.{name}"].bits == 8


def test_consume_empties_the_source_and_gives_the_same_tree(weights):
    """`consume=True` (what serve does) drops each source leaf once it
    is quantized and returns the same tree as the default call."""
    _, tp = weights["tiny"]
    want = _leaves(quant.quantize_params(tp, mode="int4"))
    src = {k: dict(v) if isinstance(v, dict) else v for k, v in tp.items()}
    got = _leaves(quant.quantize_params(src, mode="int4", consume=True))
    assert src == {}
    assert got.keys() == want.keys()
    for name, a in got.items():
        b = want[name]
        if isinstance(a, quant.QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), name
        else:
            assert a is b, name
    assert len(_leaves(tp)) == len(got)  # the caller's tree is untouched


@pytest.mark.parametrize("mode", MODES)
def test_dequant_and_take_bit_identical(quantized, mode):
    jq, tq = quantized[mode]
    jl, tl = _leaves(jq), _leaves(tq)
    idx = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 5))
    for name, tleaf in tl.items():
        if not isinstance(tleaf, quant.QTensor):
            continue
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jl[name].dequant(jdt))
            got = to_numpy(tleaf.dequant(tdt))
            np.testing.assert_array_equal(
                got, want.view(np.uint16) if tdt == torch.bfloat16
                else want, err_msg=name)
        # row gather: token ids into the embedding, layer ids into a
        # stacked layer leaf (the int4 unpack on gathered rows)
        rows = idx if name == "embed" else np.asarray([[1, 0, 1]])
        if name == "embed" or name.startswith("layers."):
            want = np.asarray(jl[name].take(jnp.asarray(rows), jnp.float32))
            got = tleaf.take(_t(rows), torch.float32).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_llama_module_holds_quantized_leaves(quantized):
    """The nn.Module keeps a QTensor as two buffers (so .to() moves
    both) and gives the same QTensor back."""
    _, tq = quantized["int4"]
    model = llama.Llama(TCFG, tq)
    names = dict(model.named_buffers())
    assert "layers.wq_q" in names and "layers.wq_s" in names
    assert "embed_q" in names and "layers.attn_norm" in names
    back = model.params
    for name, leaf in _leaves(tq).items():
        got = _leaves(back)[name]
        if isinstance(leaf, quant.QTensor):
            assert (got.bits, got.axis) == (leaf.bits, leaf.axis)
            assert got.q is leaf.q and got.s is leaf.s
        else:
            assert got is leaf


@pytest.mark.parametrize("mode,shape,axes", [
    # int4 with an odd group count: the packed halves split group 1
    ("int4", (384, 96), (0,)),
    # int4 with one group along the axis (K 200 is not a multiple of 128)
    ("int4", (200, 64), (0,)),
    # an expert stack [E, D, F], the contraction over D
    ("int4", (4, 256, 64), (1,)),
    ("int8", (4, 256, 64), (1,)),
    ("fp8", (4, 256, 64), (1,)),
])
def test_dequant_into_output_bit_identical(mode, shape, axes):
    """`dequant` writes each fp32 product straight into the output; its
    bits equal the reference's whole-array dequant in fp32 and bf16, at
    group layouts the model configs above do not reach."""
    fns = {"int8": (jquant.quantize_tensor, quant.quantize_tensor),
           "int4": (jquant.quantize_tensor_int4,
                    quant.quantize_tensor_int4),
           "fp8": (jquant.quantize_tensor_fp8, quant.quantize_tensor_fp8)}
    jfn, tfn = fns[mode]
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jq, tq = jfn(jnp.asarray(w), axes), tfn(_t(w), axes)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.dequant(jdt))
        got = to_numpy(tq.dequant(tdt))
        np.testing.assert_array_equal(
            got, want.view(np.uint16) if tdt == torch.bfloat16 else want)


@pytest.mark.parametrize("mode", MODES)
def test_expert_stacks_quantize_by_slice_to_the_whole_leaf_bytes(mode):
    """An expert stack [L, E, D, F] is quantized one expert at a time
    (`_per_layer`); its bytes equal one call on the whole leaf."""
    fn = {"int8": quant.quantize_tensor, "fp8": quant.quantize_tensor_fp8,
          "int4": quant.quantize_tensor_int4}[mode]
    w = _t(np.random.default_rng(4).standard_normal(
        (2, 3, 256, 32)).astype(np.float32))
    whole, sliced = fn(w, (2,)), quant._per_layer(fn, w, (2,))
    assert (whole.bits, whole.axis) == (sliced.bits, sliced.axis)
    np.testing.assert_array_equal(to_numpy(sliced.q), to_numpy(whole.q))
    np.testing.assert_array_equal(to_numpy(sliced.s), to_numpy(whole.s))
