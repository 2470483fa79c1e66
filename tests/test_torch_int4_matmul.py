"""The port's int4 matmul (B4's wrapper and plain version) against
ome_tpu.ops.int4_matmul.

* views: `flatten_qtensor` gives the reference's 2D views of every
  kernel-eligible leaf, byte for byte;
* dispatch: `int4_eligible` agrees with "the reference's
  `int4_matmul(..., interpret=True)` is not None" on the reference's
  own fallback cases (tests/test_int4_matmul.py) and on every leaf of a
  kernel-eligible config at m in {1, 5, 16, 256, 257}. The reference
  decides before it runs its kernel, so the sweep stubs the kernel out;
* numerics: `int4_matmul_ref` against the reference kernel run in
  interpret mode on the CPU, with fp32 output, at the gate layout, a
  ragged batch and a wk-shaped N. Both compute bf16 x bf16 products in
  fp32 and differ only in summation order: tolerance 1e-5 of max |y|;
* no fallback: a tensor on the CPU runs the plain version; a CUDA
  tensor of a shape the kernel does not take raises before anything is
  built (checked without a card through a tensor that reports
  `is_cuda`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu.ops import int4_matmul as jint4
from ome_tpu_torch.models import quant
from ome_tpu_torch.models.params import from_jax_params, to_numpy
from ome_tpu_torch.ops import flash, int4_matmul

RTOL_OF_MAX = 1e-5
ELIGIBLE = ("wq", "wk", "wv", "w_gate", "w_up")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def int4_layer():
    """Layer 0 of an int4-quantized kernel-eligible config (hidden 1024,
    FFN 1024, head_dim 128, GQA 8/2: wk/wv have N = 256), as the
    reference's QTensors and the port's."""
    cfg = jax_tiny().replace(hidden_size=1024, intermediate_size=1024,
                             num_layers=2, num_heads=8, num_kv_heads=2,
                             head_dim=128, dtype=jnp.float32)
    q4 = quant_np(jllama.init_params(jax.random.PRNGKey(0), cfg), "int4")
    jlayer = {k: jax.tree.map(lambda a: a[0], v)
              for k, v in q4["layers"].items()}
    tlayer = {k: v[0] for k, v in
              from_jax_params(q4, "cpu")["layers"].items()}
    return jlayer, tlayer


def quant_np(params, mode):
    return jax.tree.map(np.asarray, jquant.quantize_params(params,
                                                            mode=mode))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jqt(qt):
    return jax.tree.map(jnp.asarray, qt)


def test_flatten_views_equal_reference(int4_layer):
    jlayer, tlayer = int4_layer
    for name in ELIGIBLE:
        ref = jint4.flatten_qtensor(_jqt(jlayer[name]))
        got = int4_matmul.flatten_qtensor(tlayer[name])
        assert ref is not None and got is not None, name
        assert got[2:] == ref[2:], name
        np.testing.assert_array_equal(to_numpy(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(to_numpy(got[1]), np.asarray(ref[1]))
    # wo stays int8 under int4 and never flattens
    assert tlayer["wo"].bits == 8
    assert int4_matmul.flatten_qtensor(tlayer["wo"]) is None


def _reference_takes(x_shape, jqt, monkeypatch) -> bool:
    """Whether the reference's dispatch takes the kernel branch, with
    the kernel itself stubbed out (it decides before it runs)."""
    def stub(x2, qp2, s2, gsize, bkp, bn, out_dtype, interpret=False):
        return jnp.zeros((x2.shape[0], qp2.shape[1]), out_dtype)
    monkeypatch.setattr(jint4, "_mm4", stub)
    return jint4.int4_matmul(jnp.zeros(x_shape, jnp.float32), jqt,
                             interpret=True) is not None


def _both_sides(w, axes, group, mode="int4"):
    wj = jnp.asarray(w)
    if mode == "int4":
        jqt = jquant.quantize_tensor_int4(wj, axes, group=group)
    else:
        jqt = jquant.quantize_tensor(wj, axes)
    tqt = from_jax_params({"w": jax.tree.map(np.asarray, jqt)}, "cpu")["w"]
    return jqt, tqt


def test_dispatch_matches_reference_fallback_cases(monkeypatch):
    rng = np.random.default_rng(1)
    cases = []
    # wo layout [H, Dh, D]: the pack axis sits under H
    jqt, tqt = _both_sides(rng.standard_normal((8, 128, 256), np.float32),
                           (1, 0), 128)
    cases.append(((16, 8 * 128), jqt, tqt, False))
    # K = 192, group 64: K/2 is not a multiple of G
    jqt, tqt = _both_sides(rng.standard_normal((192, 256), np.float32),
                           (0,), 64)
    cases.append(((4, 192), jqt, tqt, False))
    # m = 512 > MAX_M, and the same leaf at m = 4
    jqt, tqt = _both_sides(rng.standard_normal((1024, 256), np.float32),
                           (0,), 128)
    cases += [((512, 1024), jqt, tqt, False), ((4, 1024), jqt, tqt, True),
              ((4, 512), jqt, tqt, False)]
    # an int8 leaf never routes to the kernel
    jqt, tqt = _both_sides(rng.standard_normal((1024, 256), np.float32),
                           (0,), 128, mode="int8")
    cases.append(((4, 1024), jqt, tqt, False))
    for x_shape, jqt, tqt, want in cases:
        assert _reference_takes(x_shape, jqt, monkeypatch) is want
        assert int4_matmul.int4_eligible(x_shape, tqt) is want


@pytest.mark.parametrize("m", [1, 5, 16, 256, 257])
def test_dispatch_matches_reference_on_every_leaf(int4_layer, m,
                                                  monkeypatch):
    jlayer, tlayer = int4_layer
    for name, tqt in tlayer.items():
        if not isinstance(tqt, quant.QTensor):
            continue
        K = tqt.shape[0] if name != "wo" else tqt.shape[0] * tqt.shape[1]
        for x_shape in ((m, K), (1, m, K)):
            want = _reference_takes(x_shape, _jqt(jlayer[name]),
                                    monkeypatch)
            assert want is (name in ELIGIBLE and m <= 256), (name, m)
            assert int4_matmul.int4_eligible(x_shape, tqt) is want


@pytest.mark.parametrize("m,n,seed", [(16, 512, 0), (5, 256, 2),
                                      (8, 256, 4)],
                         ids=["gate", "ragged", "wk"])
def test_plain_version_matches_reference_kernel(m, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, 1024)).astype(np.float32)
    w = rng.standard_normal((1024, n)).astype(np.float32)
    jqt, tqt = _both_sides(w, (0,), 128)
    ref = np.asarray(jint4.int4_matmul(jnp.asarray(x), jqt, jnp.float32,
                                       interpret=True))
    got = int4_matmul.int4_matmul_ref(_t(x), tqt, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL_OF_MAX * np.abs(ref).max())
    # the plain version is x(bf16) @ dequant(bf16), products in fp32
    want = _t(x).bfloat16().float() @ tqt.dequant(torch.bfloat16).float()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=RTOL_OF_MAX * float(want.abs().max()))


def test_cpu_wrapper_is_the_plain_version(int4_layer):
    _, tlayer = int4_layer
    x = _t(np.random.default_rng(5).standard_normal((2, 3, 1024))
           .astype(np.float32))
    before = flash.LAUNCHES["int4_matmul"]
    for name in ("wq", "w_gate"):
        qt = tlayer[name]
        for dt in (torch.float32, torch.bfloat16):
            out = int4_matmul.int4_matmul(x, qt, dt)
            assert out.dtype == dt and out.shape == (2, 3, qt.size // 1024)
            torch.testing.assert_close(
                out, int4_matmul.int4_matmul_ref(x, qt, dt), rtol=0, atol=0)
    assert flash.LAUNCHES["int4_matmul"] == before  # no kernel launched
    # a leaf the kernel's layout does not cover raises on the CPU too
    with pytest.raises(ValueError, match="half-packed int4"):
        int4_matmul.int4_matmul(x, tlayer["w_down"])


def test_cuda_tensor_of_uncovered_shape_raises(int4_layer):
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    _, tlayer = int4_layer
    before = flash.LAUNCHES["int4_matmul"]
    x = torch.zeros(257, 1024).as_subclass(FakeCuda)   # m > MAX_M
    with pytest.raises(NotImplementedError, match="int4_eligible"):
        int4_matmul.int4_matmul(x, tlayer["w_gate"])
    x = torch.zeros(4, 1024).as_subclass(FakeCuda)     # an int8 leaf
    with pytest.raises(NotImplementedError, match="int4_eligible"):
        int4_matmul.int4_matmul(x, tlayer["w_down"])
    assert flash.LAUNCHES["int4_matmul"] == before
