"""Attention parity: the port's plain versions against the JAX package.

The same numpy inputs (seeded) go through `ome_tpu.ops.attention.
attention` — with `backend="xla"` and with the Pallas kernels in
interpret mode (`backend="pallas_interpret"`), as tests/test_ops.py runs
them — and through the port on the CPU:

* `ome_tpu_torch.ops.attention.attention` (the plain `xla_attention`
  path the port takes for CPU tensors) against the JAX xla backend;
* `ome_tpu_torch.ops.flash.flash_attention`, which on CPU tensors runs
  the kernels' plain versions (`flash_decode_ref`, `flash_prefill_ref`),
  against the JAX Pallas kernels.

Cases: decode with per-slot cache lengths (0 included, as a free
engine slot decodes), causal prefill, chunked prefill into a longer
cache, sliding window with softcap, GQA groups 1, 2 and 4, bf16 and
f32. Tolerance 2e-4 in f32 and 2e-2 in bf16 (tests/test_ops.py's).
With attention sinks (gpt-oss), which the JAX package computes on its
XLA path only, both the port's `xla_attention` and the kernels' plain
versions are held against that path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.ops.attention import attention as jax_attention
from ome_tpu_torch.ops import flash
from ome_tpu_torch.ops.attention import attention

ATOL = {"bfloat16": 2e-2, "float32": 2e-4}
JNP = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TORCH = {"bfloat16": torch.bfloat16, "float32": torch.float32}
H, D = 8, 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Skv, K, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]
    # round through the working dtype once so both packages see the
    # same values
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(TORCH[dtype]) for a in jx]
    return jx, tx


def _compare(case, backend):
    dtype = case["dtype"]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        case["seed"], case["B"], case["Sq"], case["Skv"], case["K"], dtype)
    pos = np.array(case["positions"], np.int32)
    kv_len = case.get("kv_len")
    kw = dict(sliding_window=case.get("window"),
              logit_softcap=case.get("softcap"))
    ref = jax_attention(
        jq, jk, jv, positions=jnp.asarray(pos),
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
        backend=backend, **kw)
    tpos = torch.from_numpy(pos)
    tlen = None if kv_len is None else torch.tensor(kv_len,
                                                    dtype=torch.int32)
    if backend == "xla":
        out = attention(tq, tk, tv, positions=tpos, kv_len=tlen, **kw)
    else:
        out = flash.flash_attention(tq, tk, tv, positions=tpos,
                                    kv_len=tlen, **kw)
    assert out.dtype == TORCH[dtype] and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype])


def _decode(seed, K, dtype, lengths=(0, 5, 128, 255), **kw):
    lengths = np.asarray(lengths)
    # the engine's decode: slot b writes row lengths[b] and attends
    # rows [0, lengths[b]] (a free slot at length 0 attends one row)
    return dict(seed=seed, B=len(lengths), Sq=1, Skv=256, K=K,
                dtype=dtype, positions=lengths[:, None],
                kv_len=list(lengths + 1), **kw)


def _prefill(seed, K, dtype, B=2, S=64, **kw):
    pos = np.broadcast_to(np.arange(S), (B, S))
    return dict(seed=seed, B=B, Sq=S, Skv=S, K=K, dtype=dtype,
                positions=pos, **kw)


def _chunked(seed, dtype):
    base = np.asarray([0, 64])
    Sq = 32
    return dict(seed=seed, B=2, Sq=Sq, Skv=128, K=4, dtype=dtype,
                positions=base[:, None] + np.arange(Sq)[None, :],
                kv_len=list(base + Sq))


CASES = {
    "decode_g1_f32": _decode(0, 8, "float32"),
    "decode_g2_bf16": _decode(1, 4, "bfloat16"),
    "decode_g4_f32": _decode(2, 2, "float32"),
    "decode_g4_bf16": _decode(3, 2, "bfloat16"),
    "prefill_g1_bf16": _prefill(4, 8, "bfloat16"),
    "prefill_g2_f32": _prefill(5, 4, "float32"),
    "prefill_g4_f32": _prefill(6, 2, "float32"),
    "prefill_g4_bf16": _prefill(7, 2, "bfloat16"),
    "chunked_bf16": _chunked(8, "bfloat16"),
    "chunked_f32": _chunked(9, "float32"),
    "decode_window_softcap": _decode(10, 4, "bfloat16",
                                     lengths=(3, 130, 200, 255),
                                     window=64, softcap=30.0),
    "prefill_window_softcap": _prefill(11, 8, "bfloat16", window=16,
                                       softcap=50.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_attention_matches_jax_xla(name):
    _compare(CASES[name], "xla")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_plain_versions_match_jax_pallas(name):
    _compare(CASES[name], "pallas_interpret")


SINK_CASES = {
    "decode_g4_window_f32": _decode(20, 2, "float32",
                                    lengths=(0, 3, 130, 255), window=64),
    "decode_g8_bf16": _decode(21, 1, "bfloat16"),
    "prefill_g4_window_f32": _prefill(22, 2, "float32", window=16),
    "prefill_g8_window_bf16": _prefill(23, 1, "bfloat16", window=16),
    "chunked_f32": _chunked(24, "float32"),
    "prefill_g2_softcap_f32": _prefill(25, 4, "float32", softcap=30.0),
}


@pytest.mark.parametrize("path", ["xla", "kernel_plain"])
@pytest.mark.parametrize("name", sorted(SINK_CASES))
def test_sink_attention_matches_jax_xla(name, path):
    case = SINK_CASES[name]
    dtype = case["dtype"]
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        case["seed"], case["B"], case["Sq"], case["Skv"], case["K"], dtype)
    sinks = np.random.default_rng(case["seed"] + 1).standard_normal(
        H).astype(np.float32) * 2.0
    pos = np.array(case["positions"], np.int32)
    kv_len = case.get("kv_len")
    kw = dict(sliding_window=case.get("window"),
              logit_softcap=case.get("softcap"))
    ref = jax_attention(
        jq, jk, jv, positions=jnp.asarray(pos),
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
        backend="xla", sinks=jnp.asarray(sinks), **kw)
    tpos = torch.from_numpy(pos)
    tlen = None if kv_len is None else torch.tensor(kv_len,
                                                    dtype=torch.int32)
    fn = attention if path == "xla" else flash.flash_attention
    out = fn(tq, tk, tv, positions=tpos, kv_len=tlen,
             sinks=torch.from_numpy(sinks), **kw)
    assert out.dtype == TORCH[dtype] and out.shape == tq.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=ATOL[dtype])


def test_flash_refs_empty_window_is_zero_not_nan():
    # the kernels' contract: an empty window yields 0 (finite M_INIT,
    # l clamped at 1e-30), never NaN
    q = torch.randn(2, 1, H, D)
    k = torch.randn(2, 64, 2, D)
    out = flash.flash_decode_ref(q, k, k, torch.tensor([0, 10]),
                                 torch.tensor([0, 10]), D ** -0.5)
    assert torch.isfinite(out).all()
    assert out.abs().max() == 0
    # with sinks too: the sink takes all the mass and is dropped
    out = flash.flash_decode_ref(q, k, k, torch.tensor([0, 10]),
                                 torch.tensor([0, 10]), D ** -0.5,
                                 sinks=torch.randn(H))
    assert torch.isfinite(out).all()
    assert out.abs().max() == 0


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    # the dispatch sends CUDA tensors to the kernels only; shapes the
    # kernels do not take raise instead of falling back. Checked with
    # a tensor subclass that reports is_cuda, so no card is needed.
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    q = torch.randn(1, 4, H, 16).as_subclass(FakeCuda)
    k = torch.randn(1, 4, 2, 16).as_subclass(FakeCuda)
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="head_dim"):
        attention(q, k, k, positions=pos)
    with pytest.raises(NotImplementedError, match="non-causal"):
        attention(q, k, k, positions=None)
    # sinks (gpt-oss) go to the kernels too, which take them: a
    # head_dim they do not take raises as it does without sinks, and
    # the sinks reach the kernels' entry point unchanged
    sinks = torch.randn(H)
    with pytest.raises(NotImplementedError, match="head_dim"):
        attention(q, k, k, positions=pos, sinks=sinks)
    seen = {}

    def kernels(*a, **kw):
        seen.update(kw)
        return a[0]
    monkeypatch.setattr(flash, "flash_attention", kernels)
    attention(q, k, k, positions=pos, sinks=sinks)
    assert seen["sinks"] is sinks
