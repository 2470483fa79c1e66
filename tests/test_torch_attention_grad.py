"""Attention's gradient in the port against the JAX package's.

On the CPU the port's training differentiates the plain attention
(`ops/attention.py::attention` -> `xla_attention`) with autograd; the
reference differentiates its XLA attention with jax.grad. dq, dk and dv
of the same loss agree within 1e-5 at G 1, 2, 4 and 7, with a sliding
window and with softcap 30. The plain version of B2's backward
(`flash.flash_prefill_bwd_ref`, what chip_smoke holds the CUDA kernel
against) agrees too. And the CUDA path's refusals (`check_prefill_grad`,
which `flash_attention` runs under grad on a CUDA tensor) name a decode,
fp32 sinks and each shape the backward kernels do not take; bf16 sinks
are taken. chip_smoke's
planted faults (a plain backward with P or dS rounded to bf16 or without
the softcap's derivative; a backward that swaps dk and dv) do what its
checks on the card rely on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.ops.attention import attention as jattention
from ome_tpu_torch.ops import flash
from ome_tpu_torch.ops.attention import attention

ATOL = 1e-5

CASES = [  # (H, K, window, softcap)
    (4, 4, None, None), (8, 4, None, None), (8, 2, None, None),
    (7, 1, None, None), (8, 2, 5, None), (8, 4, None, 30.0),
    (14, 2, 6, 30.0)]


def _inputs(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                      (B, S, H, D))]


def _jax_grads(q, k, v, dout, window, softcap):
    B, S = q.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def loss(q, k, v):
        out = jattention(q, k, v, positions=pos, sliding_window=window,
                         logit_softcap=softcap, backend="xla")
        return jnp.sum(out * dout)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("H,K,window,softcap", CASES,
                         ids=[f"H{h}K{k}w{w}c{c}" for h, k, w, c in CASES])
def test_plain_grads_match_jax(H, K, window, softcap):
    B, S, D = 2, 12, 16
    q, k, v, dout = _inputs(H * 10 + K, B, S, H, K, D)
    want = _jax_grads(q, k, v, dout, window, softcap)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    out = attention(tq, tk, tv, positions=pos, sliding_window=window,
                    logit_softcap=softcap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    ref = flash.flash_prefill_bwd_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(dout), D ** -0.5, softcap, window)
    for name, g, r, w in zip("qkv", got, ref, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL,
                                   err_msg=f"d{name} autograd")
        np.testing.assert_allclose(r.numpy(), w, atol=ATOL,
                                   err_msg=f"d{name} flash_prefill_bwd_ref")
        assert r.dtype == torch.float32


def test_cuda_refusals_name_the_case():
    B, S, H, K, D = 1, 8, 4, 2, 64
    q, k, v = (torch.zeros(B, S, n, D) for n in (H, K, K))
    pos = torch.arange(S)[None]
    flash.check_prefill_grad(q, k, v, pos)  # the training shape: taken
    # sinks are taken in bf16 (their gradient comes from the forward's
    # lse), refused in fp32
    flash.check_prefill_grad(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos,
                             sinks=torch.zeros(H))
    cases = [
        ((q[:, :1], k, v, pos[:, :1]), {}, "a decode"),
        ((q, k, v, pos), {"sinks": torch.zeros(H)}, "attention sinks"),
        ((q[..., :48], k[..., :48], v[..., :48], pos), {}, "head_dim 48"),
        ((q.half(), k.half(), v.half(), pos), {}, "dtype torch.float16"),
        ((q[:, :4], k, v, pos[:, :4]), {}, "a query chunk of 4 rows"),
        ((q, k, v, pos), {"kv_len": torch.full((B,), S)}, "with kv_len"),
        ((q, k, v, pos + 3), {}, "positions that do not start at 0"),
        ((q[:, :, :3], k, v, pos), {}, "H=3 over K=2"),
    ]
    for args, kw, words in cases:
        with pytest.raises(NotImplementedError, match=words):
            flash.check_prefill_grad(*args, **kw)


def test_the_cpu_path_never_takes_the_function():
    """On CPU tensors `flash_attention` differentiates the plain
    versions, decode and sinks included; the kernel's Function is for
    CUDA tensors."""
    B, S, H, K, D = 1, 6, 4, 2, 16
    q, k, v = (torch.randn(B, S, n, D, requires_grad=True)
               for n in (H, K, K))
    pos = torch.arange(S)[None]
    out = flash.flash_attention(q, k, v, positions=pos,
                                sinks=torch.zeros(H))
    assert out.grad_fn is not None
    assert "FlashPrefill" not in type(out.grad_fn).__name__
    before = dict(flash.LAUNCHES)
    out.sum().backward()
    assert flash.LAUNCHES == before
    assert q.grad is not None and k.grad is not None


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FAULTS = (None, "P in bf16", "dS in bf16", "no softcap derivative")


@pytest.mark.parametrize("fault", FAULTS, ids=[str(f) for f in FAULTS])
def test_planted_backward_faults_fall_outside_the_card_tolerance(fault):
    """chip_smoke's hand-written plain backward (`_bwd_planted`) with no
    fault agrees with `flash_prefill_bwd_ref` within the card's bf16
    tolerance, and each planted fault falls outside it, at Gemma 2's
    softcap 50 with logits that reach the cap and a window (bf16
    inputs)."""
    cs = _chip_smoke()
    assert fault is None or fault in cs.BWD_FAULTS
    B, S, H, K, D, cap, window = 2, 96, 4, 2, 64, 50.0, 40
    g = torch.Generator().manual_seed(3)
    q = (torch.randn(B, S, H, D, generator=g) * 10).bfloat16()
    k, v = (torch.randn(B, S, K, D, generator=g).bfloat16()
            for _ in range(2))
    dout = torch.randn(B, S, H, D, generator=g).bfloat16()
    ref = flash.flash_prefill_bwd_ref(q, k, v, dout, D ** -0.5, cap, window)
    got = cs._bwd_planted(torch, q, k, v, dout, D ** -0.5, cap, window,
                          fault)
    worst = max(cs._rel_errs(torch, got, ref).values())
    tol = cs.BWD_REL_TOL["bf16"]
    if fault is None:
        assert worst < tol / 10
    else:
        assert worst > 2 * tol


def test_swapped_backward_swaps_dk_and_dv():
    """The planted fault of chip_smoke's identity check: attention whose
    backward hands dk back as dv and dv as dk, the forward unchanged (on
    the CPU `FlashPrefill` runs the plain versions)."""
    cs = _chip_smoke()
    B, S, H, K, D = 2, 16, 4, 2, 64
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(B, S, n, D, generator=g, requires_grad=True)
               for n in (H, K, K))
    pos = torch.arange(S)[None].expand(B, S)
    dout = torch.randn(B, S, H, D, generator=g)
    out = cs._swapped_flash_attention(torch)(q, k, v, positions=pos)
    want = flash.FlashPrefill.apply(q, k, v, D ** -0.5, None, None)
    assert torch.equal(out, want)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    rq, rk, rv = torch.autograd.grad(want, (q, k, v), dout)
    assert torch.equal(dq, rq) and torch.equal(dk, rv) and \
        torch.equal(dv, rk)
    assert not torch.equal(dk, rk)
