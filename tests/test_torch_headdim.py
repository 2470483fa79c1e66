"""head_dim 96 and 256 in the port, on the CPU, against the JAX package.

The CUDA kernels take head_dim 64, 96, 128 and 256 (`flash._DIMS`);
the reference's Pallas kernels take multiples of 128 and its XLA path
the rest. Here, with seeded numpy inputs given to both packages in fp32
and a tolerance of 2e-4 (tests/test_ops.py's):

* the plain versions of B1 (decode, with window + softcap), B2 (causal
  prefill, a chunk from a base, window + softcap), B3 (paged decode over
  fp32 and int8 pools) and B5 (decode over an int8 cache) at D 96 and
  256 against `ome_tpu`'s attention and paged ops, which take their XLA
  path at these D; and the paged decode and verify under a sliding
  window (the port serves one-window models paged) against the JAX
  dense attention with that window;
* a tiny Phi-3-shaped model (head_dim 96, G 1, a window of 12 under
  prompts of up to 30 tokens) bridged with `from_jax_params`: logits
  within 2e-4 of the JAX forward, and greedy streams through the port's
  dense and paged engines equal to the JAX dense engine's;
* every head_dim from 8 to 512 is either in `flash._DIMS`, and then
  taken by `_check_cuda` and `check_paged_coverage`, or refused on a
  CUDA device when the model loads, with `head_dim` in the message —
  by `check_head_dim` and by `serve.load_engine` before any weight is
  read — while the CPU serves it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu.ops import flash as jflash
from ome_tpu.ops import paged as jpaged
from ome_tpu.ops.attention import attention as jax_attention
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models import llama
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.ops import flash, paged

ATOL = 2e-4
DIMS = (96, 256)
SLOTS, MAX_SEQ = 3, 64
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL)


# -- the kernels' plain versions against the JAX XLA path ----------------------


CASES = {
    # (B, Sq, S, H, K, positions, kv_len, window, softcap)
    "decode": (4, 1, 160, 4, 2, [[3], [70], [130], [159]],
               [4, 71, 131, 160], None, None),
    "decode_window_softcap": (4, 1, 160, 4, 4, [[3], [70], [130], [159]],
                              [4, 71, 131, 160], 48, 30.0),
    "prefill": (2, 40, 40, 4, 2, [list(range(40))] * 2, None, None, None),
    "chunk_from_base": (2, 24, 96, 2, 1,
                        [list(range(b, b + 24)) for b in (0, 70)],
                        [24, 94], None, None),
    "prefill_window_softcap": (2, 40, 40, 4, 2, [list(range(40))] * 2,
                               None, 16, 50.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("D", DIMS)
def test_flash_plain_matches_jax_xla(D, case):
    """B1 (Sq 1) and B2 (Sq > 1) through `flash.flash_attention`, whose
    CPU path is `flash_decode_ref` / `flash_prefill_ref`."""
    B, Sq, S, H, K, pos, kv_len, window, softcap = CASES[case]
    q, k, v = _arrays(D + len(case), (B, Sq, H, D), (B, S, K, D),
                      (B, S, K, D))
    pos = np.asarray(pos, np.int32)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    kw = dict(sliding_window=window, logit_softcap=softcap)
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        positions=jnp.asarray(pos),
                        kv_len=None if lens is None else jnp.asarray(lens),
                        backend="xla", **kw)
    out = flash.flash_attention(
        *map(torch.from_numpy, (q, k, v)), positions=torch.from_numpy(pos),
        kv_len=None if lens is None else torch.from_numpy(lens), **kw)
    assert out.shape == (B, Sq, H, D)
    _close(out, ref)


def _pool(seed, D, B=3, K=2, bs=16, M=4, N=14):
    rng = np.random.default_rng(seed)
    kp, vp = _arrays(seed, (N, bs, K, D), (N, bs, K, D))
    table = (rng.permutation(N - 1)[:B * M] + 1).reshape(B, M)
    return kp, vp, table.astype(np.int32)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
@pytest.mark.parametrize("D", DIMS)
def test_paged_plain_matches_jax_xla(D, pool):
    """B3 through `paged.paged_attention` (CPU: the gather path) and
    `paged.paged_flash_decode` (CPU: the kernel's plain version) against
    the JAX `paged_attention_xla`; int8 pools quantized once by the JAX
    quantizer and given to both."""
    kp, vp, table = _pool(D, D)
    (q,) = _arrays(D + 1, (3, 1, 4, D))
    lens = np.asarray([1, 30, 64], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    jks = jvs = None
    if pool == "int8":
        # an [N, bs, K, D] pool is a [B, S, K, D] slab with S = bs
        jk, jks = jflash.quantize_kv_block(jk)
        jv, jvs = jflash.quantize_kv_block(jv)
    ref = jpaged.paged_attention_xla(jnp.asarray(q), jk, jv,
                                     jnp.asarray(table), jnp.asarray(lens),
                                     logit_softcap=30.0, k_scale=jks,
                                     v_scale=jvs)
    tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))
    sc = {} if jks is None else dict(
        k_scale=torch.from_numpy(np.array(jks)),
        v_scale=torch.from_numpy(np.array(jvs)))
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(lens))
    _close(paged.paged_attention(*args, logit_softcap=30.0, **sc), ref)
    _close(paged.paged_flash_decode(*args, logit_softcap=30.0, **sc), ref)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("D", DIMS)
def test_quantized_decode_plain_matches_jax_xla(D, window):
    """B5's plain version against the JAX XLA attention over the
    dequantized cache (the JAX Pallas kernel declines D % 128 != 0; at
    D 256 it also runs, in interpret mode, and agrees)."""
    B, S, H, K = 3, 128, 8, 2
    q, k, v = _arrays(D + 2, (B, 1, H, D), (B, S, K, D), (B, S, K, D))
    kq, ks = jflash.quantize_kv_block(jnp.asarray(k))
    vq, vs = jflash.quantize_kv_block(jnp.asarray(v))
    lens = np.asarray([1, 70, 128], np.int32)
    pos = (lens - 1)[:, None]

    def deq(x, s):
        return x.astype(jnp.float32) * jnp.swapaxes(s, -1, -2)[..., None]
    ref = jax_attention(jnp.asarray(q), deq(kq, ks), deq(vq, vs),
                        positions=jnp.asarray(pos),
                        kv_len=jnp.asarray(lens), sliding_window=window,
                        logit_softcap=30.0, backend="xla")
    targs = [torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)]
    out = flash.flash_decode_quantized(
        torch.from_numpy(q), *targs, torch.from_numpy(pos),
        torch.from_numpy(lens), sliding_window=window, logit_softcap=30.0)
    _close(out, ref)
    if D % 128 == 0:
        pallas = jflash.flash_decode_quantized(
            jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(pos),
            jnp.asarray(lens), sliding_window=window, logit_softcap=30.0,
            interpret=True)
        _close(out, pallas)
    else:
        assert jflash.flash_decode_quantized(
            jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(pos),
            jnp.asarray(lens), sliding_window=window,
            interpret=True) is None


def _dense_rows(pool, table):
    """Each slot's chain as a dense [B, M bs, K, D] cache."""
    B, M = table.shape
    return pool[table].reshape(B, M * pool.shape[1], *pool.shape[2:])


@pytest.mark.parametrize("Sq", [1, 3])
@pytest.mark.parametrize("D", DIMS)
def test_paged_window_matches_dense_window(D, Sq):
    """A sliding window over the paged pool (decode, Sq 1, through
    `paged_attention` and `paged_flash_decode`; the verify's Sq 3
    through `paged_attention_multi`) equals the JAX dense attention with
    that window over each slot's chain."""
    kp, vp, table = _pool(D + Sq, D)
    (q,) = _arrays(D + 5, (3, Sq, 4, D))
    window = 20
    last = np.asarray([4, 33, 63], np.int32)
    pos = last[:, None] - (Sq - 1) + np.arange(Sq, dtype=np.int32)[None]
    ref = jax_attention(jnp.asarray(q), jnp.asarray(_dense_rows(kp, table)),
                        jnp.asarray(_dense_rows(vp, table)),
                        positions=jnp.asarray(pos),
                        kv_len=jnp.asarray(last + 1), sliding_window=window,
                        logit_softcap=30.0, backend="xla")
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table))
    kw = dict(logit_softcap=30.0, sliding_window=window)
    if Sq == 1:
        lens = torch.from_numpy(last + 1)
        _close(paged.paged_attention(*args, lens, **kw), ref)
        _close(paged.paged_flash_decode(*args, lens, **kw), ref)
    else:
        _close(paged.paged_attention_multi(*args, torch.from_numpy(pos),
                                           **kw), ref)


# -- a Phi-3-shaped model ------------------------------------------------------


# Phi-3-mini-4k's shape at tiny widths: head_dim 96 (hidden / heads),
# G 1, a sliding window shorter than the prompts
HF_PHI3 = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
           "vocab_size": 256, "hidden_size": 192, "num_hidden_layers": 2,
           "num_attention_heads": 2, "num_key_value_heads": 2,
           "intermediate_size": 128, "max_position_embeddings": 128,
           "sliding_window": 12, "rope_theta": 10000.0,
           "rope_scaling": None, "rms_norm_eps": 1e-5,
           "tie_word_embeddings": False}


@pytest.fixture(scope="module")
def phi3():
    jcfg = JaxConfig.from_hf_config(HF_PHI3).replace(dtype=jnp.float32)
    tcfg = ModelConfig.from_hf_config(HF_PHI3).replace(dtype=torch.float32)
    assert tcfg.head_dim == jcfg.head_dim == 96
    assert tcfg.sliding_window == 12 and tcfg.num_heads == tcfg.num_kv_heads
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.PRNGKey(5), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, \
        from_jax_params(tree, "cpu")


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(3, 256, (B, S),
                                                dtype=np.int32)


def test_phi3_logits_match_jax_forward(phi3):
    """Prefill logits over a prompt past the window, then per-slot
    decode steps over the dense cache, against the JAX forward."""
    jcfg, jp, tcfg, tp = phi3
    toks = _tokens(1, 2, 30)
    ref, _ = jllama.forward(jp, jcfg, jnp.asarray(toks))
    out, _ = llama.forward(tp, tcfg, torch.from_numpy(toks))
    _close(out, ref)
    jc = jllama.KVCache.create(jcfg, 2, 48)
    tc = llama.KVCache.create(tcfg, 2, 48, device="cpu")
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), cache=jc)
    _, tc = llama.forward(tp, tcfg, torch.from_numpy(toks), cache=tc)
    lengths = np.asarray([30, 9], np.int32)
    step = _tokens(2, 2, 1)
    for _ in range(3):
        jc = jllama.KVCache(k=jc.k, v=jc.v, index=jnp.asarray(lengths))
        tc = llama.KVCache(k=tc.k, v=tc.v, index=torch.from_numpy(lengths))
        ref, jc = jllama.forward(jp, jcfg, jnp.asarray(step), cache=jc)
        out, tc = llama.forward(tp, tcfg, torch.from_numpy(step), cache=tc)
        _close(out, ref)
        step = np.asarray(ref)[:, -1].argmax(-1).astype(np.int32)[:, None]
        lengths = lengths + 1


def _streams(eng, prompts, steps):
    state = eng.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, n, bucket = eng.prefill(ids, 0.0, 0, 1.0)
        state = eng.insert(state, kv, slot, n, tok, bucket)
        out.append([int(tok)])
    for _ in range(steps - 1):
        state, toks = eng.decode(state, *GREEDY)
        for slot, t in enumerate(np.asarray(toks)[:len(prompts)]):
            out[slot].append(int(t))
    return out


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_phi3_streams_match_jax_dense_engine(phi3, cache):
    """Greedy streams of prompts longer than the window: the port's
    dense engine and its paged one (the reference serves this model
    from the dense cache only) against the JAX dense engine."""
    jcfg, jp, tcfg, tp = phi3
    jeng = JaxEngine(jp, jcfg, max_slots=SLOTS, max_seq=MAX_SEQ)
    kw = dict(kv_block=16, kv_blocks=20) if cache == "paged" else {}
    teng = InferenceEngine(tp, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                           device="cpu", **kw)
    prompts = [list(map(int, _tokens(s, 1, n)[0]))
               for s, n in ((3, 5), (4, 17), (5, 30))]
    assert _streams(teng, prompts, 14) == _streams(jeng, prompts, 14)
    if cache == "paged":
        for slot in range(SLOTS):
            teng.free_slot(slot)
        assert teng.kv_conservation()[0]


# -- which head_dims the card takes --------------------------------------------


def test_every_head_dim_is_taken_or_refused_by_name():
    """D 8 to 512: a taken D passes the wrappers' checks; any other is
    refused on CUDA by `check_head_dim` (the engine's construction
    check) naming head_dim, and passes on the CPU."""
    taken = []
    for D in range(8, 513):
        q = torch.zeros(1, 1, 2, D)
        k = torch.zeros(1, 4, 2, D)
        if D in flash._DIMS:
            taken.append(D)
            flash.check_head_dim(D, "cuda")
            flash.check_head_dim(D, torch.device("cuda", 0))
            flash._check_cuda("flash_decode", q, k, k)
            flash.check_paged_coverage(64, D, 32, 32)
            continue
        with pytest.raises(NotImplementedError, match=f"head_dim {D}"):
            flash.check_head_dim(D, "cuda")
        with pytest.raises(NotImplementedError, match="head_dim"):
            flash._check_cuda("flash_decode", q, k, k)
        with pytest.raises(ValueError, match="head_dim"):
            flash.check_paged_coverage(64, D, 32, 32)
        flash.check_head_dim(D, "cpu")
    assert taken == [64, 96, 128, 256]


@pytest.mark.parametrize("random_weights", [True, False])
@pytest.mark.parametrize("D", [80, 112, 160, 192])
def test_serve_refuses_head_dim_before_loading(tmp_path, monkeypatch, D,
                                               random_weights):
    """`serve` on a CUDA device exits naming head_dim before any weight
    is made or read, from random weights or a checkpoint (the device
    resolution is stubbed: no card here)."""
    from ome_tpu_torch import device as device_mod
    from ome_tpu_torch.models import checkpoint, params
    hf = dict(HF_PHI3, hidden_size=2 * D)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda d=None: torch.device("cuda"))

    def no_weights(*a, **kw):
        raise AssertionError("weights loaded before the head_dim check")
    monkeypatch.setattr(params, "init_params", no_weights)
    monkeypatch.setattr(checkpoint, "load_params", no_weights)
    args = serve.build_parser().parse_args(
        ["--model-dir", str(tmp_path)]
        + (["--random-weights"] if random_weights else []))
    with pytest.raises(SystemExit, match=f"head_dim {D}"):
        serve.load_engine(args)


def test_cpu_engine_serves_any_head_dim(phi3):
    """The CPU runs the plain versions: a head_dim the card refuses
    builds and decodes there."""
    jcfg, _, tcfg, _ = phi3
    cfg = tcfg.replace(head_dim=40)
    from ome_tpu_torch.models.params import init_params
    gen = torch.Generator().manual_seed(0)
    eng = InferenceEngine(init_params(cfg, gen, torch.device("cpu")), cfg,
                          max_slots=SLOTS, max_seq=MAX_SEQ, device="cpu")
    out = _streams(eng, [[5, 6, 7]], 3)
    assert len(out[0]) == 3


def test_launch_geometry_follows_head_dim():
    """D 256 halves the resident decode blocks per SM (64 KB bf16 ring
    stages; 87 KB of fp32 scalar tiles); the other D keep D 128's."""
    for D in (64, 96, 128):
        assert flash.decode_blocks_per_sm(True, D) == flash.TC_BLOCKS_PER_SM
        assert flash.decode_blocks_per_sm(False, D) == \
            flash.SCALAR_BLOCKS_PER_SM
    assert flash.decode_blocks_per_sm(True, 256) == 1
    assert flash.decode_blocks_per_sm(False, 256) == 2
    grid, units = flash.decode_grid(8, 8, 4096, 132, head_dim=256)
    assert grid == min(132, units)
    plan = flash.decode_plan([0] * 8, [4096] * 8, 8, 4096, 132,
                             head_dim=256)
    assert plan.grid == 132 and plan.n_units == units
    # the walk itself does not depend on head_dim
    assert plan.windows == flash.decode_plan([0] * 8, [4096] * 8, 8, 4096,
                                             132).windows
