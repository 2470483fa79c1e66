"""Engine parity: greedy token streams of the port equal the JAX engine's.

`ome_tpu.engine.core.InferenceEngine` and the port's InferenceEngine
run the same weights (the JAX init, bridged with `from_jax_params`) on
the same prompts, in float32 on the CPU, through the same script of
prefill / insert / decode calls. Greedy streams must be IDENTICAL.

A greedy token flips only where the top two logits nearly tie, and then
on summation order alone; before comparing, each test asserts that the
JAX run's top-1/top-2 logit margin is above 1e-4 at every compared
step, so a match is evidence and a tie cannot hide a fault. (The seeds
below were chosen so that it holds.)

Covered: 3 prompts in 4 slots for 16 steps with one slot freed and
reused mid-run; a prefix-cache suffix hit (the second prompt reuses the
first one's cached KV and prefills only its suffix, from a nonzero base
position) against a cold prefill; and the port's Scheduler at pipeline
depth 0 and 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

SLOTS, MAX_SEQ = 4, 128
MARGIN = 1e-4
PC_BYTES = 64 << 20
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env():
    jcfg = jax_tiny().replace(dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32)
    jeng = JaxEngine(jparams, jcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                     prefix_cache_bytes=PC_BYTES)
    logits_fn = jax.jit(functools.partial(jllama.forward, cfg=jcfg))

    def port(prefix_cache_bytes=PC_BYTES):
        return InferenceEngine(tparams, tcfg, max_slots=SLOTS,
                               max_seq=MAX_SEQ,
                               prefix_cache_bytes=prefix_cache_bytes,
                               device="cpu")
    return dict(jeng=jeng, jparams=jparams, logits_fn=logits_fn,
                port=port, cfg=jcfg)


def _prompt(seed, n):
    # ids from 3 up: clear of the byte tokenizer's pad/bos/eos
    return [int(t) for t in
            np.random.default_rng(seed).integers(3, 512, n)]


def _margin(logits) -> np.ndarray:
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _check_prompt_margin(env, ids):
    logits, _ = env["logits_fn"](env["jparams"],
                                 tokens=jnp.asarray([ids], jnp.int32))
    m = _margin(logits[0, -1])
    assert m > MARGIN, f"near-tie at the first token ({m:.2e})"


def _check_decode_margin(env, state, active):
    cache = jllama.KVCache(k=state.k, v=state.v, index=state.lengths)
    logits, _ = env["logits_fn"](env["jparams"],
                                 tokens=state.tokens[:, None], cache=cache)
    m = _margin(logits[:, -1])
    for slot in active:
        assert m[slot] > MARGIN, f"near-tie in slot {slot} ({m[slot]:.2e})"


def _admit(engines, states, slot, ids):
    """Prefill `ids` on both engines and insert into `slot`; returns the
    two first tokens."""
    toks = []
    for i, eng in enumerate(engines):
        tok, kv, true_len, bucket = eng.prefill(ids, 0.0, 0, 1.0)
        states[i] = eng.insert(states[i], kv, slot, true_len, tok, bucket)
        toks.append(tok)
    return toks


def test_engine_greedy_streams_identical(env):
    jeng, teng = env["jeng"], env["port"]()
    engines = (jeng, teng)
    states = [jeng.new_state(), teng.new_state()]
    prompts = [_prompt(10, 12), _prompt(11, 45), _prompt(12, 90)]
    streams = {0: [[], []], 1: [[], []], 2: [[], []]}
    for slot, ids in enumerate(prompts):
        _check_prompt_margin(env, ids)
        for i, t in enumerate(_admit(engines, states, slot, ids)):
            streams[slot][i].append(t)
    active = [0, 1, 2]
    reuse = _prompt(13, 30)
    for step in range(16):
        if step == 6:
            # slot 1 finishes; slot 1 is reused by a new prompt
            for eng in engines:
                eng.free_slot(1)
            _check_prompt_margin(env, reuse)
            streams[3] = [[], []]
            for i, t in enumerate(_admit(engines, states, 1, reuse)):
                streams[3][i].append(t)
        _check_decode_margin(env, states[0], active)
        owner = {0: 0, 1: 3 if step >= 6 else 1, 2: 2}
        states[0], jt = jeng.decode(states[0], *GREEDY)
        states[1], tt = teng.decode(states[1], *GREEDY)
        jt, tt = np.asarray(jt), np.asarray(tt)
        for slot in active:
            streams[owner[slot]][0].append(int(jt[slot]))
            streams[owner[slot]][1].append(int(tt[slot]))
    for key, (jax_stream, port_stream) in streams.items():
        assert port_stream == jax_stream, f"stream {key} differs"
    assert len(streams[0][0]) == 17 and len(streams[3][0]) == 11
    np.testing.assert_array_equal(states[1].lengths.numpy(),
                                  np.asarray(states[0].lengths))


def _greedy_stream(eng, ids, n, check=None):
    """Single-request greedy stream of `n` tokens through `eng` (slot
    0 of a fresh state)."""
    state = eng.new_state()
    tok, kv, true_len, bucket = eng.prefill(ids, 0.0, 0, 1.0)
    state = eng.insert(state, kv, 0, true_len, tok, bucket)
    out = [tok]
    for _ in range(n - 1):
        if check is not None:
            check(state)
        state, toks = eng.decode(state, *GREEDY)
        out.append(int(np.asarray(toks)[0]))
    return out


def test_prefix_cache_suffix_hit_matches_cold_prefill(env):
    jeng, teng, cold = env["jeng"], env["port"](), env["port"](0)
    first = _prompt(20, 70)
    second = first[:64] + _prompt(21, 20)
    _check_prompt_margin(env, second)
    hits = (jeng.prefix_cache.hits, teng.prefix_cache.hits)
    for eng in (jeng, teng):
        eng.prefill(first, 0.0, 0, 1.0)  # caches the first prompt's KV

    def check(state):
        _check_decode_margin(env, state, [0])
    ref = _greedy_stream(jeng, second, 8, check=check)
    assert jeng.prefix_cache.hits == hits[0] + 1
    hit = _greedy_stream(teng, second, 8)
    assert teng.prefix_cache.hits == hits[1] + 1  # the suffix path ran
    assert _greedy_stream(cold, second, 8) == ref
    assert hit == ref
    assert cold.prefix_cache.hits == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_scheduler_streams_match_jax_engine(env, depth):
    prompts = [_prompt(30, 20), _prompt(31, 50), _prompt(32, 9)]
    n = 10
    ref = []
    for ids in prompts:
        _check_prompt_margin(env, ids)
        ref.append(_greedy_stream(
            env["jeng"], ids, n,
            check=lambda s: _check_decode_margin(env, s, [0])))
    sched = Scheduler(env["port"](), pipeline_depth=depth)
    reqs = [sched.submit(Request(prompt_ids=list(p), max_new_tokens=n))
            for p in prompts]
    for _ in range(200):
        if all(r.done.is_set() for r in reqs):
            break
        sched.step()
    assert all(r.finish_reason == "length" for r in reqs)
    assert [r.output_ids for r in reqs] == ref
    assert sched.stats["tokens_generated_total"] == 3 * (n - 1)
    sched.stop()
