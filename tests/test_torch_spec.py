"""Speculative decoding in the port: spec_verify, the drafter, `verify`.

* `sampling.spec_verify` against the JAX `spec_verify` on the same
  seeded logits and drafts: exact at temperature 0 (the accepted
  counts and emitted tokens). At temperature > 0 the draws cannot match
  `jax.random`, so `filtered_logits` are held equal on the same logits
  and a frequency test checks the Leviathan rule: a draft is accepted
  with its target probability, and the emitted token follows the
  target distribution whatever was drafted.
* `engine/spec.py` (`propose`, `grammar_prefix`) equals the reference
  on seeded streams.
* The engine's `verify`: out tokens, accepted counts and the lengths
  after it equal the JAX engine's `verify` (greedy, fp32), over a dense
  cache (the multi-row forward that runs the prefill kernel B2 on a
  card, from base = lengths) and a paged pool (`paged_attention_multi`).
* Paged spec under pool pressure through the port's scheduler: the
  streams equal the JAX greedy reference at every (K, depth), verify
  steps really ran (`spec_steps_total` > 0), preemption happened, and
  the pool is conserved.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import sampling as jsampling
from ome_tpu.engine import spec as jspec
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine import sampling, spec
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

B, MAX_SEQ = 4, 64
BUCKETS = [16, 32, 64]
GREEDY = (np.zeros(B, np.float32), np.zeros(B, np.int32),
          np.ones(B, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- spec_verify ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_verify_greedy_exact(seed):
    rng = np.random.default_rng(seed)
    Bv, k, V = 8, 4, 64
    logits = (rng.standard_normal((Bv, k + 1, V)) * 3).astype(np.float32)
    arg = logits.argmax(-1)
    # drafts follow the argmax for a random prefix, then diverge
    drafts = arg[:, :k].copy().astype(np.int32)
    cut = rng.integers(0, k + 1, Bv)
    for b in range(Bv):
        if cut[b] < k:
            drafts[b, cut[b]] = (arg[b, cut[b]] + 1) % V
    dlen = rng.integers(0, k + 1, Bv).astype(np.int32)
    temp = np.zeros(Bv, np.float32)
    tk = rng.integers(0, 5, Bv).astype(np.int32)
    tp = np.ones(Bv, np.float32)
    jout, jacc = jsampling.spec_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen),
        jax.random.PRNGKey(seed), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp))
    gen = torch.Generator().manual_seed(seed)
    tout, tacc = sampling.spec_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlen), gen, torch.from_numpy(temp),
        torch.from_numpy(tk), torch.from_numpy(tp))
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert tout.tolist() == np.asarray(jout).tolist()
    assert tacc.tolist() == np.minimum(cut, dlen).tolist()


def test_filtered_logits_equal_reference():
    rng = np.random.default_rng(11)
    Bv, V = 6, 64
    logits = (rng.standard_normal((Bv, V)) * 3).astype(np.float32)
    temp = np.asarray([0.0, 0.7, 1.0, 1.3, 0.5, 2.0], np.float32)
    tk = np.asarray([0, 0, 5, 20, 1, 0], np.int32)
    tp = np.asarray([1.0, 0.9, 1.0, 0.8, 1.0, 0.5], np.float32)
    want = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(tk),
        jnp.asarray(tp)))
    got = sampling.filtered_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(tk), torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_spec_verify_frequencies_follow_the_target():
    """One position drafted with token d, N independent rows: d is
    accepted with probability p(d), and the emitted first token follows
    p whatever the draft (accept-or-resample preserves the target)."""
    V, N, d = 8, 40000, 2
    base = np.log(np.asarray([0.05, 0.1, 0.3, 0.2, 0.15, 0.1, 0.06,
                              0.04], np.float32))
    logits = torch.from_numpy(np.broadcast_to(
        base, (N, 2, V)).copy())
    drafts = torch.full((N, 1), d, dtype=torch.int32)
    dlen = torch.ones(N, dtype=torch.int32)
    temp = torch.ones(N)
    tk = torch.zeros(N, dtype=torch.int32)
    tp = torch.ones(N)
    gen = torch.Generator().manual_seed(5)
    out, acc = sampling.spec_verify(logits, drafts, dlen, gen, temp, tk,
                                    tp)
    p = np.exp(base) / np.exp(base).sum()
    rate = acc.float().mean().item()
    sigma = np.sqrt(p[d] * (1 - p[d]) / N)
    assert abs(rate - p[d]) < 5 * sigma
    first = np.bincount(out[:, 0].numpy(), minlength=V) / N
    assert np.abs(first - p).max() < 0.012
    # rows that accepted d emit a bonus token drawn from position 1
    bonus = out[acc == 1, 1].numpy()
    freq = np.bincount(bonus, minlength=V) / max(len(bonus), 1)
    assert np.abs(freq - p).max() < 0.02


# -- the drafter ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_propose_and_grammar_prefix_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        stream = rng.integers(0, 6, rng.integers(1, 30)).tolist()
        for k in (0, 1, 3, 5):
            np.testing.assert_array_equal(spec.propose(stream, k),
                                          jspec.propose(stream, k))
        props = rng.integers(0, 6, 5).tolist()
        banned = int(rng.integers(0, 6))

        def accept(t, banned=banned):
            return t != banned
        assert spec.grammar_prefix(props, accept) == \
            jspec.grammar_prefix(props, accept)


# -- the engine's verify -------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    return jcfg, jp, tcfg, tp


def _seed(engine, prompts):
    st = engine.new_state()
    first = {}
    for slot, ids in prompts.items():
        tok, kv, tl, bucket = engine.prefill(ids, 0.0, 0, 1.0)
        st = engine.insert(st, kv, slot, tl, tok, bucket)
        first[slot] = tok
    return st, first


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_verify_matches_jax(weights, cache):
    jcfg, jp, tcfg, tp = weights
    kw = dict(kv_block=16, kv_blocks=40) if cache == "paged" else {}
    jeng = JaxEngine(jp, jcfg, max_slots=B, max_seq=MAX_SEQ,
                     prefill_buckets=BUCKETS, **kw)
    teng = InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                           prefill_buckets=BUCKETS, device="cpu", **kw)
    prompts = {0: [1, 7, 3, 9], 1: [1, 5, 9, 11, 13, 2, 4],
               2: [8, 8, 6, 5]}
    # the greedy continuation of each slot, from the JAX engine
    st, _ = _seed(jeng, prompts)
    true = {b: [] for b in prompts}
    for _ in range(3):
        st, toks = jeng.decode(st, *GREEDY)
        for b in prompts:
            true[b].append(int(np.asarray(toks)[b]))
    k = 3
    drafts = np.zeros((B, k), np.int32)
    drafts[0] = true[0]                                  # all accepted
    drafts[1] = [true[1][0], (true[1][1] + 1) % 512, 7]  # one accepted
    dlen = np.asarray([3, 3, 0, 0], np.int32)            # slot 2 plain
    res = []
    for eng in (jeng, teng):
        st, _ = _seed(eng, prompts)
        st, out, acc = eng.verify(st, drafts, dlen, *GREEDY)
        out, acc = np.asarray(out), np.asarray(acc)
        if cache == "paged":
            for b in prompts:
                eng.commit_spec(b, int(acc[b]) + 1)
        st, nxt = eng.decode(st, *GREEDY)
        res.append((out.tolist(), acc.tolist(),
                    np.asarray(st.lengths).tolist(),
                    np.asarray(nxt).tolist()))
    assert res[1] == res[0]
    out, acc = res[1][0], res[1][1]
    assert acc[:3] == [3, 1, 0]
    assert out[0] == true[0] + [out[0][3]]
    assert out[1][:2] == true[1][:2]
    assert out[2][0] == true[2][0]
    if cache == "paged":
        assert teng.kv_conservation()[0]


def test_paged_spec_under_pool_pressure(weights):
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_pipeline import _drive, reference_greedy

    jcfg, jp, tcfg, tp = weights
    engine = InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                             prefill_buckets=[32], kv_block=16,
                             kv_blocks=5, device="cpu")
    # repetitive prompts and 16 tokens each: the greedy streams repeat
    # their own n-grams, so the drafter proposes and verify plans meet
    # preemption (4 usable blocks of 16 rows for 4 x 28 rows)
    prompts = [[i + 1, 5, 9, 13] * 3 for i in range(4)]
    want = [reference_greedy(jp, jcfg, p, 16) for p in prompts]
    for k in (1, 4):
        for depth in (0, 1):
            sched = Scheduler(engine, pipeline_depth=depth,
                              steps_per_dispatch=k, spec_tokens=3)
            reqs = [sched.submit(Request(prompt_ids=p,
                                         max_new_tokens=16))
                    for p in prompts]
            _drive(sched, reqs, iters=2000)
            assert [list(r.output_ids) for r in reqs] == want, (k, depth)
            assert sched.stats["spec_steps_total"] > 0, (k, depth)
            assert sched.stats["spec_proposed_tokens_total"] > 0
            assert sched.stats["preemptions_total"] > 0, (k, depth)
            assert engine.kv_conservation()[0]
