"""Multi-token decode in the port: `decode_multi` and the paged block ops.

The JAX engine and the port's engine run the same weights (the JAX
init in fp32, bridged with `from_jax_params`) on the same prompts, on
the CPU, over a dense cache and over a paged pool. One 8-step chunk of
`decode_multi` must give the JAX `decode_multi`'s tokens and advanced
counts exactly, in three cases:

* budget: slot 0 takes the whole chunk, slot 1 a budget of 3, the free
  slots a budget of 0 (they never advance);
* stop: a stop id sampled mid-chunk freezes its slot. The stop id is a
  token of the JAX stream, taken at its FIRST occurrence there (a token
  that recurs in the stream stops the chunk where it first appears);
* capacity: a slot 4 rows short of `max_seq` freezes after 4 tokens.

Each case also holds against single `decode` steps of the port, and a
chunk makes no host read between its iterations (it runs on tensors
that refuse `.item()`, `.tolist()` and `.cpu()`).

The paged allocator: after the same script of inserts,
`_grow_blocks_spec` (pre-allocation for K rows, preemption under pool
pressure included), `commit_spec` with and without a reserve, and
`free_slot`, the host state (block table, owned lists, free list,
length mirror, preempted slots) equals the JAX engine's after every
op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

B, MAX_SEQ, STEPS = 4, 64, 8
BUCKETS = [16, 32, 64]
GREEDY = (np.zeros(B, np.float32), np.zeros(B, np.int32),
          np.ones(B, np.float32))
PROMPTS = {0: [1, 7, 3, 9], 1: [1, 5, 9, 11, 13, 2, 4]}
PAGED = dict(kv_block=16, kv_blocks=40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def engines(weights):
    jcfg, jp, tcfg, tp = weights
    out = {}
    for name, kw in (("dense", {}), ("paged", PAGED)):
        out[name] = (
            JaxEngine(jp, jcfg, max_slots=B, max_seq=MAX_SEQ,
                      prefill_buckets=BUCKETS, **kw),
            InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                            prefill_buckets=BUCKETS, device="cpu", **kw))
    return out


def _seed(engine, prompts):
    st = engine.new_state()
    for slot, ids in prompts.items():
        tok, kv, tl, bucket = engine.prefill(ids, 0.0, 0, 1.0)
        st = engine.insert(st, kv, slot, tl, tok, bucket)
    return st


def _chunk(engine, prompts, budget, stops):
    st = _seed(engine, prompts)
    st, out, adv = engine.decode_multi(st, *GREEDY, steps=STEPS,
                                       budget=budget, stop_ids=stops)
    return np.asarray(out), np.asarray(adv), st


def _stops():
    return np.full((B, 4), -1, np.int32)


class _NoHostRead(torch.Tensor):
    """A tensor whose host reads raise while `armed`: the chunk loop
    must not sync (the caller reads the outputs after the call)."""

    armed = False

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if cls.armed and func in (torch.Tensor.item, torch.Tensor.tolist,
                                  torch.Tensor.cpu, torch.Tensor.numpy):
            raise AssertionError(f"host read {func.__name__} in a chunk")
        return super().__torch_function__(func, types, args, kwargs or {})


def _case(name):
    """(prompts, budget, stops) of a named case; `stop` is filled in by
    the test from the JAX stream."""
    budget = np.zeros(B, np.int32)
    budget[0] = STEPS
    prompts = dict(PROMPTS)
    if name == "budget":
        budget[1] = 3
    elif name == "capacity":
        prompts[1] = [3 + (7 * i) % 200 for i in range(MAX_SEQ - 4)]
        budget[1] = STEPS
    else:
        budget[1] = STEPS
    return prompts, budget


@pytest.mark.parametrize("case", ["budget", "stop", "capacity"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_decode_multi_matches_jax(engines, cache, case):
    jeng, teng = engines[cache]
    prompts, budget = _case(case)
    stops = _stops()
    if case == "stop":
        free, _, _ = _chunk(jeng, prompts, budget, stops)
        stream = [int(t) for t in free[0]]
        stop = stream[4]
        first = stream.index(stop)  # its first occurrence decides
        stops[0, 0] = stop
    jout, jadv, _ = _chunk(jeng, prompts, budget, stops)
    tout, tadv, tst = _chunk(teng, prompts, budget, stops)
    assert tadv.tolist() == jadv.tolist()
    for b in range(B):
        n = int(jadv[b])
        assert tout[b, :n].tolist() == jout[b, :n].tolist(), b
    expect = {"budget": [STEPS, 3, 0, 0],
              "stop": [first + 1 if case == "stop" else 0, STEPS, 0, 0],
              "capacity": [STEPS, 4, 0, 0]}[case]
    assert tadv.tolist() == expect
    lengths = tst.lengths.tolist()
    true_len = {s: len(p) for s, p in prompts.items()}
    for b in range(2):
        assert lengths[b] == true_len[b] + int(tadv[b])
    if cache == "paged":
        for b in range(2):
            teng.commit_spec(b, int(tadv[b]))
        ok, _ = teng.kv_conservation()
        assert ok


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_chunk_equals_single_steps_without_host_reads(engines, cache):
    _, teng = engines[cache]
    budget = np.full(B, STEPS, np.int32)
    budget[2:] = 0
    st = _seed(teng, PROMPTS)
    ref = {0: [], 1: []}
    for _ in range(STEPS):
        st, toks = teng.decode(st, *GREEDY)
        for b in ref:
            ref[b].append(int(np.asarray(toks)[b]))
    if cache == "paged":
        for b in ref:
            teng.free_slot(b)
    st = _seed(teng, PROMPTS)
    st.tokens = st.tokens.as_subclass(_NoHostRead)
    st.lengths = st.lengths.as_subclass(_NoHostRead)
    args = [torch.from_numpy(a).as_subclass(_NoHostRead)
            for a in (*GREEDY, budget, _stops())]
    _NoHostRead.armed = True
    try:
        st, out, adv = teng.decode_multi(st, *args[:3], steps=STEPS,
                                         budget=args[3], stop_ids=args[4])
    finally:
        _NoHostRead.armed = False
    out = np.asarray(out)
    for b in ref:
        assert out[b].tolist() == ref[b], b
    assert np.asarray(adv).tolist() == [STEPS, STEPS, 0, 0]


def _alloc_state(engine):
    return ([list(map(int, row)) for row in np.asarray(engine._table)],
            [list(map(int, o)) for o in engine._owned],
            list(map(int, engine._free_blocks)),
            list(map(int, np.asarray(engine._host_len))),
            list(map(int, engine._preempted)))


def test_spec_block_script_allocator_matches_jax(weights):
    jcfg, jp, tcfg, tp = weights
    kw = dict(max_slots=B, max_seq=MAX_SEQ, prefill_buckets=BUCKETS,
              kv_block=16, kv_blocks=9)
    jeng = JaxEngine(jp, jcfg, **kw)
    teng = InferenceEngine(tp, tcfg, device="cpu", **kw)
    states = [jeng.new_state(), teng.new_state()]
    prompts = {0: list(range(3, 13)), 1: list(range(3, 23)),
               2: list(range(3, 33))}

    def both(op):
        for i, e in enumerate((jeng, teng)):
            op(i, e)
        assert _alloc_state(teng) == _alloc_state(jeng)

    for slot, ids in prompts.items():
        def ins(i, e, slot=slot, ids=ids):
            tok, kv, tl, bucket = e.prefill(ids, 0.0, 0, 1.0)
            states[i] = e.insert(states[i], kv, slot, tl, tok, bucket)
        both(ins)
    script = [("grow", 9), ("commit", 0, 3, 4), ("commit", 1, 9, 0),
              ("commit", 2, 2, 9), ("grow", 20), ("take",),
              ("commit", 0, 20, 0), ("grow", 40), ("take",),
              ("free", 1), ("grow", 16), ("commit", 2, 5, 0),
              ("free", 0), ("free", 2)]
    for op in script:
        if op[0] == "grow":
            both(lambda i, e: e._grow_blocks_spec(op[1]))
        elif op[0] == "commit":
            both(lambda i, e: e.commit_spec(op[1], op[2], reserve=op[3]))
        elif op[0] == "take":
            got = []
            both(lambda i, e: got.append(list(e.take_preempted())))
            assert got[0] == got[1]
        else:
            both(lambda i, e: e.free_slot(op[1]))
        assert teng.kv_conservation() == jeng.kv_conservation()
    assert teng.kv_conservation()[0]
    assert teng.kv_pool_stats["kv_blocks_free"] == 8
