"""Structured outputs in the port: grammar masks, masked engine ops, streams.

* The port's copies of the grammar modules (`engine/structured.py`,
  `schema.py`, `repattern.py`, `maskcache.py`) give mask rows
  byte-identical to the JAX package's, over json_object, any JSON
  value and json_schema grammars (enums, bounded integers, arrays and a
  regex `pattern`) on `ByteTokenizer`, at every position of a valid
  document: the plain mask, the closing mask, a byte budget, the
  budget-free mask with its slack, the closing distance and `done`.
* The engine's masked ops — `prefill(first_mask=)`, `decode`,
  `decode_multi` and `verify` with a dense mask and with indices into
  the device mask table — sample what the JAX engine's masked
  programs sample (greedy, fp32, seeded masks), over a dense cache and
  a paged pool.
* A json_schema-masked batch through the port's Scheduler gives the
  stream of the JAX Scheduler on the same weights, and every output
  parses against its schema.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import structured as jstructured
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.schema import SchemaAutomaton as JaxSchema
from ome_tpu.engine.scheduler import Request as JaxRequest
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine import structured
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.schema import SchemaAutomaton
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

B, MAX_SEQ, V = 4, 64, 512
BUCKETS = [16, 32, 64]
GREEDY = (np.zeros(B, np.float32), np.zeros(B, np.int32),
          np.ones(B, np.float32))
SCHEMAS = {
    "int": {"type": "object",
            "properties": {"n": {"type": "integer", "minimum": 0,
                                 "maximum": 99}},
            "required": ["n"], "additionalProperties": False},
    "pattern": {"type": "object",
                "properties": {
                    "id": {"type": "string",
                           "pattern": "^[a-z]{2}-[0-9]+$"},
                    "tags": {"type": "array",
                             "items": {"enum": ["x", "yy"]}},
                    "ok": {"type": "boolean"}},
                "required": ["id", "ok"],
                "additionalProperties": False},
}
DOCS = {"object": '{"a": [1, 2.5, "s"], "b": null}',
        "value": '[true, {"k": -3e2}]',
        "int": '{"n": 42}',
        "pattern": '{"id": "ab-123", "tags": ["yy", "x"], "ok": false}'}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maskers(grammar):
    tok, jtok = ByteTokenizer(), JaxByteTokenizer()
    if grammar == "object":
        return (structured.TokenMasker(tok, object_root=True),
                jstructured.TokenMasker(jtok, object_root=True))
    if grammar == "value":
        return structured.TokenMasker(tok), jstructured.TokenMasker(jtok)
    return (structured.TokenMasker(
        tok, automaton=SchemaAutomaton(SCHEMAS[grammar])),
        jstructured.TokenMasker(
            jtok, automaton=JaxSchema(SCHEMAS[grammar])))


@pytest.mark.parametrize("grammar", list(DOCS))
def test_mask_rows_byte_identical(grammar):
    port, ref = _maskers(grammar)
    ids = ByteTokenizer().encode(DOCS[grammar], add_bos=False)
    for i, t in enumerate(ids + [None]):
        for kw in ({}, {"closing": True}, {"remaining": 6},
                   {"remaining": len(ids) - i + 1}):
            a, b = port.mask(V, **kw), ref.mask(V, **kw)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (i, kw)
        (a, sa), (b, sb) = port.mask_with_slack(V), ref.mask_with_slack(V)
        assert a.tobytes() == b.tobytes() and sa == sb, i
        assert port.closing_distance() == ref.closing_distance(), i
        assert port.done() == ref.done(), i
        if t is None:
            break
        assert port.mask(V)[t], (i, t)  # the document stays in grammar
        port.feed(t)
        ref.feed(t)
    assert port.done() and ref.done()


# -- masked engine ops ---------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    return jcfg, jp, tcfg, tp


def _masks(rng, shape):
    m = rng.random(shape) < 0.4
    m[..., 3] = True  # never empty
    return m


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_masked_engine_ops_match_jax(weights, cache):
    jcfg, jp, tcfg, tp = weights
    kw = dict(kv_block=16, kv_blocks=40) if cache == "paged" else {}
    jeng = JaxEngine(jp, jcfg, max_slots=B, max_seq=MAX_SEQ,
                     prefill_buckets=BUCKETS, mask_table_rows=8, **kw)
    teng = InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                           prefill_buckets=BUCKETS, device="cpu",
                           mask_table_rows=8, **kw)
    rng = np.random.default_rng(21)
    rows = _masks(rng, (7, V))
    first = _masks(rng, (2, V))
    dense1 = _masks(rng, (B, V))
    stack = _masks(rng, (B, 4, V))
    idx1 = rng.integers(0, 8, B).astype(np.int32)
    idx4 = rng.integers(0, 8, (B, 4)).astype(np.int32)
    drafts = rng.integers(3, 300, (B, 2)).astype(np.int32)
    dlen = np.asarray([2, 1, 0, 2], np.int32)
    idx3 = rng.integers(0, 8, (B, 3)).astype(np.int32)
    budget = np.asarray([4, 4, 0, 2], np.int32)
    stops = np.full((B, 4), -1, np.int32)
    prompts = {0: [1, 7, 3, 9], 1: [1, 5, 9, 11, 13, 2, 4]}
    res = []
    for eng in (jeng, teng):
        for r in range(1, 8):
            eng.set_mask_row(r, rows[r - 1])
        st = eng.new_state()
        got = []
        for slot, ids in prompts.items():
            tok, kv, tl, bucket = eng.prefill(ids, first_mask=first[slot])
            st = eng.insert(st, kv, slot, tl, tok, bucket)
            got.append(tok)
        # only live slots compare: free slots decode whatever their
        # cache holds (paged: the trash block, written in no set order)
        live = list(prompts)
        for op in ("mask", "mask_idx"):
            st, t = eng.decode(st, *GREEDY, **{
                op: dense1 if op == "mask" else idx1})
            got.append(np.asarray(t)[live].tolist())
            st, out, adv = eng.decode_multi(
                st, *GREEDY, steps=4, budget=budget, stop_ids=stops,
                **{op: stack if op == "mask" else idx4})
            got.append((np.asarray(out)[live].tolist(),
                        np.asarray(adv)[live].tolist()))
            if cache == "paged":
                for b in live:
                    eng.commit_spec(b, int(np.asarray(adv)[b]))
            st, out, acc = eng.verify(st, drafts, dlen, *GREEDY, **{
                op: dense1 if op == "mask" else idx3})
            got.append((np.asarray(out)[live].tolist(),
                        np.asarray(acc)[live].tolist()))
            if cache == "paged":
                for b in live:
                    eng.commit_spec(b, int(np.asarray(acc)[b]) + 1)
        got.append(np.asarray(st.lengths)[live].tolist())
        res.append(got)
    assert res[1] == res[0]
    # the first tokens honour their masks
    assert first[0][res[1][0]] and first[1][res[1][1]]
    if cache == "paged":
        assert teng.kv_conservation()[0]


def test_mask_table_rows_refuse_row_zero(weights):
    _, _, tcfg, tp = weights
    teng = InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                           device="cpu", mask_table_rows=4)
    with pytest.raises(ValueError, match="out of range"):
        teng.set_mask_row(0, np.zeros(V, bool))
    with pytest.raises(ValueError, match="out of range"):
        teng.set_mask_row(4, np.zeros(V, bool))
    teng.set_mask_row(2, np.zeros(V, bool))
    tab = teng._mask_table()
    assert tab[0].all() and not tab[2].any() and tab[3].all()


# -- masked streams through the schedulers ------------------------------


@pytest.mark.parametrize("schema", ["int", "pattern"])
def test_masked_stream_equals_jax_scheduler(weights, schema):
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_pipeline import _drive

    jcfg, jp, tcfg, tp = weights
    jeng = JaxEngine(jp, jcfg, max_slots=B, max_seq=MAX_SEQ,
                     prefill_buckets=BUCKETS)
    teng = InferenceEngine(tp, tcfg, max_slots=B, max_seq=MAX_SEQ,
                           prefill_buckets=BUCKETS, device="cpu")
    texts = ("emit n:", "n = ", "give n ")
    outs = []
    for eng, sched_cls, req_cls, tok, auto, masker in (
            (jeng, JaxScheduler, JaxRequest, JaxByteTokenizer(),
             JaxSchema, jstructured.TokenMasker),
            (teng, Scheduler, Request, ByteTokenizer(), SchemaAutomaton,
             structured.TokenMasker)):
        sched = sched_cls(eng, pipeline_depth=0)
        reqs = [sched.submit(req_cls(
            prompt_ids=tok.encode(t), max_new_tokens=40,
            masker=masker(tok, automaton=auto(SCHEMAS[schema])),
            stop_ids=[tok.eos_id])) for t in texts]
        _drive(sched, reqs, iters=3000)
        outs.append([list(r.output_ids) for r in reqs])
    assert outs[1] == outs[0]
    tok = ByteTokenizer()
    for ids in outs[1]:
        doc = json.loads(tok.decode(ids))
        assert set(doc) >= set(SCHEMAS[schema]["required"])
