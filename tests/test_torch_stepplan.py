"""The port's scheduler step plans: spec x chunks x pipelining x masks.

The composition matrix of the reference (tests/test_multistep.py,
`TestCompositionMatrix`) run through the port's Scheduler on the JAX
init's weights (fp32, bridged with `from_jax_params`), over a dense
cache and a paged pool:

* unmasked: every (spec in {0, 2}) x (K in {1, 4}) x (depth in {0, 1})
  cell gives the JAX greedy reference streams exactly; the spec cells
  really draft; no cell loses a feature (degradation causes other than
  `spec_realign` stay 0); the pool is conserved;
* json_schema-masked: every cell gives the stream of the port's plain
  (0, 1, 0) cell and of the JAX Scheduler; K > 1 cells ride chunks; the
  device mask-table plans (row indices) equal the dense-mask baseline
  (`grammar_table=False`) cell for cell;
* a masked spec cell drafts through the grammar and accepts drafts;
* over HTTP, `--spec-tokens` and `--steps-per-dispatch` are served
  (echoed on /health) and a `response_format` json_schema request
  answers 200 with JSON that parses against its schema, dense and
  paged.
"""

import json
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.schema import SchemaAutomaton as JaxSchema
from ome_tpu.engine.scheduler import Request as JaxRequest
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu.engine.structured import TokenMasker as JaxMasker
from ome_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.schema import SchemaAutomaton
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.structured import TokenMasker
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_pipeline import _drive, reference_greedy  # noqa: E402

MAX_SEQ = 128
COMP_PLANS = [([1, 2, 3] * 4, 12), ([5, 6] * 5, 9),
              ([9, 8, 7, 9, 8, 7], 6), ([4, 4, 4, 4], 4)]
COMP_SCHEMA = {"type": "object",
               "properties": {"n": {"type": "integer", "minimum": 0,
                                    "maximum": 99}},
               "required": ["n"], "additionalProperties": False}
TEXTS = ("emit n:", "n = ", "give n ")
CELLS = [(spec, k, depth) for spec in (0, 2) for k in (1, 4)
         for depth in (0, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    engines = {
        name: InferenceEngine(tp, tcfg, max_slots=4, max_seq=MAX_SEQ,
                              prefill_buckets=[16, 32, 64], device="cpu",
                              **kw)
        for name, kw in (("dense", {}),
                         ("paged", dict(kv_block=16, kv_blocks=40)))}
    return jcfg, jp, engines


def _assert_composed(degr):
    assert set(degr) == {"masked", "spec_realign"}, degr
    assert degr["masked"] == 0, degr


def _run_cells(engine, masked, grammar_table=True):
    tok = ByteTokenizer()
    outs, chunked = {}, {}
    for spec, k, depth in CELLS:
        sched = Scheduler(engine, pipeline_depth=depth,
                          steps_per_dispatch=k, spec_tokens=spec,
                          grammar_table=grammar_table)
        if masked:
            reqs = [sched.submit(Request(
                prompt_ids=tok.encode(text), max_new_tokens=14,
                masker=TokenMasker(tok, automaton=SchemaAutomaton(
                    COMP_SCHEMA)), stop_ids=[tok.eos_id]))
                for text in TEXTS]
        else:
            reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=n))
                    for p, n in COMP_PLANS]
        _drive(sched, reqs, iters=3000)
        _assert_composed(sched.degradations)
        if spec and not masked:
            assert sched.stats["spec_proposed_tokens_total"] > 0
            assert sched.stats["spec_steps_total"] > 0
        outs[(spec, k, depth)] = [list(r.output_ids) for r in reqs]
        chunked[(spec, k, depth)] = sched._ph_device_loop.count
    assert engine.kv_conservation()[0]
    return outs, chunked


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_matrix_plain_equals_jax_reference(world, cache):
    jcfg, jp, engines = world
    want = [reference_greedy(jp, jcfg, p, n) for p, n in COMP_PLANS]
    outs, chunked = _run_cells(engines[cache], masked=False)
    for key, got in outs.items():
        assert got == want, key
    assert all(n > 0 for key, n in chunked.items() if key[1] > 1)


@pytest.fixture(scope="module")
def jax_masked_stream(world):
    jcfg, jp, _ = world
    eng = JaxEngine(jp, jcfg, max_slots=4, max_seq=MAX_SEQ,
                    prefill_buckets=[16, 32, 64])
    tok = JaxByteTokenizer()
    sched = JaxScheduler(eng, pipeline_depth=0)
    reqs = [sched.submit(JaxRequest(
        prompt_ids=tok.encode(text), max_new_tokens=14,
        masker=JaxMasker(tok, automaton=JaxSchema(COMP_SCHEMA)),
        stop_ids=[tok.eos_id])) for text in TEXTS]
    _drive(sched, reqs, iters=3000)
    return [list(r.output_ids) for r in reqs]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_matrix_masked_equals_jax_and_dense_masks(world, cache,
                                                  jax_masked_stream):
    _, _, engines = world
    idx, chunked = _run_cells(engines[cache], masked=True)
    dense, _ = _run_cells(engines[cache], masked=True,
                          grammar_table=False)
    for key in CELLS:
        assert idx[key] == jax_masked_stream, key
        assert dense[key] == idx[key], key
    assert any(n > 0 for key, n in chunked.items() if key[1] > 1)
    tok = ByteTokenizer()
    for ids in idx[(0, 1, 0)]:
        assert "n" in json.loads(tok.decode(ids))


def test_masked_spec_cell_drafts_and_accepts(world):
    _, _, engines = world
    tok = ByteTokenizer()
    for k in (1, 4):
        sched = Scheduler(engines["dense"], pipeline_depth=1,
                          steps_per_dispatch=k, spec_tokens=2)
        reqs = [sched.submit(Request(
            prompt_ids=tok.encode(text), max_new_tokens=14,
            masker=TokenMasker(tok), stop_ids=[tok.eos_id]))
            for text in TEXTS]
        _drive(sched, reqs, iters=3000)
        _assert_composed(sched.degradations)
        assert sched.stats["spec_proposed_tokens_total"] > 0, k
        assert sched.stats["spec_accepted_tokens_total"] > 0, k
        for r in reqs:
            json.loads(tok.decode(r.output_ids))


TINY = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 10000.0}
SERVE_SCHEMA = {"type": "object",
                "properties": {"name": {"type": "string",
                                        "pattern": "^[a-z]{1,6}$"},
                               "n": {"type": "integer", "minimum": 0,
                                     "maximum": 9}},
                "required": ["name", "n"],
                "additionalProperties": False}


def _post(url, body):
    req = urllib.request.Request(url + "/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_server_serves_step_flags_and_response_format(tmp_path, paged):
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    argv = ["--model-dir", str(tmp_path), "--random-weights", "--device",
            "cpu", "--host", "127.0.0.1", "--port", "0", "--max-slots",
            "2", "--max-seq", "128", "--dtype", "float32",
            "--spec-tokens", "2", "--steps-per-dispatch", "4"]
    if paged:
        argv += ["--kv-block", "16"]
    server, sched, _ = serve.build_server(argv)
    try:
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            health = json.loads(r.read())
        assert health["spec_tokens"] == 2
        assert health["steps_per_dispatch"] == 4
        status, doc = _post(url, {
            "prompt": "a b a b a b", "max_tokens": 12,
            "temperature": 0.0})
        assert status == 200
        assert doc["usage"]["completion_tokens"] >= 1
        status, doc = _post(url, {
            "prompt": "name it:", "max_tokens": 40, "temperature": 0.0,
            "response_format": {"type": "json_schema", "json_schema": {
                "name": "x", "schema": SERVE_SCHEMA}}})
        assert status == 200
        out = json.loads(doc["choices"][0]["text"])
        assert set(out) == {"name", "n"} and 0 <= out["n"] <= 9
        assert sched.steps_per_dispatch == 4 and sched.spec_tokens == 2
        if paged:
            assert sched.engine.kv_conservation()[0]
    finally:
        server.stop()
