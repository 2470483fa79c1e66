"""PD disaggregation in the port (engine/pd.py), against the JAX package.

* Wire bytes: for the same planes, drawn with numpy from a seed, in
  bf16, fp32 and fp16, plain and int8-quantized, the port's
  `serialize_kv` writes exactly the reference's bytes.
* Wire reading: each engine's `deserialize_kv` reads the other's blob to
  equal planes (the int8 ones dequantized to the same bits), and a
  truncated blob is refused.
* JAX to port and back: a blob from the JAX `make_pd_prefill_handler`,
  inserted into the port engine, gives the JAX monolithic greedy stream;
  a blob from the port's handler, inserted into the JAX engine, gives
  the same stream. Over int8 paged pools (quantized blobs, re-quantized
  on insert) each engine decodes the other's blob to the stream the
  blob's own engine decodes it to: the wire's int8 steps survive the
  round trip exactly, but the wire quantizer (amax / 127) and the pool's
  (amax x f32(1/127)) put about 1e-4 of the values one step apart, so a
  PD int8 pool is not the monolithic int8 pool bit for bit.
* Over HTTP on 127.0.0.1: a port prefill node plus a port decode node
  answer what the port's monolithic server answers, and the prefill
  node rejects completions; the pool fails over in order, survives a
  peer's death mid-handoff, caps each attempt at the request's
  deadline, and a failed remote prefill fails the request, not the
  server.
* Durable PD requests: a journaled request killed mid-decode on a
  decode node resumes on a fresh one byte-identical to the monolithic
  stream, its admit record carrying the PD provenance and its folded
  prompt re-prefilled through the pool.
"""

import json
import socket
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ome_tpu.engine import pd as jpd
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch import faults
from ome_tpu_torch.engine import pd
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.serve import _PrefillNodeScheduler
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

SLOTS = 2
GREEDY = (np.zeros(SLOTS, np.float32), np.zeros(SLOTS, np.int32),
          np.ones(SLOTS, np.float32))
PROMPT = [5, 6, 7] + list(range(20, 40))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the wire ------------------------------------------------------------------

NP_DTYPES = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32,
             "float16": np.float16}
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}


def _planes(name, seed=0, shape=(2, 1, 12, 3, 8)):
    """The same k/v planes as numpy (the reference's input: ml_dtypes
    bf16) and as torch tensors (rounded from the same fp32 draws)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32)
    v = 3.0 * rng.standard_normal(shape).astype(np.float32)
    ref = tuple(x.astype(NP_DTYPES[name]) for x in (k, v))
    port = tuple(torch.from_numpy(x).to(TORCH_DTYPES[name]) for x in (k, v))
    return ref, port


def _np(t: torch.Tensor) -> np.ndarray:
    """A port plane as the reference's numpy (bf16 through its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16"])
def test_serialize_writes_the_reference_bytes(name, quantize):
    (rk, rv), (tk, tv) = _planes(name, seed=len(name))
    want = jpd.serialize_kv(11, rk, rv, true_len=9, bucket=12,
                            quantize=quantize)
    got = pd.serialize_kv(11, tk, tv, true_len=9, bucket=12,
                          quantize=quantize)
    assert got == want
    # numpy input to the port (fp32/fp16 only: no bf16 numpy needed)
    if name != "bfloat16":
        assert pd.serialize_kv(11, rk, rv, 9, 12, quantize=quantize) == want


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16"])
def test_each_side_reads_the_others_blob(name, quantize):
    (rk, rv), (tk, tv) = _planes(name, seed=3)
    ref_blob = jpd.serialize_kv(4, rk, rv, 10, 12, quantize=quantize)
    port_blob = pd.serialize_kv(4, tk, tv, 10, 12, quantize=quantize)
    tok, k, v, tl, b = pd.deserialize_kv(bytearray(ref_blob))
    rtok, rk2, rv2, rtl, rb = jpd.deserialize_kv(port_blob)
    assert (tok, tl, b) == (rtok, rtl, rb) == (4, 10, 12)
    assert k.dtype == TORCH_DTYPES[name] and rk2.dtype == rk.dtype
    for ours, theirs in ((k, rk2), (v, rv2)):
        np.testing.assert_array_equal(_np(ours).view(np.uint8),
                                      theirs.view(np.uint8))
    if not quantize:
        np.testing.assert_array_equal(_np(k).view(np.uint8),
                                      rk.view(np.uint8))
    # the port reads its own blob, from bytes or a writable buffer
    tok2, k2, _, _, _ = pd.deserialize_kv(port_blob)
    assert torch.equal(k2, k)


def test_wire_refuses_truncation_and_unknown_dtypes():
    _, (tk, tv) = _planes("float32")
    blob = pd.serialize_kv(1, tk, tv, 12, 12)
    with pytest.raises(pd.PDError):
        pd.deserialize_kv(blob[:-8])
    with pytest.raises(pd.PDError):
        pd.deserialize_kv(b"\x01")
    qblob = pd.serialize_kv(1, tk, tv, 12, 12, quantize=True)
    with pytest.raises(pd.PDError):
        pd.deserialize_kv(qblob[:-4])
    with pytest.raises(pd.PDError):
        pd.serialize_kv(1, tk.to(torch.int8), tv.to(torch.int8), 12, 12)


# -- engines -------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=128)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=128)
    return jcfg, jparams, tcfg, tparams


def _engine(world, **kw):
    _, _, tcfg, tparams = world
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("prefill_buckets", [16, 32])
    return InferenceEngine(tparams, tcfg, device="cpu", **kw)


def _jax_engine(world, **kw):
    jcfg, jparams, _, _ = world
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("prefill_buckets", [16, 32])
    return JaxEngine(jparams, jcfg, **kw)


def _decode_stream(eng, kv, tok, true_len, bucket, steps=8):
    state = eng.new_state()
    state = eng.insert(state, kv, 0, true_len, tok, bucket)
    out = [int(tok)]
    for _ in range(steps):
        state, toks = eng.decode(state, *GREEDY)
        out.append(int(np.asarray(toks)[0]))
    return out


def _mono_stream(eng, prompt, steps=8):
    tok, kv, tl, b = eng.prefill(prompt)
    return _decode_stream(eng, kv, tok, tl, b, steps)


POOLS = {"dense": {}, "paged_int8": dict(kv_block=16, kv_blocks=12,
                                         kv_dtype="int8")}


def _blob_stream(world, blob, make, pool):
    if make is _engine:
        tok, k, v, tl, b = pd.deserialize_kv(blob)
    else:
        tok, k, v, tl, b = jpd.deserialize_kv(blob)
    return _decode_stream(make(world, **POOLS[pool]), (k, v), tok, tl, b)


@pytest.mark.parametrize("pool", list(POOLS))
def test_jax_blob_into_port_gives_the_jax_stream(world, pool):
    blob = jpd.make_pd_prefill_handler(_jax_engine(world, **POOLS[pool]))(
        {"ids": PROMPT, "temperature": 0.0})
    if pool == "dense":
        want = _mono_stream(_jax_engine(world), PROMPT)
    else:
        header = json.loads(blob[4:4 + int.from_bytes(blob[:4], "little")])
        assert header["dtype"] == "int8"
        want = _blob_stream(world, blob, _jax_engine, pool)
    teng = _engine(world, **POOLS[pool])
    tok, k, v, tl, b = pd.deserialize_kv(blob)
    assert _decode_stream(teng, (k, v), tok, tl, b) == want
    if pool == "paged_int8":
        teng.free_slot(0)
        assert teng.kv_conservation()[0]


@pytest.mark.parametrize("pool", list(POOLS))
def test_port_blob_into_jax_gives_the_same_stream(world, pool):
    blob = pd.make_pd_prefill_handler(_engine(world, **POOLS[pool]))(
        {"ids": PROMPT, "temperature": 0.0})
    if pool == "dense":
        want = _mono_stream(_jax_engine(world), PROMPT)
        assert _mono_stream(_engine(world), PROMPT) == want
    else:
        want = _blob_stream(world, blob, _engine, pool)
    assert _blob_stream(world, blob, _jax_engine, pool) == want


def test_int8_blob_round_trip_is_value_stable():
    """A quantized bf16 blob, dequantized and quantized again by the
    int8 pool's own rule, gives back the wire's int8 steps exactly and
    the scales the pool computes from the original planes; against the
    pool's quantization of the original planes, about 1e-4 of the steps
    differ, by one."""
    from ome_tpu_torch.ops import flash
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 1, 256, 8, 128)).astype(
        np.float32)).to(torch.bfloat16)
    _, k2, _, _, _ = pd.deserialize_kv(
        pd.serialize_kv(1, k, k, 256, 256, quantize=True))
    wire_q, _ = pd.quantize_kv_plane(k)
    q2, s2 = flash.quantize_rows(k2)
    pool_q, pool_s = flash.quantize_rows(k)
    np.testing.assert_array_equal(q2.numpy(), wire_q)
    assert torch.equal(s2, pool_s)
    diff = np.abs(pool_q.numpy().astype(np.int32) - wire_q)
    assert diff.max() == 1 and 0 < (diff > 0).mean() < 1e-3


def test_prefill_handler_exports_the_engine_result(world):
    eng = _engine(world)
    handler = pd.make_pd_prefill_handler(eng)
    tok, k, v, tl, b = pd.deserialize_kv(handler({"ids": [5, 6, 7]}))
    want_tok, (wk, wv), wtl, wb = eng.prefill([5, 6, 7])
    assert (tok, tl, b) == (want_tok, wtl, wb)
    assert torch.equal(k, wk) and torch.equal(v, wv)
    assert handler.timings[-1]["bytes"] > 0
    with pytest.raises(pd.PDError):
        handler({"ids": []})


# -- over HTTP -----------------------------------------------------------------


def _prefill_server(world, **kw):
    eng = _engine(world, **kw)
    srv = EngineServer(_PrefillNodeScheduler(eng), model_name="m",
                       pd_prefill=pd.make_pd_prefill_handler(eng))
    srv.start()
    return srv


def _url(srv):
    return f"http://127.0.0.1:{srv.port}"


def _complete(port, stream=False):
    body = json.dumps({"model": "m", "prompt": "hi there pd",
                       "max_tokens": 6, "temperature": 0,
                       "stream": stream}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_pd_pair_matches_monolithic_over_http(world):
    mono = EngineServer(Scheduler(_engine(world)), model_name="m")
    mono.start()
    pre = _prefill_server(world)
    dec = EngineServer(Scheduler(pd.RemotePrefillEngine(
        _engine(world), _url(pre)), overlap=True), model_name="m")
    dec.start()
    try:
        want = json.loads(_complete(mono.port))
        got = json.loads(_complete(dec.port))
        assert got["choices"] == want["choices"]
        assert got["usage"] == want["usage"]
        want_s = _complete(mono.port, stream=True)
        got_s = _complete(dec.port, stream=True)
        assert [ln.split(b'", ', 1)[-1] for ln in want_s.splitlines()
                if ln.startswith(b"data:")] == \
            [ln.split(b'", ', 1)[-1] for ln in got_s.splitlines()
             if ln.startswith(b"data:")]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _complete(pre.port)
        assert ei.value.code == 503
        # a server without a handler answers 404 on /pd/prefill
        req = urllib.request.Request(
            f"http://127.0.0.1:{mono.port}/pd/prefill",
            data=json.dumps({"ids": [1, 2]}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404
    finally:
        for s in (mono, pre, dec):
            s.stop()


def test_pool_failover_order(world):
    a, b = _prefill_server(world), _prefill_server(world)
    eng = pd.RemotePrefillEngine(_engine(world),
                                 peer_urls=[_url(a), _url(b)], timeout=10.0)
    try:
        faults.install(f"pd_fetch|{_url(a)}.raise@1")
        tok, (k, v), tl, bucket = eng.prefill([5, 6, 7])
        assert eng.failovers == 1
        assert eng._last_peer == _url(b)
        want_tok, (wk, wv), wtl, wb = eng._engine.prefill([5, 6, 7])
        assert (tok, tl, bucket) == (want_tok, wtl, wb)
        assert torch.equal(k, wk)
        assert eng.pool.peers[0].fails == 1
        assert eng.pool.peers[1].fails == 0
    finally:
        faults.reset()
        a.stop()
        b.stop()


def test_peer_death_mid_handoff_fails_over(world):
    a, b = _prefill_server(world), _prefill_server(world)
    eng = pd.RemotePrefillEngine(_engine(world),
                                 peer_urls=[_url(a), _url(b)], timeout=5.0)
    sched = Scheduler(eng, overlap=True)
    sched.start()
    try:
        def run(ids):
            req = sched.submit(Request(prompt_ids=ids, max_new_tokens=3))
            assert req.done.wait(60)
            return req
        assert run([1, 2, 3]).finish_reason == "length"
        a.stop()
        assert run([4, 5]).finish_reason == "length"
        before = eng.failovers
        assert run([6, 7, 8]).finish_reason == "length"
        assert eng.failovers > before
        assert sched.healthy
        assert sched.stats["restarts_total"] == 0
    finally:
        sched.stop()
        b.stop()


def test_deadline_caps_attempt_timeout(world):
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(4)
    url = f"http://127.0.0.1:{sink.getsockname()[1]}"
    eng = pd.RemotePrefillEngine(_engine(world), peer_urls=[url],
                                 timeout=60.0, local_fallback=True)
    try:
        t0 = time.monotonic()
        with pytest.raises(pd.PDError):
            eng.prefill([1, 2], deadline=time.monotonic() - 1.0)
        assert time.monotonic() - t0 < 2.0
        assert eng.local_fallbacks == 0
        t0 = time.monotonic()
        tok, kv, tl, bucket = eng.prefill(
            [1, 2], deadline=time.monotonic() + 1.5)
        assert time.monotonic() - t0 < 20.0
        assert eng.local_fallbacks == 1
        assert tok == eng._engine.prefill([1, 2])[0]
    finally:
        sink.close()


def test_remote_prefill_failure_fails_request_not_server(world):
    sched = Scheduler(pd.RemotePrefillEngine(
        _engine(world), "http://127.0.0.1:1", timeout=2.0), overlap=True)
    sched.start()
    try:
        for ids in ([1, 2, 3], [4, 5]):
            req = sched.submit(Request(prompt_ids=ids, max_new_tokens=4))
            assert req.done.wait(60)
            assert req.finish_reason == "error"
            assert sched.healthy
        # an insert failure of fetched KV is as transient as a fetch's
        pre = _prefill_server(world)
        sched.engine.pool.peers[0].url = _url(pre)
        sched.engine.pool.peers[0].record_success()
        faults.install("pd_insert.raise@1")
        req = sched.submit(Request(prompt_ids=[1, 2], max_new_tokens=2))
        assert req.done.wait(60) and req.finish_reason == "error"
        req = sched.submit(Request(prompt_ids=[1, 2], max_new_tokens=2))
        assert req.done.wait(60) and req.finish_reason == "length"
        assert sched.healthy and sched.stats["restarts_total"] == 0
        pre.stop()
    finally:
        faults.reset()
        sched.stop()


def test_pd_journal_kill_resume_byte_identical(world, tmp_path):
    """A journaled PD request killed mid-decode resumes on a fresh decode
    node byte-identical to an uninterrupted monolithic run: the journal's
    admit record carries the PD provenance, and the resume re-prefills
    (prompt + generated prefix) through the pool — the prefill node
    serves one more fetch, for the folded prompt."""
    from ome_tpu_torch.engine.journal import RequestJournal
    d = str(tmp_path)
    pre = _prefill_server(world)
    url = _url(pre)
    fetched = []
    handler = pre.pd_prefill

    def recording(body, *a, **kw):
        fetched.append(list(body["ids"]))
        return handler(body, *a, **kw)
    pre.pd_prefill = recording
    try:
        ref_sched = Scheduler(_engine(world))
        ref_sched.start()
        ref = ref_sched.submit(Request(prompt_ids=[9, 8, 7],
                                       max_new_tokens=8))
        assert ref.done.wait(60) and ref.finish_reason == "length"
        ref_sched.stop()

        # the decode node dies mid-decode (an engine_step fault with no
        # restart budget: dead, so the journal entry stays resumable)
        faults.install("engine_step.raise@4")
        provenance = {"mode": "pd-decode", "peers": [url]}
        j = RequestJournal(d, fsync="always", provenance=provenance)
        sched = Scheduler(pd.RemotePrefillEngine(_engine(world),
                                                 peer_urls=[url]),
                          overlap=True, max_restarts=0, journal=j)
        sched.start()
        req = sched.submit(Request(prompt_ids=[9, 8, 7], max_new_tokens=8))
        assert req.done.wait(60)
        assert req.finish_reason == "engine_fault"
        deadline = time.monotonic() + 15
        while sched.status != "dead" and time.monotonic() < deadline:
            time.sleep(0.01)
        got_before = list(req.output_ids)
        assert 0 < len(got_before) < 8
        sched.stop()
        j.close()
        faults.reset()

        # a new process: fresh engines over the same journal directory
        j2 = RequestJournal(d)
        entries = j2.replay()
        assert len(entries) == 1
        assert entries[0].pd == provenance
        sched2 = Scheduler(pd.RemotePrefillEngine(_engine(world),
                                                  peer_urls=[url]),
                           overlap=True, journal=j2)
        assert sched2.resume_from_journal() == 1
        resumed = sched2.pending.queue[0]
        assert resumed.prompt_ids == [9, 8, 7] + got_before
        sched2.start()
        assert resumed.done.wait(60)
        assert resumed.finish_reason == "length"
        sched2.stop()
        j2.close()
        assert resumed.output_ids == ref.output_ids
        assert fetched == [[9, 8, 7], [9, 8, 7] + got_before]
    finally:
        faults.reset()
        pre.stop()
