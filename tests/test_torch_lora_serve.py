"""Multi-LoRA serving in the port around the engine, against the JAX
package (fp32, CPU); the helpers and the PEFT directories are
tests/test_torch_lora.py's.

* prefix tiers: an adapter request takes no device-trie, host-tier or
  peer hit, and seeds none;
* scheduler and server: an unknown adapter fails its request and not
  the scheduler, routing by model id with the 404 for an unknown id,
  `/v1/models` and `/ready`, `POST`/`DELETE /v1/adapters` statuses and
  bodies equal to the reference server's, and a served DELETE refused
  (409) while the adapter decodes, then accepted;
* serve: `--adapter DIR` merges into the checkpoint's weights bit-equal
  to the reference's merge, `--adapter DIR --random-weights` exits 2,
  named adapters and the `--lora-slots` default, a rank above
  `--lora-rank` exits naming the adapter;
* journal and PD: an adapter request killed and resumed through a
  journal resumes with its adapter; a PD pair with the adapter on both
  nodes gives the monolithic stream.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.server import EngineServer as JaxServer
from ome_tpu.models import checkpoint as jck
from ome_tpu.models import lora as jlora
from ome_tpu_torch import faults
from ome_tpu_torch.engine import pd, serve
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.journal import RequestJournal
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.models import checkpoint
from ome_tpu_torch.models.params import to_numpy

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_lora import (JOBS, KW, P, P2, TCFG, TINY_HF,  # noqa: E402
                             _clean_faults, _engines, _one_thread,
                             _tiny_checkpoint, streams, world,
                             write_adapter)

__all__ = ["_clean_faults", "_one_thread", "world"]  # fixtures


# -- prefix tiers -------------------------------------------------------------


def test_adapter_requests_take_no_prefix_hit(world, monkeypatch):
    _, tp, dirs = world
    long = list(range(20, 44))
    te = InferenceEngine(tp, TCFG, device="cpu", prefix_cache_bytes=1 << 20,
                         **KW)
    te.prefix_cache.min_prefix = 8
    te.prefix_cache.block = 8
    te.register_adapter("a1", dirs["a1"])
    cold = InferenceEngine(tp, TCFG, device="cpu", **KW)
    cold.register_adapter("a1", dirs["a1"])
    te.prefill(long)  # seeds the device trie
    seeded = te.prefix_cache.bytes
    hits = te.prefix_cache.hits
    got = te.prefill(long + [3], adapter="a1")
    want = cold.prefill(long + [3], adapter="a1")
    assert te.prefix_cache.hits == hits and te.prefix_cache.bytes == seeded
    assert got[0] == want[0] and torch.equal(got[1][0], want[1][0])
    assert te.prefill(long + [3])[0] is not None
    assert te.prefix_cache.hits == hits + 1  # the base request hits
    # host tier: evict everything to host memory, then an adapter
    # request must neither hit it nor queue a swap-in
    te.prefix_cache.host_capacity_bytes = 1 << 20
    te.prefix_cache.capacity_bytes = 0
    te.prefix_cache.put(long, *got[1], 24, 32)  # over budget: spills
    te.prefix_cache._evict_locked()
    host_hits = te.prefix_cache.host_hits
    te.prefix_cache.capacity_bytes = 1 << 20
    te.prefill(long + [4], adapter="a1")
    assert te.prefix_cache.host_hits == host_hits
    assert te.prefix_cache._swap_q.empty()
    # the peer fetch: a request with an adapter never asks the peer
    sched = Scheduler(te)
    monkeypatch.setattr(sched, "_peer_prefill", lambda *a: pytest.fail(
        "an adapter request asked a prefix peer"))
    req = Request(prompt_ids=long, max_new_tokens=2, adapter="a1",
                  prefix_peer="http://127.0.0.1:9")
    tok, _, _, _ = sched._prefill_req(req)
    assert tok == cold.prefill(long, adapter="a1")[0]


# -- scheduler and server -----------------------------------------------------


def _run(sched, reqs, timeout=60):
    for r in reqs:
        assert r.done.wait(timeout), r.id
    return [list(r.output_ids) for r in reqs]


def test_unknown_adapter_fails_the_request_not_the_scheduler(world):
    je, te = _engines(world)
    sched = Scheduler(te)
    sched.start()
    try:
        bad = sched.submit(Request(prompt_ids=P, max_new_tokens=4,
                                   adapter="nope"))
        reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=8,
                                     adapter=a)) for p, a in JOBS]
        got = _run(sched, [bad] + reqs)
        assert bad.finish_reason == "error" and got[0] == []
        assert sched.status == "ok"
        assert got[1:] == [s[:8] for s in streams(je, JOBS)]
    finally:
        sched.stop()


class _FakeSched:
    """What the HTTP handlers read of a scheduler: its engine."""

    healthy = True
    status = "ok"
    stats: dict = {}

    def __init__(self, engine):
        self.engine = engine

    def start(self):
        pass

    def stop(self):
        pass


def _http(url, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_adapter_endpoints_answer_as_the_reference(world, tmp_path):
    """The same sequence of POST/DELETE /v1/adapters requests against
    the reference server over the JAX engine and the port's server over
    its engine: the same statuses and bodies."""
    _, _, dirs = world
    je, te = _engines(world)
    big = write_adapter(tmp_path / "big", TCFG, 1, r=16)
    script = [
        ("POST", "/v1/adapters", {"name": "a3", "path": dirs["a1"]}),
        ("POST", "/v1/adapters", {"name": "a4", "path": "/nonexistent"}),
        ("POST", "/v1/adapters", {"name": "a4"}),
        ("POST", "/v1/adapters", {"name": "a4", "path": big}),
        ("POST", "/v1/adapters", {"name": "a4", "path": dirs["a2"]}),
        ("BUSY", 2, None),
        ("DELETE", "/v1/adapters/a2", None),
        ("IDLE", 0, None),
        ("DELETE", "/v1/adapters/a2", None),
        ("DELETE", "/v1/adapters/never", None),
        ("POST", "/v1/adapters", {"name": "a2", "path": dirs["a2"]}),
        ("GET", "/v1/models", None),
    ]
    answers = []
    for eng, server_cls in ((je, JaxServer), (te, EngineServer)):
        srv = server_cls(_FakeSched(eng), model_name="base")
        srv.start()
        url = f"http://127.0.0.1:{srv.port}"
        got = []
        try:
            for method, path, body in script:
                if method in ("BUSY", "IDLE"):
                    eng._slot_adapters[0] = path
                    continue
                status, doc = _http(url, path, body,
                                    None if method == "GET" else method)
                if status == 400:
                    doc = {"error": doc["error"].split(":")[0]}
                got.append((status, doc))
        finally:
            srv.stop()
        answers.append(got)
    assert answers[0] == answers[1]
    statuses = [s for s, _ in answers[1]]
    # a3 into the last free slot; a bad dir, no path, a rank above the
    # slots' and no free slot: 400; a2 busy: 409; then removed, unknown
    # removed, re-added into its old slot
    assert statuses == [200, 400, 400, 400, 400, 409, 200, 200, 200, 200]
    assert answers[1][0][1] == {"name": "a3", "slot": 3}
    assert answers[1][5][1]["retryable"] is True
    assert answers[1][8][1] == {"name": "a2", "slot": 2}
    assert [m["id"] for m in answers[1][-1][1]["data"]] == [
        "base", "a1", "a2", "a3"]


TINY_SERVE = dict(TINY_HF, max_position_embeddings=256)


@pytest.fixture(scope="module")
def served(tmp_path_factory, world):
    d = tmp_path_factory.mktemp("lora-serve")
    (d / "config.json").write_text(json.dumps(TINY_SERVE))
    cfg = checkpoint.load_config(str(d))
    a1 = write_adapter(d / "a1", cfg, 1)
    a2 = write_adapter(d / "a2", cfg, 2)
    server, sched, engine = serve.build_server(
        ["--model-dir", str(d), "--random-weights", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--max-slots", "4",
         "--max-seq", "128", "--dtype", "float32", "--model-name", "base",
         "--adapter", f"a1={a1}", "--adapter", f"a2={a2}",
         "--lora-rank", "8"])
    try:
        yield f"http://127.0.0.1:{server.port}", sched, engine, a1, a2
    finally:
        server.stop()


def _complete(url, model, prompt=P, n=6):
    return _http(url, "/v1/completions",
                 {"model": model, "prompt": prompt, "max_tokens": n,
                  "temperature": 0.0})


def test_served_routing_listing_and_hot_swap(served):
    url, sched, engine, a1, a2 = served
    assert engine.lora_slots == 4 and engine.lora_rank == 8
    assert engine.adapter_names == ["a1", "a2"]
    status, doc = _http(url, "/v1/models")
    assert [m["id"] for m in doc["data"]] == ["base", "a1", "a2"]
    assert doc["data"][1]["parent"] == "base"
    with urllib.request.urlopen(url + "/ready", timeout=30) as r:
        assert json.loads(r.read())["models"] == ["base", "a1", "a2"]
    texts = {}
    for model in ("base", "a1", "a2"):
        status, doc = _complete(url, model)
        assert status == 200, doc
        texts[model] = doc["choices"][0]["text"]
    assert len(set(texts.values())) == 3
    status, doc = _complete(url, "nope")
    assert status == 404 and "adapters: a1, a2" in doc["error"]
    # DELETE while a1 decodes: 409, then 200 once it finished
    gate = threading.Event()
    armed = threading.Event()
    decode = engine.decode

    def held_decode(*a, **kw):
        if engine._slot_adapters.any():
            armed.set()
            gate.wait(30)
        return decode(*a, **kw)
    engine.decode = held_decode
    box = {}
    t = threading.Thread(target=lambda: box.update(
        r=_complete(url, "a1", n=8)))
    t.start()
    try:
        assert armed.wait(30)
        status, doc = _http(url, "/v1/adapters/a1", method="DELETE")
        assert status == 409 and doc["retryable"] is True
    finally:
        gate.set()
        t.join(60)
        del engine.decode
    assert box["r"][0] == 200
    _wait_free(engine)
    status, doc = _http(url, "/v1/adapters/a1", method="DELETE")
    assert (status, doc) == (200, {"removed": "a1"})
    assert engine.adapter_names == ["a2"]
    status, doc = _http(url, "/v1/adapters", {"name": "a1", "path": a2})
    assert status == 200 and doc["slot"] == 1
    status, doc = _complete(url, "a1")
    assert doc["choices"][0]["text"] == texts["a2"]


def _wait_free(engine, timeout=30):
    deadline = time.monotonic() + timeout
    while engine._slot_adapters.any():
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_serve_adapter_flags(tmp_path):
    base = _tiny_checkpoint(tmp_path / "base", TINY_HF)
    cfg = checkpoint.load_config(base)
    ad = write_adapter(tmp_path / "ad", cfg, 4)
    # a bare dir with random weights: the reference's exit 2
    with pytest.raises(SystemExit) as e:
        serve.build_server(["--model-dir", base, "--random-weights",
                            "--device", "cpu", "--adapter", ad])
    assert e.value.code == 2
    with pytest.raises(SystemExit, match="name=dir"):
        serve.build_server(["--model-dir", base, "--device", "cpu",
                            "--adapter", ad, "--adapter", f"x={ad}"])
    with pytest.raises(SystemExit, match="--lora-rank"):
        serve.build_server(["--model-dir", base, "--device", "cpu",
                            "--lora-rank", "0"])
    # a bare dir merges into the checkpoint's weights, bit-equal to the
    # reference's merge of its own load
    server, _, engine = serve.build_server(
        ["--model-dir", base, "--device", "cpu", "--dtype", "float32",
         "--port", "0", "--host", "127.0.0.1", "--adapter", ad])
    try:
        assert engine.lora_slots == 0 and engine.adapter_names == []
        jp, jcfg = jck.load_params(base, dtype=jnp.float32,
                                   device_put=False)
        jlora.merge_lora(jp, jcfg, ad)
        got = engine.model.params["layers"]
        for name, leaf in jp["layers"].items():
            np.testing.assert_array_equal(to_numpy(got[name]),
                                          np.asarray(leaf), err_msg=name)
    finally:
        server.stop()
    # a rank above --lora-rank exits naming the adapter
    with pytest.raises(SystemExit, match="--adapter x="):
        serve.build_server(["--model-dir", base, "--device", "cpu",
                            "--adapter", f"x={ad}", "--lora-rank", "2"])


# -- journal and PD -----------------------------------------------------------


def test_adapter_request_resumes_with_its_adapter(world, tmp_path):
    je, _ = _engines(world)
    want = streams(je, [(P2, "a1")], steps=11)[0]
    d = str(tmp_path)

    def engine():
        return _engines(world)[1]
    faults.install("engine_step.raise@4")
    j = RequestJournal(d, fsync="always")
    sched = Scheduler(engine(), max_restarts=0, journal=j)
    sched.start()
    req = sched.submit(Request(prompt_ids=P2, max_new_tokens=12,
                               adapter="a1"))
    assert req.done.wait(60) and req.finish_reason == "engine_fault"
    deadline = time.monotonic() + 30
    while sched.status != "dead":
        assert time.monotonic() < deadline
        time.sleep(0.005)
    before = list(req.output_ids)
    sched.stop()
    j.close()
    faults.reset()
    j2 = RequestJournal(d)
    sched2 = Scheduler(engine(), journal=j2)
    assert sched2.resume_from_journal() == 1
    resumed = sched2.pending.queue[0]
    assert resumed.adapter == "a1"
    sched2.start()
    try:
        assert resumed.done.wait(60) and resumed.finish_reason == "length"
    finally:
        sched2.stop()
        j2.close()
    assert 0 < len(before) < 12
    assert list(resumed.output_ids) == want


def test_pd_pair_with_the_adapter_on_both_nodes(world):
    """A decode node fetching its prefill over HTTP from a prefill node,
    both with the adapters registered: the adapter request's stream is
    the JAX monolithic one, and the base request's is the base's."""
    from ome_tpu_torch.engine.serve import _PrefillNodeScheduler
    je, _ = _engines(world, max_slots=2)
    jobs = [(P2, "a2"), (P2, None)]
    want = [streams(je, [job], steps=7)[0] for job in jobs]
    pre_eng = _engines(world, max_slots=2)[1]
    handler = pd.make_pd_prefill_handler(pre_eng)
    pre = EngineServer(_PrefillNodeScheduler(pre_eng), model_name="m",
                       pd_prefill=handler)
    pre.start()
    node = pd.RemotePrefillEngine(_engines(world, max_slots=2)[1],
                                  f"http://127.0.0.1:{pre.port}")
    sched = Scheduler(node, overlap=True)
    sched.start()
    try:
        reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=8,
                                     adapter=a)) for p, a in jobs]
        assert _run(sched, reqs) == want
    finally:
        sched.stop()
        pre.stop()
    assert want[0] != want[1]
    assert len(handler.timings) == 2
    assert all(t["peer"] != "local" for t in node.timings)
