"""Cross-replica prefix reuse in the port (engine/peering.py plus the
scheduler's admission hook), mirroring the reference's
tests/test_peering.py on the port's engines.

Every failure — a non-HTTP peer URL, a connect error, an open breaker,
an expired deadline, an injected fault — degrades to a local prefill
with the same tokens, never to a failed request. A fetch returns
exactly what the donor's `engine.prefill` returns, seeds the local
prefix cache, and an int8 blob ships at about half the bytes within one
quantization step. Constrained requests never take the peer path.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch import faults
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.pd import (deserialize_kv, make_pd_prefill_handler,
                                     serialize_kv)
from ome_tpu_torch.engine.peering import PrefixPeerClient
from ome_tpu_torch.engine.scheduler import Request, Scheduler
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

MB64 = 64 << 20
PROMPT = list(range(2, 42))  # 40 tokens -> one cached 32-block


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=128)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return tiny_test().replace(dtype=torch.float32, max_seq_len=128), tparams


def _engine(world, **kw):
    cfg, params = world
    kw.setdefault("max_slots", 2)
    kw.setdefault("prefill_buckets", [16, 32, 64])
    return InferenceEngine(params, cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def donor(world):
    """A replica whose /pd/prefill serves prefix KV blobs."""
    eng = _engine(world)
    srv = EngineServer(Scheduler(eng), model_name="m",
                       pd_prefill=make_pd_prefill_handler(eng))
    srv.start()
    yield srv, eng
    srv.stop()


def _run_one(sched, **req_kw):
    req_kw.setdefault("max_new_tokens", 6)
    req_kw.setdefault("temperature", 0.0)
    req = sched.submit(Request(**req_kw))
    for _ in range(500):
        if req.done.is_set():
            break
        sched.step()
    assert req.done.is_set()
    return req


@pytest.fixture(scope="module")
def want_tokens(world):
    return _run_one(Scheduler(_engine(world)), prompt_ids=PROMPT).output_ids


class TestClientFallbacks:
    def test_non_http_scheme_refused_outright(self):
        c = PrefixPeerClient()
        assert c.fetch("file:///etc/passwd", [1, 2, 3]) is None
        assert c.fetch("ftp://peer:21", [1, 2, 3]) is None
        assert c.fallbacks == 2 and c.fetches == 0
        assert not c._peers

    def test_connect_failure_charges_breaker_then_opens(self):
        url = "http://127.0.0.1:9"  # nothing listens
        c = PrefixPeerClient(timeout=1.0, cb_threshold=2, cb_cooldown=30.0)
        assert c.fetch(url, [1, 2]) is None
        assert c.fetch(url, [1, 2]) is None
        peer = c._backend(url)
        assert peer.fails >= 2 and not peer.selectable(time.monotonic())
        t0 = time.monotonic()
        assert c.fetch(url, [1, 2]) is None
        assert time.monotonic() - t0 < 0.5
        assert c.fallbacks == 3 and c.fetches == 0

    def test_expired_deadline_skips_the_attempt(self, donor):
        srv, _ = donor
        c = PrefixPeerClient()
        url = f"http://127.0.0.1:{srv.port}"
        assert c.fetch(url, PROMPT, deadline=time.monotonic() - 1.0) is None
        assert c.fallbacks == 1
        assert c.fetch(url, PROMPT,
                       deadline=time.monotonic() + 30) is not None

    def test_fault_point_degrades_to_fallback(self, donor):
        srv, donor_eng = donor
        url = f"http://127.0.0.1:{srv.port}"
        c = PrefixPeerClient(cb_threshold=3)
        try:
            faults.install(f"prefix_peer_fetch|{url}.raise@1")
            assert c.fetch(url, PROMPT) is None
            assert c.fallbacks == 1
            got = c.fetch(url, PROMPT)
            assert got is not None and c.fetches == 1
            tok, (k, v), tl, bucket = got
            want_tok, (wk, wv), wtl, wb = donor_eng.prefill(PROMPT)
            assert (tok, tl, bucket) == (want_tok, wtl, wb)
            assert torch.equal(k, wk) and torch.equal(v, wv)
        finally:
            faults.reset()


def test_int8_wire_blob_halves_bytes_within_tolerance():
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((2, 1, 32, 4, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 1, 32, 4, 16))
                         .astype(np.float32))
    full = serialize_kv(7, k, v, true_len=30, bucket=32)
    quant = serialize_kv(7, k, v, true_len=30, bucket=32, quantize=True)
    assert len(quant) < 0.35 * len(full)
    # bf16 planes at head_dim 128: the int8 blob is about half the bytes
    kb = torch.from_numpy(rng.standard_normal((2, 1, 32, 4, 128))
                          .astype(np.float32)).to(torch.bfloat16)
    half = serialize_kv(7, kb, kb, 30, 32, quantize=True)
    assert len(half) < 0.53 * len(serialize_kv(7, kb, kb, 30, 32))
    tok, k2, v2, tl, b = deserialize_kv(quant)
    assert (tok, tl, b) == (7, 30, 32)
    assert k2.dtype == k.dtype
    for x, x2 in ((k, k2), (v, v2)):
        step = x.abs().amax(dim=-1, keepdim=True) / 127.0
        assert bool(((x2 - x).abs() <= step + 1e-7).all())


class TestSchedulerPeerPrefill:
    def test_peer_fetch_seeds_local_cache_tokens_identical(
            self, world, donor, want_tokens):
        srv, _ = donor
        url = f"http://127.0.0.1:{srv.port}"
        local = _engine(world, prefix_cache_bytes=MB64)
        sched = Scheduler(local)
        got = _run_one(sched, prompt_ids=PROMPT, prefix_peer=url)
        assert got.output_ids == want_tokens
        assert sched._peer_client.fetches == 1
        assert local.prefix_cache.bytes > 0  # seeded by the fetch
        got2 = _run_one(sched, prompt_ids=PROMPT)
        assert got2.output_ids == want_tokens
        assert local.prefix_cache.hits >= 1
        assert sched._peer_client.fetches == 1  # no second fetch
        sched.update_gauges()
        text = sched.registry.render()
        assert "ome_engine_prefix_peer_fetches_total 1" in text

    def test_dead_peer_recomputes_locally(self, world, want_tokens):
        sched = Scheduler(_engine(world, prefix_cache_bytes=MB64))
        got = _run_one(sched, prompt_ids=PROMPT,
                       prefix_peer="http://127.0.0.1:9")
        assert got.output_ids == want_tokens
        assert got.finish_reason == "length"
        assert sched._peer_client.fallbacks >= 1
        assert sched._peer_client.fetches == 0

    def test_constrained_requests_skip_the_peer_path(self, world):
        from ome_tpu_torch.engine.schema import SchemaAutomaton
        from ome_tpu_torch.engine.structured import TokenMasker
        from ome_tpu_torch.engine.tokenizer import ByteTokenizer
        tok = ByteTokenizer()
        sched = Scheduler(_engine(world, prefix_cache_bytes=MB64))

        def boom(req, peer):  # pragma: no cover - the failure path
            raise AssertionError("peer path used for a masked request")

        sched._peer_prefill = boom
        schema = {"type": "object",
                  "properties": {"n": {"type": "integer"}},
                  "required": ["n"], "additionalProperties": False}
        masker = TokenMasker(tok, automaton=SchemaAutomaton(schema))
        req = _run_one(sched, prompt_ids=tok.encode("emit json"),
                       max_new_tokens=20, temperature=0.9,
                       prefix_peer="http://127.0.0.1:9",
                       masker=masker, stop_ids=[tok.eos_id])
        assert req.finish_reason in ("stop", "length")
        assert req.output_ids
