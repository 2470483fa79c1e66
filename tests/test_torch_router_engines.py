"""The port's router in front of engine replicas, against the reference's
router in front of the JAX engines (and both mixed fleets).

Two port `InferenceEngine`s and two JAX ones are built once for the
module (`tiny_test()`, fp32, max_seq_len 64, the port's weights bridged
from the reference's `llama.init_params(PRNGKey(0))`). For each pairing
of a router (reference or port) with a fleet (JAX or port engines), two
`EngineServer`s over that fleet are brought up on the SAME two ports,
so that every pairing routes over the same backend URLs and the
cache-aware rendezvous hash places a prompt on the same backend index
in all four. Held equal across the pairings, under `round_robin` and
`cache_aware`: each prompt's greedy completion (text and usage), the
index of the backend that served it, a stream's events, and failover
when backend 0 dies (both answers still served, backend 0 marked down,
the same router counters).

Then the advertise -> learn -> inject loop with the port's engines
behind the port's router, as tests/test_router.py's end-to-end test
does with the reference's: a replica with a prefix cache advertises the
digest of a prompt it served on /ready, a health sweep teaches the
router, and a forward landing on the other replica carries
X-OME-Prefix-Peer; that replica fetches the prefix KV from the owner
(one peer fetch) and answers with the owner's tokens.
"""

import json
import socket
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import ByteTokenizer as RefByteTokenizer
from ome_tpu.engine import EngineServer as RefEngineServer
from ome_tpu.engine import InferenceEngine as RefEngine
from ome_tpu.engine import Scheduler as RefScheduler
from ome_tpu.models import config as jcfgs
from ome_tpu.models import llama as jllama
from ome_tpu.router import server as ref_router
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.pd import make_pd_prefill_handler
from ome_tpu_torch.engine.scheduler import Scheduler
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.router import server as port_router

ROUTERS = {"reference": ref_router, "port": port_router}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def fleets():
    jcfg = jcfgs.tiny_test().replace(dtype=jnp.float32, max_seq_len=64)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=64)
    ports = [_free_port(), _free_port()]
    # two prompts the rendezvous hash puts on each port, the first again
    # last: under both policies they land on backends 0, 1, 0, 1, 0
    pick = port_router.Router([port_router.Backend(
        f"http://127.0.0.1:{p}") for p in ports])
    on = {0: [], 1: []}
    for i in range(200):
        prompt = f"prompt number {i}"
        url = pick.pick("engine", prompt).url
        on[int(url.endswith(f":{ports[1]}"))].append(prompt)
    prompts = [on[0][0], on[1][0], on[0][1], on[1][1], on[0][0]]
    return {
        "jax": [RefEngine(jparams, jcfg, max_slots=2,
                          prefill_buckets=[16, 32]) for _ in range(2)],
        "port": [InferenceEngine(tparams, tcfg, device="cpu", max_slots=2,
                                 prefill_buckets=[16, 32])
                 for _ in range(2)],
        "ports": ports, "prompts": prompts,
        "world": (tcfg, tparams),
    }


class _Fleet:
    """Two EngineServers over a fleet's engines on the shared ports."""

    def __init__(self, fleets, kind):
        self.servers = []
        for i, (eng, port) in enumerate(zip(fleets[kind],
                                            fleets["ports"])):
            if kind == "jax":
                srv = RefEngineServer(RefScheduler(eng),
                                      tokenizer=RefByteTokenizer(),
                                      model_name=f"m{i}", port=port)
            else:
                srv = EngineServer(Scheduler(eng),
                                   tokenizer=ByteTokenizer(),
                                   model_name=f"m{i}", port=port)
            srv.start()
            self.servers.append(srv)
        self.urls = [f"http://127.0.0.1:{p}" for p in fleets["ports"]]

    def stop(self):
        for s in self.servers:
            s.stop()


def _ask(base, prompt, stream=False):
    body = json.dumps({"prompt": prompt, "max_tokens": 6,
                       "temperature": 0.0, "stream": stream}).encode()
    req = urllib.request.Request(base + "/v1/completions", data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if stream:
            return [ln.decode().strip() for ln in r
                    if ln.startswith(b"data:")]
        return json.loads(r.read())


def _drive(fleets, router_side, kind, policy):
    """The prompts through one router over one fleet: what each answer
    was and which backend index served it; then failover."""
    mod = ROUTERS[router_side]
    fleet = _Fleet(fleets, kind)
    router = mod.Router([mod.Backend(u) for u in fleet.urls],
                        policy=policy, health_interval=3600)
    rs = mod.RouterServer(router, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{rs.port}"
    try:
        answers = []
        prompts = fleets["prompts"]
        for p in prompts:
            out = _ask(base, p)
            answers.append((out["choices"][0]["text"],
                            out["choices"][0].get("finish_reason"),
                            out["usage"], int(out["model"][1:])))
        events = [json.loads(e[len("data: "):])["choices"][0]["text"]
                  for e in _ask(base, prompts[1], stream=True)[:-1]]
        # backend 0 dies; two prompts whose rendezvous pick is the dead
        # URL (round robin reaches it within two asks anyway)
        dead = "http://127.0.0.1:9"
        pick = port_router.Router([port_router.Backend(dead),
                                   port_router.Backend(fleet.urls[1])])
        failover = [p for p in (f"failover {i}" for i in range(100))
                    if pick.pick("engine", p).url == dead][:2]
        router.backends[0].url = dead
        after = [_ask(base, p)["choices"][0]["text"] for p in failover]
        state = ([(b.healthy, b.cb_state, b.fails) for b in router.backends],
                 router.stats)
    finally:
        rs.stop()
        fleet.stop()
    return answers, "".join(events), after, state


@pytest.mark.parametrize("policy", ["round_robin", "cache_aware"])
def test_completions_equal_across_routers_and_fleets(fleets, policy):
    runs = {(r, k): _drive(fleets, r, k, policy)
            for r in ("reference", "port") for k in ("jax", "port")}
    want = runs[("reference", "jax")]
    for key, got in runs.items():
        assert got == want, key
    answers, streamed, after, (backends, stats) = want
    assert all(a[2]["completion_tokens"] == 6 for a in answers)
    assert streamed == answers[1][0]
    assert len(after) == 2 and all(after)
    assert backends[0][0] is False and backends[1][0] is True
    assert stats["retries_total"] >= 1
    assert [a[3] for a in answers] == [0, 1, 0, 1, 0]
    assert answers[0][:3] == answers[4][:3]    # the same prompt again


def test_advertise_learn_inject_with_port_engines(fleets):
    """The owner serves a prompt, advertises its digest; the router
    learns it on a health sweep; a request whose rendezvous pick is the
    other replica carries X-OME-Prefix-Peer, and that replica fetches
    the prefix from the owner and answers the owner's tokens."""
    cfg, params = fleets["world"]

    def engine():
        return InferenceEngine(params, cfg, device="cpu", max_slots=2,
                               prefill_buckets=[16, 32, 64],
                               prefix_cache_bytes=64 << 20)
    engines = [engine(), engine()]
    servers = [EngineServer(Scheduler(e), tokenizer=ByteTokenizer(),
                            model_name=f"m{i}",
                            pd_prefill=make_pd_prefill_handler(e))
               for i, e in enumerate(engines)]
    for s in servers:
        s.start()
    urls = [f"http://127.0.0.1:{s.port}" for s in servers]
    router = port_router.Router([port_router.Backend(u) for u in urls],
                                policy="cache_aware", health_interval=3600)
    rs = port_router.RouterServer(router, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{rs.port}"
    try:
        # a 42-byte prompt (one 32-token cached block) whose rendezvous
        # pick is replica 0; replica 1 will own it
        for i in range(1000):
            prompt = f"{i:04d} the shared conversation prefix, here!"
            key = port_router.affinity_from_payload({"prompt": prompt})
            if router.pick("engine", key).url == urls[0]:
                break
        assert len(prompt) == 42
        owner = _ask(urls[1], prompt)                 # served directly
        with urllib.request.urlopen(urls[1] + "/ready", timeout=30) as r:
            digs = json.loads(r.read())["prefix_digests"]
        d = port_router.prefix_digest(key)
        assert d in digs
        router.check_health_once()
        assert router.prefix_directory.lookup(d) == urls[1]
        got = _ask(base, prompt)
        assert router.stats["prefix_directory_hits_total"] == 1
        assert router.stats["prefix_directory_peer_fetches_total"] == 1
        assert got["model"] == "m0"
        client = servers[0].scheduler._peer_client
        assert client is not None and client.fetches == 1
        assert got["choices"][0]["text"] == owner["choices"][0]["text"]
        with urllib.request.urlopen(urls[0] + "/metrics", timeout=30) as r:
            assert "ome_engine_prefix_peer_fetches_total 1" in \
                r.read().decode()
        # the owner as the pick: a hit, no header
        router.prefix_directory.update(urls[0], [d])
        _ask(base, prompt)
        assert router.stats["prefix_directory_hits_total"] == 2
        assert router.stats["prefix_directory_peer_fetches_total"] == 1
    finally:
        rs.stop()
        for s in servers:
            s.stop()
