"""The port's router policy core against the reference's
(`ome_tpu_torch/router/server.py` vs `ome_tpu/router/server.py`).

One seeded script of events drives the reference's `Router` (with its
`Backend`s, `PrefixDirectory` and `ModelMap`) and the port's side by
side on one injected clock: picks with affinity keys over 2-5 backends
in both pools, request outcomes at given times, half-open probes with
their tokens (duplicate verdicts included), draining set and cleared,
backends added and removed, health sweeps whose probe bodies feed the
directory and the model map, a model catalog and advertisements. After
every event the picked URL, each backend's `(healthy, cb_state, fails,
cb_trips, draining, inflight)`, `router.stats`, the directory and the
model map are equal; at the end the rendered metrics are equal.

`random` needs no extra seeding: each `Router` draws from its own
`random.Random(0)`, made in its constructor, so two routers built the
same way draw the same sequence.

Also here: the affinity key and prefix digest the port's engine server
advertises equal the reference router's, the retry budget, service
discovery over the in-memory client and over a kube-apiserver (the
reference's fake one), and the two routers' command lines.
"""

import argparse
import random

import pytest

from ome_tpu import constants
from ome_tpu.core.fakeapiserver import FakeKubeApiServer
from ome_tpu.core.client import InMemoryClient as RefClient
from ome_tpu.core.k8s import Service as RefService
from ome_tpu.core.k8s import ServicePort as RefPort
from ome_tpu.core.k8s import ServiceSpec as RefSpec
from ome_tpu.core.meta import ObjectMeta as RefMeta
from ome_tpu.router import aserver as ref_aserver
from ome_tpu.router import server as ref
from ome_tpu_torch.core import kubeclient
from ome_tpu_torch.core.client import InMemoryClient
from ome_tpu_torch.core.k8s import Service, ServicePort, ServiceSpec
from ome_tpu_torch.core.meta import ObjectMeta
from ome_tpu_torch.engine import server as port_engine_server
from ome_tpu_torch.router import aserver as port_aserver
from ome_tpu_torch.router import server as port

URLS = [f"http://10.0.0.{i}:8080" for i in range(1, 8)]
MODELS = ["llama-8b", "qwen-7b", "mistral-7b"]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _router(mod, n, policy, seed):
    """A router over n backends whose pools come from the seed, on a
    clock of its own."""
    rng = random.Random(seed)
    specs = [(URLS[i], "decoder" if rng.random() < 0.3 else "engine")
             for i in range(n)]
    clock = _Clock()
    r = mod.Router([mod.Backend(u, pool) for u, pool in specs],
                   policy=policy, health_interval=3600, cb_threshold=2,
                   cb_cooldown=1.0, clock=clock)
    return r, clock


def _view(r):
    with r._lock:
        backends = [(b.url, b.pool, b.healthy, b.cb_state, b.fails,
                     b.cb_trips, b.draining, b.inflight,
                     b._probe_inflight, b.cb_open_until)
                    for b in r.backends]
    return {"backends": backends, "stats": r.stats,
            "directory": r.prefix_directory.export(),
            "models": r.model_map.export(),
            "fetch_bps": r.model_map.fetch_bps(),
            "snapshot": r.backend_snapshot()}


def _by_url(r, url):
    return next(b for b in r.backends if b.url == url)


KINDS = ["pick", "pick", "pick", "pick_model", "result", "result",
         "advance", "probe_fail", "drain", "undrain", "add", "remove",
         "sweep", "directory", "catalog", "advertise", "classify", "abort",
         "inflight", "retry_after"]


def _event(rng, r, clock, tokens):
    """One event drawn from `rng` and applied to router `r`; returns
    the event's kind and what the router answered (a URL, a verdict, a
    token, ...). The same generator state gives the same event."""
    kind = rng.choice(KINDS)
    urls = [b.url for b in r.backends]
    pool = rng.choice(["engine", "decoder"])
    key = rng.choice(["", "conv-1", "conv-2", "a long shared prefix",
                      f"k{rng.randrange(50)}"])
    url = rng.choice(urls)
    if kind == "advance":
        clock.t += rng.choice([0.1, 0.5, 1.5, 4.0, 20.0])
        return kind, clock.t
    if kind in ("pick", "pick_model"):
        excl = {url} if rng.random() < 0.2 else None
        model = rng.choice(MODELS) if kind == "pick_model" else None
        b = r.pick(pool, key, exclude=excl, model=model)
        if b is not None and b._probe_inflight:
            tokens.setdefault(b.url, []).append(b._probe_token)
        return kind, b.url if b else None
    if kind == "result":
        ok = rng.random() < 0.45
        r.note_result(_by_url(r, url), ok=ok)
        return kind, (url, ok)
    if kind == "probe_fail":
        # a half-open probe's verdict delivered twice (two routers
        # probing one backend): charged once per token
        b = _by_url(r, url)
        tok = (tokens.get(url) or [None])[-1]
        b.record_failure(clock(), probe_token=tok)
        b.record_failure(clock(), probe_token=tok)
        return kind, (url, tok)
    if kind == "drain":
        r.note_draining(_by_url(r, url))
        return kind, url
    if kind == "undrain":
        return kind, r.add_backend(url).url  # re-adding cancels a drain
    if kind == "add":
        return kind, r.add_backend(rng.choice(URLS), pool).url
    if kind == "remove":
        return kind, r.remove_backend(url) if len(urls) > 2 else None
    if kind == "sweep":
        # a health sweep whose probe answers come from the seed:
        # (healthy, draining, /ready body)
        answers = {}
        for u in urls:
            models = rng.sample(MODELS, k=rng.randrange(3))
            digs = [port.prefix_digest(f"k{rng.randrange(50)}")
                    for _ in range(rng.randrange(3))]
            answers[u] = (rng.random() < 0.8, rng.random() < 0.15,
                          {"prefix_digests": digs, "models": models,
                           "fetch_bps": rng.choice([0, 1e8, 5e8])})
        r._probe_backend = lambda b: answers[b.url]
        r.check_health_once()
        return kind, sorted(answers)
    if kind == "directory":
        d = port.prefix_digest(key or "k0")
        r.prefix_directory.update(url, [d, "", None])
        return kind, r.prefix_directory.lookup(d)
    if kind == "catalog":
        r.model_map.load_catalog({MODELS[0]: {
            "warmup_ms": 1500, "weight_bytes": 16_000_000_000}})
        return kind, r.model_map.enforcing()
    if kind == "advertise":
        r.model_map.advertise(url, [rng.choice(MODELS)],
                              rng.choice([None, 2e8]))
        return kind, sorted(r.model_map.models_of(url))
    if kind == "classify":
        verdict, who = r.classify_model(rng.choice(MODELS + ["x"]))
        return kind, (verdict, sorted(who) if who else who)
    if kind == "abort":
        r.probe_aborted(_by_url(r, url))
        return kind, url
    if kind == "inflight":
        b = _by_url(r, url)
        r.adjust_inflight(b, 1)
        r.adjust_inflight(b, rng.choice([0, -1]))
        return kind, b.inflight
    return kind, r.model_map.retry_after(MODELS[0])


@pytest.mark.parametrize("policy", ["cache_aware", "round_robin", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_machine_parity(policy, seed):
    n = random.Random(seed * 7 + len(policy)).randint(2, 5)
    r_ref, c_ref = _router(ref, n, policy, seed)
    r_port, c_port = _router(port, n, policy, seed)
    t_ref, t_port = {}, {}
    # a fixed prelude walks the first backend's breaker through every
    # state: two failures open it, the cooldown passes, a pick admits
    # one half-open probe (a second pick may not), the probe's failure
    # is delivered twice (the token gate holds only while half-open, so
    # the second verdict counts against the reopened breaker, in both),
    # the longer cooldown passes, a second probe succeeds and closes it
    for r, clock in ((r_ref, c_ref), (r_port, c_port)):
        b = r.backends[0]
        others = [o for o in r.backends[1:] if o.pool == b.pool]
        for o in others:
            r.note_draining(o)
        seen = []
        r.note_result(b, ok=False)
        r.note_result(b, ok=False)
        seen.append((b.cb_state, r.pick(b.pool, "p")))
        clock.t += 1.5
        first = r.pick(b.pool, "p")
        seen.append((b.cb_state, first.url, b._probe_token,
                     r.pick(b.pool, "p")))
        tok = b._probe_token
        b.record_failure(clock(), probe_token=tok)
        b.record_failure(clock(), probe_token=tok)
        seen.append((b.cb_state, b.cb_trips, b.fails,
                     b.cb_open_until - clock()))
        clock.t += 4.5
        seen.append((r.pick(b.pool, "p").url, b.cb_state))
        r.note_result(b, ok=True)
        seen.append((b.cb_state, b.cb_trips, b.fails))
        for o in others:
            r.add_backend(o.url)
        (t_ref if r is r_ref else t_port)["prelude"] = seen
    assert t_ref == t_port
    assert t_ref["prelude"][0] == ("open", None)
    assert t_ref["prelude"][2] == ("open", 3, 4, 4.0)
    assert t_ref["prelude"][-1] == ("closed", 0, 0)
    assert _view(r_ref) == _view(r_port)
    kinds = set()
    for step in range(400):
        # the event is drawn twice from one generator state: the same
        # event for both routers
        got_ref = _event(random.Random(seed * 100003 + step), r_ref,
                         c_ref, t_ref)
        got_port = _event(random.Random(seed * 100003 + step), r_port,
                          c_port, t_port)
        assert got_ref == got_port, step
        assert _view(r_ref) == _view(r_port), (step, got_ref[0])
        kinds.add(got_ref[0])
    assert kinds == set(KINDS)
    assert t_ref == t_port
    assert r_ref.stats["circuit_open_total"] > 0
    r_ref.update_gauges()
    r_port.update_gauges()
    assert r_ref.registry.render() == r_port.registry.render()


def test_random_policy_draws_the_same_sequence():
    r_ref, _ = _router(ref, 5, "random", 3)
    r_port, _ = _router(port, 5, "random", 3)
    a = [getattr(r_ref.pick(p, "k"), "url", None)
         for p in ["engine", "decoder"] * 50]
    b = [getattr(r_port.pick(p, "k"), "url", None)
         for p in ["engine", "decoder"] * 50]
    assert a == b
    assert len({u for u in a if u}) > 1


def _directory_and_map(mod):
    views = []
    d = mod.PrefixDirectory(max_entries=3)
    d.update("http://a", ["d1", "d2"])
    d.update("http://b/", ["d2"])
    d.update("http://a", ["d3", "d4"])
    d.update("http://a", "not-a-list")
    views.append((d.export(), len(d), d.lookup("d1"), d.lookup("d2")))
    d.forget("http://a")
    views.append((d.export(), len(d)))
    m = mod.ModelMap()
    m.advertise("http://a", ["m1", "m2", "", 3], fetch_bps=1e8)
    m.advertise("http://b", ["m2"], fetch_bps=3e8)
    m.load_catalog({"m3": {"warmup_ms": 2500, "weight_bytes": 4e9}})
    views.append((m.export(), m.backend_counts(), m.fetch_bps(),
                  m.retry_after("m3"), m.retry_after("m1"),
                  sorted(m.backends_for("m2")), m.active(), m.enforcing()))
    return views


def test_prefix_directory_and_model_map_parity():
    assert _directory_and_map(ref) == _directory_and_map(port)


def test_retry_budget_parity():
    a, b = ref.RetryBudget(ratio=0.3, burst=2.0), \
        port.RetryBudget(ratio=0.3, burst=2.0)
    rng = random.Random(5)
    for _ in range(300):
        if rng.random() < 0.5:
            a.deposit()
            b.deposit()
        else:
            assert a.withdraw() == b.withdraw()
        assert a._tokens == b._tokens


PAYLOADS = [
    {"prompt": "hello world"},
    {"prompt": "x" * 600},
    {"prompt": [1, 2, 3, 17, 255]},
    {"prompt": list(range(400))},
    {"prompt": ""},
    {"messages": [{"role": "user", "content": "hi"}]},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "a" * 300},
                  {"role": "assistant", "content": "ignored third"}]},
    {"messages": []},
    {"max_tokens": 3},
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_engine_digest_equals_the_reference_routers(i):
    """The one copy: the port's engine server takes the router's key and
    digest, and they equal the reference router's for prompt strings,
    token lists and chat messages."""
    payload = PAYLOADS[i]
    assert port_engine_server.affinity_from_payload is \
        port.affinity_from_payload
    assert port_engine_server.prefix_digest is port.prefix_digest
    key = ref.affinity_from_payload(payload)
    assert port.affinity_from_payload(payload) == key
    assert port_engine_server.prefix_digest(key) == ref.prefix_digest(key)


def _services(meta, svc, spec, sport):
    out = []
    for name, comp, p in (("svc-engine", "engine", 8080),
                          ("svc-engine-b", "engine", 9000),
                          ("svc-decoder", "decoder", 8081),
                          ("other", "router", 8000)):
        out.append(svc(metadata=meta(
            name=name, namespace="prod",
            labels={constants.COMPONENT_LABEL: comp}),
            spec=spec(ports=[sport(name="http", port=p)])))
    out.append(svc(metadata=meta(name="noport", namespace="prod",
                                 labels={constants.COMPONENT_LABEL:
                                         "engine"})))
    out.append(svc(metadata=meta(name="elsewhere", namespace="dev",
                                 labels={constants.COMPONENT_LABEL:
                                         "engine"}),
                   spec=spec(ports=[sport(port=1)])))
    return out


def _backends(bs):
    return [(b.url, b.pool) for b in bs]


@pytest.mark.parametrize("comp", ["engine", "decoder", "router"])
def test_discovery_over_the_in_memory_client(comp):
    rc, pc = RefClient(), InMemoryClient()
    for s in _services(RefMeta, RefService, RefSpec, RefPort):
        rc.create(s)
    for s in _services(ObjectMeta, Service, ServiceSpec, ServicePort):
        pc.create(s)
    sel = {constants.COMPONENT_LABEL: comp}
    want = _backends(ref.discover_backends(rc, "prod", sel, comp))
    got = _backends(port.discover_backends(pc, "prod", sel, comp))
    assert got == want and want
    if comp == "engine":
        assert want == [
            ("http://noport.prod.svc.cluster.local:8080", "engine"),
            ("http://svc-engine.prod.svc.cluster.local:8080", "engine"),
            ("http://svc-engine-b.prod.svc.cluster.local:9000", "engine")]


def test_kubeclient_lists_services_from_a_kube_apiserver():
    """The port's KubeClient against the reference's fake apiserver:
    Services by selector, the same URLs as the reference's discovery
    over the store behind it; a CRD kind is refused by name."""
    from ome_tpu.apis import v1
    rc = RefClient()
    for s in _services(RefMeta, RefService, RefSpec, RefPort):
        rc.create(s)
    api = FakeKubeApiServer(rc).start()
    try:
        args = argparse.Namespace(kube_server=api.url, kubeconfig=None,
                                  in_cluster=False)
        from ome_tpu_torch.cmd.manager import build_client
        client = build_client(args)
        assert isinstance(client, kubeclient.KubeClient)
        for comp in ("engine", "decoder"):
            sel = {constants.COMPONENT_LABEL: comp}
            assert _backends(port.discover_backends(
                client, "prod", sel, comp)) == _backends(
                ref.discover_backends(rc, "prod", sel, comp))
        every = client.list(Service)
        assert [s.metadata.name for s in every] == [
            "elsewhere", "noport", "other", "svc-decoder", "svc-engine",
            "svc-engine-b"]
        assert client.list(Service, namespace="dev")[0].spec.ports[0].port \
            == 1
        with pytest.raises(kubeclient.UnsupportedKindError,
                           match="InferenceService"):
            client.list(v1.InferenceService, namespace="prod")
        with pytest.raises(kubeclient.UnsupportedKindError,
                           match="Service"):
            client.list(RefService)  # the reference's class, not ours
    finally:
        api.stop()


def test_build_client_defaults_to_the_in_memory_store():
    from ome_tpu_torch.cmd.manager import build_client
    c = build_client(argparse.Namespace(kube_server=None, kubeconfig=None,
                                        in_cluster=False))
    assert isinstance(c, InMemoryClient)


def _parser_of(main, monkeypatch):
    """The ArgumentParser a main() builds, caught at parse_args."""
    seen = {}

    class _Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        seen["p"] = self
        raise _Caught
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Caught):
        main([])
    monkeypatch.undo()
    p = seen["p"]
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     type(a).__name__, a.type)
            for a in p._actions if a.dest != "help"}


@pytest.mark.parametrize("which", ["server", "aserver"])
def test_main_defines_every_reference_flag(which, monkeypatch):
    mods = {"server": (ref.main, port.main),
            "aserver": (ref_aserver.main, port_aserver.main)}[which]
    want = _parser_of(mods[0], monkeypatch)
    got = _parser_of(mods[1], monkeypatch)
    assert got == want


def test_main_refuses_no_backend(capsys):
    with pytest.raises(SystemExit) as ei:
        port.main(["--port", "0"])
    assert ei.value.code == 2
    assert "--backend or --engine-selector" in capsys.readouterr().err


def test_router_package_entry_points():
    """`python -m ome_tpu_torch.router` and `...router.aserver` start
    from the port alone: with no jax and no ome_tpu importable, each
    parses its command line (no backend: the reference's refusal)."""
    import os
    import subprocess
    import sys
    import ome_tpu_torch.router as pkg
    assert pkg.main is port.main and pkg.RouterServer is port.RouterServer
    blocker = ("import sys\n"
               "class _No:\n"
               "    def find_spec(self, name, path=None, target=None):\n"
               "        if name.split('.')[0] in ('jax', 'jaxlib', "
               "'ome_tpu'):\n"
               "            raise ImportError('blocked: ' + name)\n"
               "sys.meta_path.insert(0, _No())\n"
               "import runpy\n"
               "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
               "runpy.run_module(sys.argv[0], run_name='__main__', "
               "alter_sys=True)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    for mod in ("ome_tpu_torch.router", "ome_tpu_torch.router.aserver"):
        proc = subprocess.run(
            [sys.executable, "-c", blocker, mod, "--port", "0"],
            capture_output=True, text=True, timeout=120, env=env)
        assert proc.returncode == 2, proc.stderr
        assert "--backend or --engine-selector is" in proc.stderr
        assert "blocked" not in proc.stderr
