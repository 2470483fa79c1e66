"""The port's deploy manifests (`ome_tpu_torch/deploy/`): the H100
AcceleratorClass, the six ClusterServingRuntimes and the image.

* Each manifest loads through the reference's `v1` types and passes its
  admission (`validate_serving_runtime`), the runtimes side by side.
* Each runtime is the counterpart of its reference runtime under
  `config/runtimes/ome/`: the same model formats, size range and engine
  arguments, on the H100 class with `nvidia.com/gpu: "1"` and no TPU.
* Each engine argument parses under the port's `serve` parser and
  passes its slice checks; each router argument under the port's
  router parser.
* The reference's in-memory manager reconciles a Llama-3-8B
  InferenceService on an H100-only cluster into an engine container
  that runs `ome_tpu_torch.engine.serve` with `nvidia.com/gpu: "1"` and
  no `google.com/tpu`, scheduled by the class's node label; and a PD
  InferenceService on the PD runtime into prefill and decode containers
  on a card each and a router container that runs
  `ome_tpu_torch.router`.
"""

import os
import re
import shlex

import pytest

from ome_tpu.apis import v1
from ome_tpu.cmd.manifests import load_path
from ome_tpu.controllers.acceleratorclass import AcceleratorClassReconciler
from ome_tpu.controllers.inferenceservice import InferenceServiceReconciler
from ome_tpu.core.client import InMemoryClient
from ome_tpu.core.k8s import Deployment, Node
from ome_tpu.core.manager import Manager
from ome_tpu.core.meta import ObjectMeta
from ome_tpu.webhooks.admission import validate_serving_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "ome_tpu_torch", "deploy")
REF_RUNTIMES = os.path.join(REPO, "config", "runtimes", "ome")
COUNTERPARTS = ("ome-engine-small", "ome-engine-embeddings",
                "ome-engine-int4", "ome-engine-int8", "ome-engine-paged",
                "ome-engine-pd-mistral")
H100 = "nvidia-h100-80gb"
GKE_GPU_LABEL = "cloud.google.com/gke-accelerator"


@pytest.fixture(scope="module")
def catalog():
    objs = load_path(DEPLOY, skip_unknown=False)
    client = InMemoryClient()
    for o in objs:
        client.create(o)
    return client, objs


def _runtime(client, name):
    return client.get(v1.ClusterServingRuntime, f"{name}-h100")


def _runners(rt):
    spec = rt.spec
    out = [("engine", spec.engine_config.runner)]
    if spec.decoder_config is not None:
        out.append(("decoder", spec.decoder_config.runner))
    if spec.router_config is not None:
        out.append(("router", spec.router_config.runner))
    return out


def test_the_accelerator_class(catalog):
    client, objs = catalog
    kinds = sorted(type(o).KIND for o in objs)
    assert kinds == ["AcceleratorClass"] + ["ClusterServingRuntime"] * 6
    ac = client.get(v1.AcceleratorClass, H100)
    assert (ac.spec.vendor, ac.spec.family) == ("nvidia", "gpu")
    assert ac.spec.discovery.node_selector == {GKE_GPU_LABEL: H100}
    caps = ac.spec.capabilities
    assert ac.spec.resources == {"nvidia.com/gpu": "1"}
    # the rates are the port's ledger row, the roofline it reads
    from ome_tpu_torch.perf import ledger
    assert (caps.memory_gb, caps.memory_bandwidth_gbps, caps.bf16_tflops) \
        == (80, ledger.DEVICE_HBM_GBPS["h100"],
            ledger.DEVICE_PEAK_TFLOPS["h100"]) == (80, 3350, 989)


@pytest.mark.parametrize("name", COUNTERPARTS)
def test_runtime_passes_admission_and_mirrors_its_reference(catalog, name):
    client, _ = catalog
    rt = _runtime(client, name)
    validate_serving_runtime(client, rt, cluster_scoped=True)
    ref = load_path(os.path.join(REF_RUNTIMES, f"{name}-rt.yaml"))[0]
    fmt = [(f.name, f.model_architecture, f.priority, f.quantization,
            f.auto_select) for f in rt.spec.supported_model_formats]
    assert fmt == [(f.name, f.model_architecture, f.priority,
                    f.quantization, f.auto_select)
                   for f in ref.spec.supported_model_formats]
    assert rt.spec.model_size_range == ref.spec.model_size_range
    assert rt.spec.protocol_versions == ref.spec.protocol_versions
    req = rt.spec.accelerator_requirements
    assert req.accelerator_classes == [H100]
    assert req.min_chips == ref.spec.accelerator_requirements.min_chips
    refs = dict(_runners(ref))
    for role, runner in _runners(rt):
        if role == "router":
            assert runner.command == ["python", "-m",
                                      "ome_tpu_torch.router"]
            assert runner.args[:4] == refs[role].args
            assert rt.spec.router_config.config == \
                ref.spec.router_config.config
            continue
        assert runner.command == ["python", "-m",
                                  "ome_tpu_torch.engine.serve"]
        assert runner.args == refs[role].args
        assert runner.resources.requests == {"nvidia.com/gpu": "1"}
        assert runner.resources.limits == {"nvidia.com/gpu": "1"}


def test_no_tpu_anywhere_in_the_port_manifests():
    for root, _, files in os.walk(DEPLOY):
        for fn in files:
            text = open(os.path.join(root, fn)).read()
            assert "google.com/tpu" not in text, fn
            assert "ome_tpu.engine" not in text, fn
            assert "ome_tpu.router" not in text, fn


def _engine_args(runner):
    """The runner's args with the reconciler's placeholders filled, as a
    pod would run them."""
    return [re.sub(r"\$\((\w+)\)", lambda m: {
        "MODEL_PATH": "/mnt/models/m",
        "PREFILL_SERVICE_URL": "http://m-engine.prod.svc.cluster.local:8080",
    }[m.group(1)], a) for a in runner.args]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", COUNTERPARTS)
def test_every_argument_parses_under_the_port(catalog, name, monkeypatch):
    from ome_tpu_torch.cmd import manager
    from ome_tpu_torch.engine import serve
    from ome_tpu_torch.router import server as router
    client, _ = catalog
    for role, runner in _runners(_runtime(client, name)):
        if role == "router":
            args = [a.replace("$(ENGINE_SELECTOR)", "a=b").replace(
                "$(DECODER_SELECTOR)", "a=c") for a in runner.args]
            seen = {}

            def capture(backends, **kw):
                seen.update(kw, backends=backends)
                raise _Stop
            # the router's command line through its main(), up to the
            # Router it would build; discovery lists an in-memory store
            # (no cluster here) beside one static backend
            build = manager.build_client
            monkeypatch.setattr(router, "Router", capture)
            monkeypatch.setattr(manager, "build_client", lambda a: build(
                type(a)(**{**vars(a), "in_cluster": False})))
            with pytest.raises(_Stop):
                router.main(args + ["--backend", "http://x:1"])
            assert seen["policy"] == "cache_aware"
            assert [b.url for b in seen["backends"]] == ["http://x:1"]
            continue
        ns = serve.build_parser().parse_args(_engine_args(runner))
        serve.check_slice(ns)
        assert ns.device == "cuda"


def _h100_cluster():
    client = InMemoryClient()
    for o in load_path(DEPLOY):
        client.create(o)
    for name in ("meta/llama-3-1-8b-instruct",
                 "mistralai/mistral-7b-instruct-v0-3"):
        for o in load_path(os.path.join(REPO, "config", "models",
                                        f"{name}.yaml")):
            client.create(o)
    for i in range(2):
        n = Node(metadata=ObjectMeta(name=f"h100-{i}",
                                     labels={GKE_GPU_LABEL: H100}))
        n.status.capacity = n.status.allocatable = {"nvidia.com/gpu": "8"}
        client.create(n)
    mgr = Manager(client)
    mgr.register(AcceleratorClassReconciler(client))
    mgr.register(InferenceServiceReconciler(client))
    return client, mgr


def _containers(client, ns):
    return {d.metadata.name: (d.spec.template.spec.containers[0],
                              d.spec.template.spec.node_selector)
            for d in client.list(Deployment, namespace=ns)}


def test_reconciles_llama_8b_onto_one_h100():
    client, mgr = _h100_cluster()
    isvc = v1.InferenceService(metadata=ObjectMeta(name="llama",
                                                   namespace="default"))
    isvc.spec.model = v1.ModelRef(name="llama-3-1-8b-instruct")
    isvc.spec.engine = v1.EngineSpec()
    client.create(isvc)
    mgr.reconcile_once()
    ac = client.get(v1.AcceleratorClass, H100)
    assert ac.status.node_count == 2
    (c, selector), = _containers(client, "default").values()
    assert c.command == ["python", "-m", "ome_tpu_torch.engine.serve"]
    assert c.resources.requests == c.resources.limits == \
        {"nvidia.com/gpu": "1"}
    assert "google.com/tpu" not in str(c.resources)
    assert selector[GKE_GPU_LABEL] == H100
    assert not any("tpu" in k for k in selector)
    assert c.args[:2] == ["--model-dir",
                          "/mnt/models/llama-3-1-8b-instruct"]
    from ome_tpu_torch.engine import serve
    serve.check_slice(serve.build_parser().parse_args(c.args))


def test_reconciles_the_pd_runtime_with_the_ports_router():
    client, mgr = _h100_cluster()
    isvc = v1.InferenceService(metadata=ObjectMeta(name="mis",
                                                   namespace="prod"))
    isvc.spec.model = v1.ModelRef(name="mistral-7b-instruct-v0-3")
    isvc.spec.engine = v1.EngineSpec()
    isvc.spec.decoder = v1.EngineSpec()
    isvc.spec.router = v1.RouterSpec()
    isvc.spec.runtime = v1.RuntimeRef(name="ome-engine-pd-mistral-h100")
    client.create(isvc)
    mgr.reconcile_once()
    got = _containers(client, "prod")
    assert sorted(got) == ["mis-decoder", "mis-engine", "mis-router"]
    for role in ("mis-engine", "mis-decoder"):
        c, selector = got[role]
        assert c.command == ["python", "-m", "ome_tpu_torch.engine.serve"]
        assert c.resources.requests == {"nvidia.com/gpu": "1"}
        assert selector[GKE_GPU_LABEL] == H100
    dec = got["mis-decoder"][0]
    assert dec.args[dec.args.index("--prefill-peer") + 1] == \
        "http://mis-engine.prod.svc.cluster.local:8080"
    router, _ = got["mis-router"]
    assert router.command == ["python", "-m", "ome_tpu_torch.router"]
    assert router.resources is None           # the router takes no card
    env = {e.name: e.value for e in router.env}
    assert env["ENGINE_SELECTOR"] == \
        "serving.ome.io/inferenceservice=mis,component.ome.io/name=engine"
    # the kubelet expands $(ENGINE_SELECTOR) from that env
    line = " ".join(shlex.quote(a) for a in router.args)
    assert "--engine-selector '$(ENGINE_SELECTOR)'" in line
    assert "--policy cache_aware" in line


def test_dockerfile_builds_the_port_on_a_cuda_devel_base():
    text = open(os.path.join(DEPLOY, "Dockerfile")).read()
    base = re.search(r"^FROM (\S+)", text, re.M).group(1)
    assert base.startswith("nvidia/cuda:") and "-devel-" in base
    assert "COPY ome_tpu_torch/" in text
    installs = " ".join(ln for ln in text.splitlines()
                        if not ln.startswith("#"))
    assert "COPY ome_tpu/" not in installs
    assert "jax" not in installs.lower()
    assert '"ome_tpu_torch.engine.serve"' in text
