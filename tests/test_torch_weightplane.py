"""The port's weight plane (ome_tpu_torch/modelagent/weightplane.py)
against the JAX package's (ome_tpu/modelagent/weightplane.py).

* the cases of tests/test_modelfleet.py::TestWeightPlane run in both
  packages on the same seeded tree, each with its own package's fault
  points, and give equal results: the round trip, resume from verified
  objects, corrupt staged bytes re-fetched, the verify fault, the
  publish fault, the manifest requirement, the atomic replace, retries
  with backoff, `backoff_delay` for the same rng, and REUSE (only a
  published tree counts, a partial one does not);
* a tree either package publishes is `is_published` to the other, with
  the same manifest and `published_fetch_bps`; the CLIs print the same
  stats keys and publish the same bytes;
* the chaos harness's kill episode, `run_weight_kill_episode(7, ...)`,
  holds its three invariants over the port's CLI, and loads nothing of
  `ome_tpu` while it runs;
* serve: a port engine serving a tiny fp32 tree the port's weight plane
  published answers `/ready` with the reference's `published_fetch_bps`
  of that tree, `0.0` for a tree without a manifest, and its greedy
  streams equal the JAX engine's on the same params.
"""

import json
import os
import pathlib
import random
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu import faults as jfaults
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu.modelagent import weightplane as jwp
from ome_tpu.storage import providers as jproviders
from ome_tpu_torch import chaos, faults
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.scheduler import Request
from ome_tpu_torch.modelagent import weightplane as wp
from ome_tpu_torch.models import checkpoint
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.storage import providers

REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"ref": (jwp, jfaults, jproviders), "port": (wp, faults, providers)}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _make_source(root, n=6, kb=4, seed=3):
    """tests/test_modelfleet.py's seeded source tree."""
    rng = random.Random(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        size = kb * 1024 + rng.randrange(kb * 1024)
        (root / f"shard-{i:02d}.bin").write_bytes(
            rng.getrandbits(8 * size).to_bytes(size, "little"))
    return root


def _tree_bytes(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())
            if p.is_file() and not p.name.startswith(".ome_fetch_")}


def _manifest(wmod, tree):
    m = wmod.FetchManifest.load(str(tree))
    if m is None:
        return None
    return {"objects": m.objects, "complete": m.complete,
            "total_bytes": m.total_bytes, "attempts": m.attempts}


def _stats(s):
    return {k: v for k, v in s.items() if k not in ("seconds", "bps")}


# After a failed object the pool cancels what has not started, so how
# many objects a failed attempt records depends on the worker's timing:
# the cases below return what holds whatever the timing.


def _staged_facts(w, staging, victim, n):
    m = w.FetchManifest.load(str(staging))
    return {"victim_recorded": victim in m.objects,
            "some_not_all": 0 < len(m.objects) < n,
            "complete": m.complete}, len(m.objects)


# -- tests/test_modelfleet.py::TestWeightPlane, in both packages -------------


def _roundtrip(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    target = tmp / "model"
    stats = w.fetch_and_publish(st, "", st.list(""), str(target), name="m")
    assert _tree_bytes(target) == _tree_bytes(src)
    assert w.published_fetch_bps(str(target)) > 0
    return (_stats(stats), w.is_published(str(target)),
            os.path.exists(w.staging_dir(str(target))),
            _manifest(w, target))


def _resume_from_verified(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    expected = st.list("")
    target = tmp / "model"
    f.install(f"weight_fetch|{expected[3].name}.raise@1:1")
    try:
        with pytest.raises(f.InjectedFault):
            w.fetch_tree(st, "", expected, str(target), workers=1)
    finally:
        f.reset()
    staged, before = _staged_facts(w, w.staging_dir(str(target)),
                                   expected[3].name, len(expected))
    visible = (os.path.exists(target), w.is_published(str(target)))
    stats = w.fetch_tree(st, "", expected, str(target), workers=1)
    w.publish(str(target), name="m")
    assert _tree_bytes(target) == _tree_bytes(src)
    return (staged, visible, stats["resumed"] == before,
            stats["fetched"] == len(expected) - before, _manifest(w, target))


def _corrupt_staged_refetched(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    expected = st.list("")
    target = tmp / "model"
    f.install(f"weight_fetch|{expected[-1].name}.raise@1:1")
    try:
        with pytest.raises(f.InjectedFault):
            w.fetch_tree(st, "", expected, str(target), workers=1)
    finally:
        f.reset()
    staging = pathlib.Path(w.staging_dir(str(target)))
    corrupt = sorted(w.FetchManifest.load(str(staging)).objects)[0]
    good = (staging / corrupt).read_bytes()
    (staging / corrupt).write_bytes(b"\x00" * len(good))
    stats = w.fetch_tree(st, "", expected, str(target), workers=1)
    w.publish(str(target), name="m")
    assert _tree_bytes(target) == _tree_bytes(src)
    return _stats(stats), _manifest(w, target)


def _verify_fault(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    expected = st.list("")
    target = tmp / "model"
    f.install(f"weight_verify|{expected[0].name}.raise@1:1")
    try:
        with pytest.raises(w.WeightVerifyError):
            w.fetch_tree(st, "", expected, str(target), workers=1)
    finally:
        f.reset()
    m = w.FetchManifest.load(w.staging_dir(str(target)))
    return expected[0].name in m.objects, m.complete, m.attempts


def _publish_fault(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    target = tmp / "model"
    f.install("model_publish|m.raise@1:1")
    try:
        with pytest.raises(w.PublishError):
            w.fetch_and_publish(st, "", st.list(""), str(target), name="m",
                                retries=1)
    finally:
        f.reset()
    before = (os.path.exists(target),
              _manifest(w, w.staging_dir(str(target))))
    w.publish(str(target), name="m")
    assert _tree_bytes(target) == _tree_bytes(src)
    return before, w.is_published(str(target)), _manifest(w, target)


def _publish_requires_manifest(w, f, p, tmp):
    target = tmp / "model"
    staging = pathlib.Path(w.staging_dir(str(target)))
    staging.mkdir(parents=True)
    (staging / "w.bin").write_bytes(b"x")
    with pytest.raises(w.PublishError) as e:
        w.publish(str(target), name="m")
    return str(e.value).replace(str(tmp), "<t>"), os.path.exists(target)


def _atomic_replace(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    target = tmp / "model"
    w.fetch_and_publish(st, "", st.list(""), str(target), name="m")
    (src / "shard-00.bin").write_bytes(b"v2" * 700)
    st2 = p.LocalStorage(str(src))
    stats = w.fetch_and_publish(st2, "", st2.list(""), str(target), name="m")
    assert _tree_bytes(target) == _tree_bytes(src)
    return (_stats(stats), w.is_published(str(target)),
            os.path.exists(str(target) + ".trash"), _manifest(w, target))


def _retry_with_backoff(w, f, p, tmp):
    src = _make_source(tmp / "src")
    st = p.LocalStorage(str(src))
    expected = st.list("")
    target = tmp / "model"
    sleeps = []
    f.install(f"weight_fetch|{expected[0].name}.raise@1:1")
    try:
        stats = w.fetch_and_publish(st, "", expected, str(target), name="m",
                                    retries=3, rng=random.Random(0),
                                    sleep=sleeps.append, workers=1)
    finally:
        f.reset()
    assert _tree_bytes(target) == _tree_bytes(src)
    return (stats["published"], stats["resumed"] + stats["fetched"],
            sleeps, _manifest(w, target))


def _backoff_delay(w, f, p, tmp):
    rng = random.Random(7)
    delays = [w.backoff_delay(a, rng, base=0.5, cap=30.0)
              for a in range(12) for _ in range(20)]
    assert all(0.25 <= d <= 30.0 for d in delays)
    late = [w.backoff_delay(9, rng) for _ in range(50)]
    assert max(late) > 10
    return delays, late


def _reuse(w, f, p, tmp):
    """REUSE: a non-empty tree a killed download left is not a
    download; the published tree is, until it is replaced."""
    src = _make_source(tmp / "src")
    target = tmp / "models" / "m1"
    target.mkdir(parents=True)
    (target / "shard-00.bin").write_bytes(b"partial garbage")
    partial = w.is_published(str(target))
    st = p.LocalStorage(str(src))
    w.fetch_and_publish(st, "", st.list(""), str(target), name="m1")
    assert _tree_bytes(target) == _tree_bytes(src)
    return partial, w.is_published(str(target)), \
        w.published_manifest(str(target)) is not None


CASES = [_roundtrip, _resume_from_verified, _corrupt_staged_refetched,
         _verify_fault, _publish_fault, _publish_requires_manifest,
         _atomic_replace, _retry_with_backoff, _backoff_delay, _reuse]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[1:])
def test_weight_plane_case_equals_reference(case, tmp_path):
    got = {tag: case(*mods, tmp_path / tag) for tag, mods in PKGS.items()}
    assert got["port"] == got["ref"]


# -- one on-disk format --------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_a_published_tree_is_published_to_the_other(tmp_path, writer,
                                                    reader):
    w, _, p = PKGS[writer]
    r = PKGS[reader][0]
    src = _make_source(tmp_path / "src", n=5)
    st = p.LocalStorage(str(src))
    target = tmp_path / "model"
    w.fetch_and_publish(st, "", st.list(""), str(target), name="m")
    assert r.is_published(str(target))
    assert r.published_fetch_bps(str(target)) == \
        w.published_fetch_bps(str(target)) > 0
    assert _manifest(r, target) == _manifest(w, target)
    assert r.MANIFEST_NAME == w.MANIFEST_NAME == ".ome_fetch_manifest.json"
    assert r.MANIFEST_SCHEMA == w.MANIFEST_SCHEMA == 1
    # a staged, unpublished tree is published to neither
    partial = tmp_path / "partial"
    w.fetch_tree(st, "", st.list(""), str(partial))
    assert not r.is_published(w.staging_dir(str(partial)))
    assert not r.is_published(str(partial))
    # the reader publishes the writer's staging, and the writer reads it
    r.publish(str(partial), name="m")
    assert w.is_published(str(partial))
    assert _tree_bytes(partial) == _tree_bytes(src)
    # seal_tree over a materialized staging tree: the same manifest
    for tag, (mod, _, _) in PKGS.items():
        stage = pathlib.Path(mod.staging_dir(str(tmp_path / f"sealed-{tag}")))
        stage.mkdir(parents=True)
        for name, data in _tree_bytes(src).items():
            (stage / name).write_bytes(data)
        mod.seal_tree(str(stage), fetch_seconds=2.0)
        mod.publish(str(tmp_path / f"sealed-{tag}"), name="m")
    assert _manifest(jwp, tmp_path / "sealed-port") == \
        _manifest(wp, tmp_path / "sealed-ref")
    assert wp.published_fetch_bps(str(tmp_path / "sealed-ref")) == \
        jwp.published_fetch_bps(str(tmp_path / "sealed-port"))


def test_the_clis_print_the_same_stats(tmp_path):
    src = _make_source(tmp_path / "src", n=4)
    got = {}
    for tag, module in (("ref", "ome_tpu.modelagent.weightplane"),
                        ("port", "ome_tpu_torch.modelagent.weightplane")):
        r = subprocess.run(
            [sys.executable, "-m", module, "--source", f"local://{src}",
             "--target", str(tmp_path / tag), "--name", "m"],
            capture_output=True, text=True, timeout=120, cwd=str(REPO),
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
        got[tag] = _stats(json.loads(r.stdout.strip().splitlines()[-1]))
        assert wp.is_published(str(tmp_path / tag))
        assert _tree_bytes(tmp_path / tag) == _tree_bytes(src)
    assert got["port"] == got["ref"]
    assert got["port"]["published"] and got["port"]["fetched"] == 4
    empty = tmp_path / "empty"
    empty.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "ome_tpu_torch.modelagent.weightplane",
         "--source", f"local://{empty}", "--target", str(tmp_path / "e")],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 2 and json.loads(r.stdout) == {
        "error": "no objects"}


# -- the chaos harness's kill episode ------------------------------------------


def test_weight_kill_episode_holds_its_invariants(tmp_path):
    assert chaos.run_weight_kill_episode(7, tmp_path, n_objects=16, obj_kb=4,
                                         slow_s=0.05) == []
    # the re-run published the seed's tree at the serving path
    assert wp.is_published(str(tmp_path / "served" / "model"))
    assert jwp.is_published(str(tmp_path / "served" / "model"))


def test_weight_kill_episode_loads_nothing_of_the_reference(tmp_path):
    code = (
        "import sys, json\n"
        "from ome_tpu_torch import chaos\n"
        f"v = chaos.run_weight_kill_episode(3, {str(tmp_path)!r}, "
        "n_objects=8, obj_kb=4, slow_s=0.05)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'torch') or (m.startswith('ome_tpu') and "
        "not m.startswith('ome_tpu_torch'))]\n"
        "print(json.dumps({'violations': v, 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "violations": [], "bad": []}


# -- serve: /ready's fetch_bps and the streams -----------------------------------


MAX_SEQ = 128
JCFG = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ,
                          num_layers=2)
TCFG = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ,
                           num_layers=2)
PROMPTS = [[5, 9, 14, 3], [11, 3, 300, 41, 7, 7, 90, 2, 13]]


def hf_config(cfg):
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "torch_dtype": "float32"}


def write_jax_checkpoint(d):
    """The JAX init of JCFG (PRNGKey 0) as an fp32 HF checkpoint in two
    shards, written by the port; returns the JAX params."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    checkpoint.save_checkpoint(str(d), checkpoint.hf_tensors(tp, TCFG),
                               shards=2)
    (d / "config.json").write_text(json.dumps(hf_config(TCFG)))
    return jp


def jax_streams(je, prompts, steps, adapter=None):
    """Greedy streams of each prompt alone through the JAX engine."""
    kw = {} if adapter is None else {"adapter": adapter}
    greedy = (np.zeros(je.max_slots, np.float32),
              np.zeros(je.max_slots, np.int32),
              np.ones(je.max_slots, np.float32))
    out = []
    for p in prompts:
        st = je.new_state()
        tok, kv, tl, b = je.prefill(p, **kw)
        st = je.insert(st, kv, 0, tl, tok, b, **kw)
        s = [int(tok)]
        for _ in range(steps - 1):
            st, toks = je.decode(st, *greedy)
            s.append(int(np.asarray(toks)[0]))
        out.append(s)
    return out


def cpu_server(model_dir, *argv):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return serve.build_server(
            ["--model-dir", str(model_dir), "--device", "cpu",
             "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
             "--max-seq", str(MAX_SEQ), "--dtype", "float32", *argv])
    finally:
        torch.set_num_threads(n)


def ready(url):
    with urllib.request.urlopen(url + "/ready", timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """A tiny fp32 tree published by the port's weight plane, and the
    JAX params it holds."""
    root = tmp_path_factory.mktemp("wp-serve")
    jp = write_jax_checkpoint(root / "src")
    st = providers.LocalStorage(str(root / "src"))
    stats = wp.fetch_and_publish(st, "", st.list(""), str(root / "model"),
                                 name="tiny")
    assert stats["published"] and stats["fetched"] == 4
    return root / "model", jp


def test_served_published_tree_advertises_the_fetch_rate(published):
    tree, jp = published
    server, sched, _ = cpu_server(tree)
    try:
        doc = ready(f"http://127.0.0.1:{server.port}")
        reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=8))
                for p in PROMPTS]
        served = [list(r.wait_output(60)) for r in reqs]
    finally:
        server.stop()
    assert doc["fetch_bps"] == jwp.published_fetch_bps(str(tree)) > 0
    assert doc["fetch_bps"] == wp.published_fetch_bps(str(tree))
    je = JaxEngine(jp, JCFG, max_slots=2, max_seq=MAX_SEQ)
    assert served == jax_streams(je, PROMPTS, 8)


def test_tree_without_a_manifest_reads_zero(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(hf_config(TCFG)))
    server, _, _ = cpu_server(tmp_path, "--random-weights")
    try:
        doc = ready(f"http://127.0.0.1:{server.port}")
    finally:
        server.stop()
    assert doc["fetch_bps"] == 0.0 == jwp.published_fetch_bps(str(tmp_path))
    assert doc["fetch_bps"] is not None
