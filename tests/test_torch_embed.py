"""Decoder embeddings in the port (engine/embed.py), against the JAX
package (fp32, CPU).

* `forward_embed` and `EmbeddingEngine.embed` on tiny Mistral (sliding
  window 8, shorter than the inputs) and Qwen2 (q/k/v biases drawn
  non-zero) configs, built from `MistralModel` / `Qwen2Model` HF
  configs, are within 1e-5 of the JAX package's, at batch > 1 with the
  rows right-padded, and each input embedded alone equals itself in its
  batch within 1e-5;
* padding and bucket invariance, as the reference's
  tests/test_embed.py holds them; every embedding has norm 1; an empty
  input is refused;
* a bare `MistralModel` safetensors checkpoint (no `model.` prefix, no
  lm_head) written in `tmp_path` loads and embeds like the JAX load;
* `/v1/embeddings` answers in the reference server's response shape
  and numbers, and 400 on an empty input (an empty id list); `serve
  --task embed` answers it, refuses completions with the reference's
  error, refuses `--journal` (and the other generation flags) by name,
  and, on a card, needs `CUBLAS_WORKSPACE_CONFIG=:0:0` (batch-invariant
  products), which `serve.main` sets before anything touches CUDA.
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import ByteTokenizer as JaxByteTokenizer
from ome_tpu.engine import EngineServer as JaxServer
from ome_tpu.engine.embed import EmbeddingEngine as JaxEmbedder
from ome_tpu.engine.embed import forward_embed as jax_forward_embed
from ome_tpu.engine.serve import _NullScheduler as JaxNullScheduler
from ome_tpu.models import checkpoint as jck
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import ModelConfig as JaxConfig
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.embed import EmbeddingEngine, forward_embed
from ome_tpu_torch.engine.server import EngineServer
from ome_tpu_torch.engine.tokenizer import ByteTokenizer
from ome_tpu_torch.models import checkpoint
from ome_tpu_torch.models.config import ModelConfig
from ome_tpu_torch.models.params import from_jax_params

ATOL = 1e-5
BASE = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 128,
        "max_position_embeddings": 64, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
FAMILIES = {
    "mistral": dict(architectures=["MistralModel"], model_type="mistral",
                    sliding_window=8),
    "qwen2": dict(architectures=["Qwen2Model"], model_type="qwen2",
                  use_sliding_window=False),
}
BUCKETS = [8, 32, 64]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def model(family):
    """(jcfg, jax params, port cfg, port params): the JAX init, biases
    drawn non-zero where the family has them."""
    if family not in _MODELS:
        hf = dict(BASE, **FAMILIES[family])
        jcfg = JaxConfig.from_hf_config(hf).replace(dtype=jnp.float32)
        tcfg = ModelConfig.from_hf_config(hf).replace(dtype=torch.float32)
        tree = jax.tree.map(np.asarray, jllama.init_params(
            jax.random.PRNGKey(3), jcfg))
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            if name in tree["layers"]:
                tree["layers"][name] = (0.5 * rng.standard_normal(
                    tree["layers"][name].shape)).astype(np.float32)
        _MODELS[family] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                           from_jax_params(tree, "cpu"))
    return _MODELS[family]


def _inputs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(3, 256, n)] for n in lengths]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_embed_equals_jax(family):
    jcfg, jp, tcfg, tp = model(family)
    assert (tcfg.sliding_window == 8) == (family == "mistral")
    assert ("bq" in tp["layers"]) == (family == "qwen2")
    ids = _inputs(0, (30, 5, 17))
    S = 32
    toks = np.zeros((3, S), np.int32)
    for i, row in enumerate(ids):
        toks[i, :len(row)] = row
    lens = np.asarray([len(r) for r in ids], np.int32)
    want = np.asarray(jax_forward_embed(jp, jcfg, jnp.asarray(toks),
                                        jnp.asarray(lens)))
    got = forward_embed(tp, tcfg, torch.from_numpy(toks),
                        torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_embed_equals_jax(family):
    jcfg, jp, tcfg, tp = model(family)
    ids = _inputs(1, (1, 7, 8, 9, 31, 40, 64, 70))
    je = JaxEmbedder(jp, jcfg, max_seq=64, buckets=BUCKETS)
    te = EmbeddingEngine(tp, tcfg, max_seq=64, buckets=BUCKETS,
                         device="cpu")
    want = je.embed(ids)
    got = te.embed(ids)
    assert got.shape == (8, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               atol=1e-6)
    # each input alone against itself inside its bucket's batch
    for i, row in enumerate(ids):
        np.testing.assert_allclose(te.embed([row])[0], got[i], atol=ATOL,
                                   rtol=0)


def test_padding_and_bucket_invariance():
    """The same prompt embeds identically at different buckets (the
    reference's test_padding_invariance)."""
    _, _, tcfg, tp = model("mistral")
    eng = EmbeddingEngine(tp, tcfg, max_seq=64, buckets=BUCKETS,
                          device="cpu")
    ids = [1, 5, 9, 3]
    a = eng.embed([ids])[0]                      # bucket 8
    b = eng.embed([ids + [2] * 10])[0]           # bucket 32 (different)
    c = eng.embed([ids])[0]
    padded = EmbeddingEngine(tp, tcfg, max_seq=64, buckets=[64],
                             device="cpu").embed([ids])[0]
    np.testing.assert_allclose(a, c, atol=1e-6)
    np.testing.assert_allclose(a, padded, atol=ATOL)
    assert np.linalg.norm(a) == pytest.approx(1.0, abs=1e-5)
    assert not np.allclose(a, b)
    assert eng.bucket_of(65) == 64
    # buckets default to 32, x4, up to max_seq
    assert EmbeddingEngine(tp, tcfg, max_seq=8192,
                           device="cpu").buckets == [32, 128, 512, 2048,
                                                     8192]
    with pytest.raises(ValueError, match="empty input"):
        eng.embed([ids, []])


def _bare_mistral(d):
    """A bare MistralModel checkpoint: tensors without the "model."
    prefix, no lm_head, seeded numpy weights."""
    os.makedirs(d, exist_ok=True)
    hf = dict(BASE, **FAMILIES["mistral"])
    rng = np.random.default_rng(9)
    D, H, K, Dh, F, V = 64, 4, 2, 16, 128, 256

    def w(*s):
        return torch.from_numpy((rng.standard_normal(s) * 0.05).astype(
            np.float32))
    T = {"embed_tokens.weight": w(V, D), "norm.weight": 1 + w(D)}
    for i in range(2):
        p = f"layers.{i}."
        T.update({p + "input_layernorm.weight": 1 + w(D),
                  p + "post_attention_layernorm.weight": 1 + w(D),
                  p + "self_attn.q_proj.weight": w(H * Dh, D),
                  p + "self_attn.k_proj.weight": w(K * Dh, D),
                  p + "self_attn.v_proj.weight": w(K * Dh, D),
                  p + "self_attn.o_proj.weight": w(D, H * Dh),
                  p + "mlp.gate_proj.weight": w(F, D),
                  p + "mlp.up_proj.weight": w(F, D),
                  p + "mlp.down_proj.weight": w(D, F)})
    checkpoint.save_safetensors(os.path.join(d, "model.safetensors"), T)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    return str(d)


def test_bare_mistral_checkpoint_embeds_like_jax(tmp_path):
    d = _bare_mistral(tmp_path / "e5")
    tp, tcfg = checkpoint.load_params(d, dtype=torch.float32, device="cpu")
    jp, jcfg = jck.load_params(d, dtype=jnp.float32)
    assert "lm_head" not in tp and "lm_head" not in jp
    ids = _inputs(2, (3, 12, 20))
    want = JaxEmbedder(jp, jcfg.replace(dtype=jnp.float32), max_seq=32,
                       buckets=[8, 32]).embed(ids)
    got = EmbeddingEngine(tp, tcfg, max_seq=32, buckets=[8, 32],
                          device="cpu").embed(ids)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _post(url, body, path="/v1/embeddings"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_v1_embeddings_answers_as_the_reference():
    jcfg, jp, tcfg, tp = model("qwen2")
    servers = [
        JaxServer(JaxNullScheduler(), tokenizer=JaxByteTokenizer(),
                  model_name="emb", port=0,
                  embedder=JaxEmbedder(jp, jcfg, max_seq=64,
                                       buckets=BUCKETS)),
        EngineServer(serve._NullScheduler(), tokenizer=ByteTokenizer(),
                     model_name="emb", port=0,
                     embedder=EmbeddingEngine(tp, tcfg, max_seq=64,
                                              buckets=BUCKETS,
                                              device="cpu"))]
    bodies = [{"model": "emb", "input": ["hello", [1, 2, 3], "w" * 40]},
              {"input": "one string"}, {"input": [""]}, {"input": [[]]}]
    answers = []
    for srv in servers:
        srv.start()
        try:
            url = f"http://127.0.0.1:{srv.port}"
            answers.append([_post(url, b) for b in bodies])
            answers[-1].append(_post(url, {"prompt": [1, 2]},
                                     "/v1/completions"))
        finally:
            srv.stop()
    (want, got) = answers
    # an empty string still encodes to the tokenizer's BOS; an empty id
    # list is an empty input
    assert [s for s, _ in got] == [s for s, _ in want] == [200, 200, 200,
                                                           400, 503]
    for (_, w), (_, g) in zip(want[:3], got[:3]):
        assert g.keys() == w.keys() and g["usage"] == w["usage"]
        assert [d["index"] for d in g["data"]] == \
            [d["index"] for d in w["data"]]
        np.testing.assert_allclose(
            [d["embedding"] for d in g["data"]],
            [d["embedding"] for d in w["data"]], atol=ATOL, rtol=0)
    assert got[0][1]["object"] == "list" and len(got[0][1]["data"]) == 3
    assert got[3][1] == want[3][1] == {"error":
                                       "cannot embed an empty input"}
    assert got[4][1] == want[4][1]


TINY_EMBED = dict(BASE, **FAMILIES["mistral"])


def test_serve_task_embed(tmp_path, monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    d = tmp_path / "e5"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(TINY_EMBED))
    base = ["--model-dir", str(d), "--random-weights", "--device", "cpu",
            "--task", "embed", "--dtype", "float32"]
    for argv, flag in ((["--journal", str(tmp_path / "j")], "--journal"),
                       (["--kv-block", "16"], "--kv-block"),
                       (["--quantization", "int8"], "--quantization"),
                       (["--adapter", "a=/x"], "--adapter")):
        with pytest.raises(SystemExit) as e:
            serve.build_server(base + argv)
        assert flag in str(e.value.code) and "--task embed" in \
            str(e.value.code)
    server, sched, embedder = serve.build_server(
        base + ["--host", "127.0.0.1", "--port", "0", "--max-seq", "64"])
    try:
        assert isinstance(embedder, EmbeddingEngine)
        assert embedder.buckets == [32, 64]
        # the CPU runs no cuBLAS: nothing set, nothing asked
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
        url = f"http://127.0.0.1:{server.port}"
        status, doc = _post(url, {"input": ["a", "bb", [5, 6, 7]]})
        assert status == 200 and len(doc["data"]) == 3
        assert all(len(e["embedding"]) == 64 for e in doc["data"])
        status, doc = _post(url, {"prompt": "hi"}, "/v1/completions")
        assert status == 503
        assert doc["error"] == "this deployment serves embeddings only"
        status, doc = _post(url, {"prompt": "hi", "response_format":
                                  {"type": "json_object"}},
                            "/v1/completions")
        assert status == 400 and "embeddings deployment" in doc["error"]
        with urllib.request.urlopen(url + "/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.stop()


def test_serve_task_embed_cublas_workspace(monkeypatch):
    """On a card `--task embed` needs cuBLAS without a workspace: the
    check refuses to start without it, naming the variable, and `main`
    sets it before it builds anything."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    serve.check_embed_workspace("cpu")
    for dev in ("cuda", None):
        with pytest.raises(SystemExit) as e:
            serve.check_embed_workspace(dev)
        assert "CUBLAS_WORKSPACE_CONFIG=:0:0" in str(e.value.code)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with pytest.raises(SystemExit):
        serve.check_embed_workspace("cuda")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    serve.check_embed_workspace("cuda")
    seen = []

    def build(argv):
        seen.append(os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        raise RuntimeError("stop")
    monkeypatch.setattr(serve, "build_server", build)
    for task, want in (("generate", None), ("embed", ":0:0")):
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
        with pytest.raises(RuntimeError, match="stop"):
            serve.main(["--model-dir", "/nonexistent", "--task", task])
        assert seen[-1] == want
