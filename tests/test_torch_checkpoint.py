"""Safetensors checkpoints in the port: models/checkpoint.py and serving them.

Tiny Llama, Mistral, Qwen2 and Phi3 checkpoints are written in `tmp_path`
from seeded numpy weights under HuggingFace names: a two-shard Llama
with model.safetensors.index.json and an untied lm_head (BF16, written
by the port's `save_checkpoint`), a Mistral with tied embeddings (F32,
written by the JAX package's `save_safetensors`) and a Qwen2 with
attention biases and tied embeddings (BF16, one file written by the
port's `save_safetensors`) and a Phi3 with fused qkv and gate|up
projections (F32, one file written by the port's `save_checkpoint`).
Then:

* the port's tree equals the JAX package's
  `load_params(..., device_put=False)` leaf for leaf, byte for byte, in
  bf16 and in fp32; each package reads the other's files;
* logits of the loaded trees agree within 2e-4 (fp32);
* an architecture outside the gate is refused by both packages;
  Qwen2 (attention biases) converts to the same tree and `load_params`
  serves it, while the same checkpoint under a config that asks for
  an architecture the reference does not serve is refused by name;
* `--quantization int4` quantizes the loaded tree to the reference's
  bytes, and `serve --model-dir DIR` (no `--random-weights`) answers
  with the greedy tokens of an engine over the same weights.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.models import checkpoint as jckpt
from ome_tpu.models import llama as jllama
from ome_tpu.models import quant as jquant
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.scheduler import Request
from ome_tpu_torch.models import checkpoint, llama, quant
from ome_tpu_torch.models.params import from_jax_params, to_numpy

BASE = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5}
CONFIGS = {
    "llama": dict(BASE, architectures=["LlamaForCausalLM"],
                  model_type="llama", tie_word_embeddings=False),
    "mistral": dict(BASE, architectures=["MistralForCausalLM"],
                    model_type="mistral", tie_word_embeddings=True,
                    sliding_window=None),
    "qwen2": dict(BASE, architectures=["Qwen2ForCausalLM"],
                  model_type="qwen2", tie_word_embeddings=True),
    "phi3": dict(BASE, architectures=["Phi3ForCausalLM"],
                 model_type="phi3", tie_word_embeddings=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_weights(hf: dict, seed: int) -> dict:
    """Seeded float32 HF-named tensors for a dense config."""
    rng = np.random.default_rng(seed)
    D, L = hf["hidden_size"], hf["num_hidden_layers"]
    H, K = hf["num_attention_heads"], hf["num_key_value_heads"]
    Dh, F, V = D // H, hf["intermediate_size"], hf["vocab_size"]

    def w(*shape, std=0.05):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    out = {"model.embed_tokens.weight": w(V, D),
           "model.norm.weight": 1.0 + w(D)}
    if not hf["tie_word_embeddings"]:
        out["lm_head.weight"] = w(V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = 1.0 + w(D)
        out[p + "post_attention_layernorm.weight"] = 1.0 + w(D)
        out[p + "self_attn.q_proj.weight"] = w(H * Dh, D)
        out[p + "self_attn.k_proj.weight"] = w(K * Dh, D)
        out[p + "self_attn.v_proj.weight"] = w(K * Dh, D)
        out[p + "self_attn.o_proj.weight"] = w(D, H * Dh)
        out[p + "mlp.gate_proj.weight"] = w(F, D)
        out[p + "mlp.up_proj.weight"] = w(F, D)
        out[p + "mlp.down_proj.weight"] = w(D, F)
        if hf["model_type"] == "qwen2":
            out[p + "self_attn.q_proj.bias"] = w(H * Dh)
            out[p + "self_attn.k_proj.bias"] = w(K * Dh)
            out[p + "self_attn.v_proj.bias"] = w(K * Dh)
        if hf["model_type"] == "phi3":
            # phi3 fuses q|k|v and gate|up into single projections
            out[p + "self_attn.qkv_proj.weight"] = np.concatenate(
                [out.pop(p + f"self_attn.{n}_proj.weight")
                 for n in "qkv"])
            out[p + "mlp.gate_up_proj.weight"] = np.concatenate(
                [out.pop(p + f"mlp.{n}_proj.weight")
                 for n in ("gate", "up")])
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    dirs = {}
    for seed, (name, hf) in enumerate(CONFIGS.items()):
        d = tmp_path_factory.mktemp(name)
        (d / "config.json").write_text(json.dumps(hf))
        weights = _hf_weights(hf, seed)
        if name == "llama":
            bf16 = {k: torch.from_numpy(v).to(torch.bfloat16)
                    for k, v in weights.items()}
            files = checkpoint.save_checkpoint(str(d), bf16, shards=2)
            assert len(files) == 2
            assert (d / "model.safetensors.index.json").exists()
        elif name == "mistral":
            jckpt.save_safetensors(str(d / "model.safetensors"), weights)
        elif name == "phi3":
            checkpoint.save_checkpoint(
                str(d), {k: torch.from_numpy(v) for k, v in weights.items()})
        else:
            checkpoint.save_safetensors(
                str(d / "model.safetensors"),
                {k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in weights.items()})
        dirs[name] = str(d)
    return dirs


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(port_tree, ref_tree):
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert got.keys() == want.keys()
    for name, b in want.items():
        a = got[name]
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16, name
            b = b.view(np.uint16)
        else:
            assert a.dtype == getattr(torch, b.dtype.name), name
        np.testing.assert_array_equal(to_numpy(a), b, err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["llama", "mistral", "phi3"])
def test_tree_equals_reference_leaf_for_leaf(ckpts, name, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref, jcfg = jckpt.load_params(ckpts[name], dtype=jdt,
                                  device_put=False)
    got, tcfg = checkpoint.load_params(ckpts[name], dtype=tdt,
                                       device="cpu")
    _assert_trees_equal(got, ref)
    assert tcfg.dtype == tdt
    assert ("lm_head" in got) == (name != "mistral")
    for field in ("num_layers", "hidden_size", "num_heads",
                  "num_kv_heads", "head_dim", "vocab_size",
                  "tie_word_embeddings", "rope_theta"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_qwen2_converts_equal_but_is_refused_by_name(ckpts, tmp_path):
    # Qwen2's biases are served now: the loaded tree is the reference's;
    # a config that asks for what stays unported is still refused by name
    d = ckpts["qwen2"]
    ref, _ = jckpt.load_params(d, dtype=jnp.bfloat16, device_put=False)
    cfg = checkpoint.load_config(d)
    got = checkpoint.convert_llama(checkpoint.Checkpoint(d), cfg,
                                   dtype=torch.bfloat16)
    _assert_trees_equal(got, ref)
    assert "bq" in got["layers"]
    loaded, _ = checkpoint.load_params(d, dtype=torch.bfloat16,
                                       device="cpu")
    _assert_trees_equal(loaded, ref)
    hf = dict(CONFIGS["qwen2"],
              architectures=["MllamaForConditionalGeneration"])
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(checkpoint.SafetensorsError, match="Mllama"):
        checkpoint.load_params(str(tmp_path), device="cpu")


def test_each_package_reads_the_others_files(ckpts, tmp_path):
    # the JAX package reads the port's BF16 shards and file ...
    for name in ("llama", "qwen2"):
        port_ck = checkpoint.Checkpoint(ckpts[name])
        ref_ck = jckpt.Checkpoint(ckpts[name])
        assert sorted(port_ck.keys()) == sorted(ref_ck.keys())
        for key in ref_ck.keys():
            np.testing.assert_array_equal(
                to_numpy(port_ck.read(key)),
                ref_ck.read(key).view(np.uint16))
    # ... and the port reads the JAX package's F32 file, bf16 and int8
    # included
    rng = np.random.default_rng(7)
    src = {"a": rng.standard_normal((3, 5)).astype(np.float32),
           "b": rng.integers(-9, 9, (4,)).astype(np.int8),
           "c": rng.standard_normal((2, 3)).astype(jnp.bfloat16)}
    path = str(tmp_path / "x.safetensors")
    jckpt.save_safetensors(path, src)
    f = checkpoint.SafetensorsFile(path)
    np.testing.assert_array_equal(f.read("a").numpy(), src["a"])
    np.testing.assert_array_equal(f.read("b").numpy(), src["b"])
    assert f.read("c").dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(f.read("c")),
                                  src["c"].view(np.uint16))


@pytest.mark.parametrize("name", ["llama", "mistral", "phi3"])
def test_logits_match_reference(ckpts, name):
    ref, jcfg = jckpt.load_params(ckpts[name], dtype=jnp.float32,
                                  device_put=False)
    got, tcfg = checkpoint.load_params(ckpts[name], dtype=torch.float32,
                                       device="cpu")
    tokens = np.random.default_rng(3).integers(3, 500, (2, 11))
    want, _ = jllama.forward(jax.tree.map(jnp.asarray, ref), jcfg,
                             jnp.asarray(tokens, jnp.int32))
    have, _ = llama.forward(got, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(have.numpy(), np.asarray(want), atol=2e-4)


def test_unsupported_architecture_refused(tmp_path):
    hf = dict(BASE, architectures=["MllamaForConditionalGeneration"],
              model_type="mllama")
    (tmp_path / "config.json").write_text(json.dumps(hf))
    checkpoint.save_safetensors(str(tmp_path / "model.safetensors"),
                                {"x": torch.zeros(2)})
    with pytest.raises(jckpt.SafetensorsError, match="architecture"):
        jckpt.load_params(str(tmp_path), device_put=False)
    with pytest.raises(checkpoint.SafetensorsError, match="architecture"):
        checkpoint.load_params(str(tmp_path), device="cpu")
    with pytest.raises(SystemExit, match="--model-dir"):
        serve.build_server(["--model-dir", str(tmp_path), "--device",
                            "cpu", "--port", "0"])


def test_int4_quantizes_the_loaded_tree_to_reference_bytes(ckpts):
    ref, _ = jckpt.load_params(ckpts["llama"], dtype=jnp.bfloat16,
                               device_put=False)
    got, _ = checkpoint.load_params(ckpts["llama"], dtype=torch.bfloat16,
                                    device="cpu")
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, ref),
                                mode="int4")
    want = _leaves(from_jax_params(jax.tree.map(np.asarray, jq), "cpu"))
    have = _leaves(quant.quantize_params(got, mode="int4"))
    assert have.keys() == want.keys()
    n_int4 = 0
    for name, a in have.items():
        b = want[name]
        assert type(a) is type(b), name
        if isinstance(a, quant.QTensor):
            assert (a.bits, a.axis) == (b.bits, b.axis), name
            n_int4 += a.bits == 4
            np.testing.assert_array_equal(to_numpy(a.q), to_numpy(b.q))
            np.testing.assert_array_equal(to_numpy(a.s), to_numpy(b.s))
        else:
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    assert n_int4 == 5  # wq wk wv w_gate w_up


def _complete(url, prompt, n):
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps({"prompt": prompt, "max_tokens": n,
                         "temperature": 0.0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("quantization", ["none", "int4"])
def test_serve_model_dir_without_random_weights(ckpts, quantization):
    d = ckpts["llama"]
    server, sched, engine = serve.build_server(
        ["--model-dir", d, "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max-slots", "2", "--max-seq", "128",
         "--dtype", "float32", "--quantization", quantization])
    try:
        doc = _complete(f"http://127.0.0.1:{server.port}", [5, 9, 14, 3],
                        6)
        assert doc["usage"]["completion_tokens"] == 6
        # the served ids themselves, through the server's scheduler
        req = sched.submit(Request(prompt_ids=[5, 9, 14, 3],
                                   max_new_tokens=6))
        out = req.wait_output(60)
    finally:
        server.stop()
    params, cfg = checkpoint.load_params(d, dtype=torch.float32,
                                         device="cpu")
    if quantization == "int4":
        params = quant.quantize_params(params, mode="int4")
        assert isinstance(engine.model.params["layers"]["wq"],
                          quant.QTensor)
    twin = InferenceEngine(params, cfg, max_slots=2, max_seq=128,
                           device="cpu")
    st = twin.new_state()
    tok, kv, tl, bucket = twin.prefill([5, 9, 14, 3])
    st = twin.insert(st, kv, 0, tl, tok, bucket)
    want = [tok]
    greedy = (np.zeros(2, np.float32), np.zeros(2, np.int32),
              np.ones(2, np.float32))
    for _ in range(5):
        st, toks = twin.decode(st, *greedy)
        want.append(int(np.asarray(toks)[0]))
    assert out == want
