"""The port's serving entrypoint on the CPU: HTTP round trips and refusals.

`build_server` runs exactly what `python -m ome_tpu_torch.engine.serve`
runs, minus the signal wait: a tiny config.json, `--device cpu
--random-weights`, then an OpenAI completion, an SSE stream and the
health/metrics surface over HTTP; `--quantization int8|int4|fp8`
servers answer too. Flags outside this slice of the port (and values
the port refuses, such as `--quantization nf4`, a negative
`--kv-block` or `--kv-dtype int8` without one) must exit with a message
that names them, and asking for CUDA where there is no card must
raise.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

from ome_tpu_torch.engine import serve

TINY = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 10000.0}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny-llama")
    (d / "config.json").write_text(json.dumps(TINY))
    return str(d)


@pytest.fixture(scope="module")
def served(model_dir):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    server, sched, engine = serve.build_server(
        ["--model-dir", model_dir, "--random-weights", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "128", "--dtype", "float32"])
    try:
        yield f"http://127.0.0.1:{server.port}", sched, engine
    finally:
        server.stop()
        torch.set_num_threads(n)


def _post(url, body, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_completion_round_trip(served):
    url, sched, engine = served
    assert engine.device.type == "cpu"
    status, body = _post(url, {"prompt": "hello port", "max_tokens": 6,
                               "temperature": 0.0})
    assert status == 200
    doc = json.loads(body)
    assert doc["object"] == "text_completion"
    assert 1 <= doc["usage"]["completion_tokens"] <= 6
    assert doc["choices"][0]["finish_reason"] in ("length", "stop")


def test_token_id_prompt_and_repeat_are_deterministic(served):
    url, _, _ = served
    body = {"prompt": list(range(5, 45)), "max_tokens": 5}
    a = json.loads(_post(url, body)[1])
    b = json.loads(_post(url, body)[1])
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    assert a["usage"]["prompt_tokens"] == 40


def test_sse_stream(served):
    url, _, _ = served
    status, body = _post(url, {"prompt": "stream me", "max_tokens": 4,
                               "stream": True})
    assert status == 200
    events = [ln[len("data: "):] for ln in body.decode().splitlines()
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])
    assert 1 <= final["usage"]["completion_tokens"] <= 4


def test_health_metrics_and_refusals(served):
    url, _, _ = served
    with urllib.request.urlopen(url + "/health", timeout=10) as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "ome_engine_tokens_generated_total" in text
    assert "ome_engine_prefix_cache_hits_total" in text
    status, body = _post(url, {"prompt": "x", "response_format":
                               {"type": "json_object"}})
    assert status == 400 and b"not supported yet" in body
    status, _ = _post(url, {}, path="/debug/profile")
    assert status == 501


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--quantization", "nf4"], ["--kv-block", "-16"],
    ["--kv-dtype", "int8"], ["--prefix-cache-host-mb", "64"],
    ["--disaggregation-mode", "decode"], ["--spec-tokens", "4"],
    ["--steps-per-dispatch", "4"], ["--journal", "/nonexistent"],
    ["--task", "embed"], ["--ledger-mode", "auto"],
    ["--control-port", "9000"], ["--adapter", "a=/nonexistent"],
    ["--lora-slots", "2"],
], ids=lambda a: a[0])
def test_out_of_slice_flags_exit_naming_the_flag(model_dir, argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--device", "cpu", *argv])
    message = f"{e.value.code} {capsys.readouterr().err}"
    assert e.value.code != 0
    assert argv[0] in message


@pytest.mark.parametrize("mode", ["int8", "int4", "fp8"])
def test_quantized_server_answers(model_dir, mode):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    server, _, engine = serve.build_server(
        ["--model-dir", model_dir, "--random-weights", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "128", "--quantization", mode])
    try:
        from ome_tpu_torch.models.quant import QTensor
        wq = engine.model.params["layers"]["wq"]
        assert isinstance(wq, QTensor) and wq.bits == (4 if mode == "int4"
                                                       else 8)
        status, body = _post(f"http://127.0.0.1:{server.port}",
                             {"prompt": "quantized", "max_tokens": 4,
                              "temperature": 0.0})
        assert status == 200
        assert 1 <= json.loads(body)["usage"]["completion_tokens"] <= 4
    finally:
        server.stop()
        torch.set_num_threads(n)


def test_multihost_env_and_checkpoints_refuse(model_dir):
    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--random-weights"])
    with pytest.raises(SystemExit, match="multi-host"):
        serve.check_slice(args, env={"JAX_COORDINATOR_ADDRESS": "h:1",
                                     "JAX_NUM_PROCESSES": "2"})
    serve.check_slice(args, env={})
    args = serve.build_parser().parse_args(["--model-dir", model_dir])
    with pytest.raises(SystemExit, match="--random-weights"):
        serve.check_slice(args, env={})


def test_cuda_without_a_card_raises(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ome_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--port", "0"])
