"""The port's serving entrypoint on the CPU: HTTP round trips and refusals.

`build_server` runs exactly what `python -m ome_tpu_torch.engine.serve`
runs, minus the signal wait: a tiny config.json, `--device cpu
--random-weights`, then an OpenAI completion, an SSE stream and the
health/metrics surface over HTTP; `--quantization int8|int4|fp8`
servers answer too. Flags outside the port so far (and values the port
refuses, such as `--quantization nf4`, a negative `--kv-block`,
`--kv-dtype int8` without one, a negative `--spec-tokens` or
`--steps-per-dispatch 0`, `--disaggregation-mode decode` without a
prefill URL, a prefill URL without it) must exit with a message that
names them, a
model directory without weights must exit naming `--model-dir` unless
`--random-weights` is given, and asking for CUDA where there is no card
must raise. The flags of the host tier and of PD disaggregation are
served: `--prefix-cache-host-mb`, a `--disaggregation-mode prefill` node
(completions 503, `/pd/prefill` answers), a `--disaggregation-mode
decode` node whose pool is `--prefill-peer` plus `--prefill-url`
(`--pd-attempt-timeout`) answering what a monolithic server answers,
and `--pd-local-fallback` serving with no live peer.
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
    status, body = _post(url, {"prompt": "x", "max_tokens": 24,
                               "response_format": {"type": "json_object"}})
    assert status == 200
    assert json.loads(body)["usage"]["completion_tokens"] >= 1
    status, body = _post(url, {"prompt": "x", "response_format":
                               {"type": "grammar"}})
    assert status == 400 and b"not supported" in body
    status, _ = _post(url, {}, path="/debug/profile")
    assert status == 501


@pytest.mark.parametrize("argv", [
    ["--tp", "2"], ["--quantization", "nf4"], ["--kv-block", "-16"],
    ["--kv-dtype", "int8"], ["--profile-dir", "/nonexistent"],
    ["--disaggregation-mode", "decode"], ["--spec-tokens", "-1"],
    ["--steps-per-dispatch", "0"],
    ["--journal", "/nonexistent", "--disaggregation-mode", "prefill"],
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
    # without --random-weights the directory must hold a checkpoint:
    # a config.json alone exits naming --model-dir
    with pytest.raises(SystemExit, match="--model-dir"):
        serve.build_server(["--model-dir", model_dir, "--device", "cpu",
                            "--port", "0"])


def test_cuda_without_a_card_raises(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ome_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--port", "0"])


def _cpu_server(model_dir, *argv):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return serve.build_server(
            ["--model-dir", model_dir, "--random-weights", "--device", "cpu",
             "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
             "--max-seq", "128", "--dtype", "float32", *argv])
    finally:
        torch.set_num_threads(n)


def test_host_tier_flag_is_served(model_dir):
    server, sched, engine = _cpu_server(
        model_dir, "--prefix-cache-mb", "1", "--prefix-cache-host-mb", "64")
    try:
        pc = engine.prefix_cache
        assert (pc.capacity_bytes, pc.host_capacity_bytes) == (1 << 20,
                                                               64 << 20)
        url = f"http://127.0.0.1:{server.port}"
        body = {"prompt": list(range(5, 45)), "max_tokens": 3}
        assert _post(url, body)[0] == 200
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "ome_engine_prefix_host_bytes" in text
        assert engine.kv_conservation()[0]
    finally:
        server.stop()


def test_pd_flags_are_served(model_dir):
    mono = _cpu_server(model_dir)[0]
    pre = _cpu_server(model_dir, "--disaggregation-mode", "prefill")[0]
    dead = "http://127.0.0.1:9"
    dec, _, eng = _cpu_server(
        model_dir, "--disaggregation-mode", "decode",
        "--prefill-peer", dead,
        "--prefill-url", f"http://127.0.0.1:{pre.port}",
        "--pd-attempt-timeout", "5")
    alone = _cpu_server(model_dir, "--disaggregation-mode", "decode",
                        "--prefill-url", dead, "--pd-local-fallback")[0]
    try:
        assert eng.pool.urls == [dead, f"http://127.0.0.1:{pre.port}"]
        assert eng.timeout == 5.0 and not eng.local_fallback
        body = {"prompt": list(range(5, 45)), "max_tokens": 5}
        want = json.loads(_post(f"http://127.0.0.1:{mono.port}", body)[1])
        for srv in (dec, alone):
            status, got = _post(f"http://127.0.0.1:{srv.port}", body)
            assert status == 200
            assert json.loads(got)["choices"] == want["choices"]
        status, _ = _post(f"http://127.0.0.1:{pre.port}", body)
        assert status == 503
        status, blob = _post(f"http://127.0.0.1:{pre.port}",
                             {"ids": [5, 6, 7]}, path="/pd/prefill")
        assert status == 200 and len(blob) > 4
        # a plain replica with a prefix cache donates its prefixes too
        status, _ = _post(f"http://127.0.0.1:{mono.port}",
                          {"ids": [5, 6, 7]}, path="/pd/prefill")
        assert status == 200
    finally:
        for srv in (mono, pre, dec, alone):
            srv.stop()


def test_prefill_urls_need_the_decode_mode(model_dir):
    with pytest.raises(SystemExit, match="--disaggregation-mode decode"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--device", "cpu", "--prefill-url",
                            "http://127.0.0.1:9"])
