"""The port's serving entrypoint on the CPU: HTTP round trips and refusals.

`build_server` runs exactly what `python -m ome_tpu_torch.engine.serve`
runs, minus the signal wait: a tiny config.json, `--device cpu
--random-weights`, then an OpenAI completion, an SSE stream and the
health/metrics surface over HTTP; `--quantization int8|int4|fp8`
servers answer too. Flags outside the port so far (and values the port
refuses, such as `--quantization nf4`, a negative `--kv-block`,
`--kv-dtype int8` without one, a negative `--spec-tokens` or
`--steps-per-dispatch 0`, `--disaggregation-mode decode` without a
prefill URL, a prefill URL without it, a `--task` other than generate
or embed, a negative `--lora-slots`, an `--adapter` that does not
load) must exit with a message that names them, a
model directory without weights must exit naming `--model-dir` unless
`--random-weights` is given, and asking for CUDA where there is no card
must raise. The flags of the host tier and of PD disaggregation are
served: `--prefix-cache-host-mb`, a `--disaggregation-mode prefill` node
(completions 503, `/pd/prefill` answers), a `--disaggregation-mode
decode` node whose pool is `--prefill-peer` plus `--prefill-url`
(`--pd-attempt-timeout`) answering what a monolithic server answers,
and `--pd-local-fallback` serving with no live peer. Tensor parallelism
is served: `--tp 2 --device cpu` answers with the `--tp 1` stream (a
follower process started by the server), `--control-port` is parsed,
the LWS environment sets tp to its process count, and the reference's
refusals under tp > 1 come in its words.
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
    # the reference's guard: /debug/profile exists only with --profile-dir
    status, _ = _post(url, {}, path="/debug/profile")
    assert status == 403


@pytest.mark.parametrize("argv", [
    ["--tp", "0"], ["--quantization", "nf4"], ["--kv-block", "-16"],
    ["--kv-dtype", "int8"], ["--profile-dir"],
    ["--disaggregation-mode", "decode"], ["--spec-tokens", "-1"],
    ["--steps-per-dispatch", "0"],
    ["--journal", "/nonexistent", "--disaggregation-mode", "prefill"],
    ["--task", "classify"], ["--ledger-mode", "bogus"],
    ["--control-port", "x"], ["--adapter", "a=/nonexistent"],
    ["--lora-slots", "-1"],
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
    from ome_tpu_torch.engine import multihost
    dist = multihost.init_from_env({"JAX_COORDINATOR_ADDRESS": "h:1",
                                    "JAX_NUM_PROCESSES": "2"})
    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--random-weights"])
    serve.check_slice(args)
    # the group is served: tp defaults to its process count
    serve.check_group(args, dist)
    assert args.tp == 2
    # a process is one rank: another --tp is refused naming it
    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--random-weights", "--tp", "4"])
    with pytest.raises(SystemExit, match="--tp 4"):
        serve.check_group(args, dist)
    # embeddings refuse the multi-host environment, in the reference's
    # words
    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--random-weights", "--task", "embed"])
    with pytest.raises(SystemExit, match="--task embed does not support "
                                         "multi-host serving"):
        serve.check_group(args, dist)
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


# the reference's refusals under tp > 1 (ome_tpu/engine/serve.py), word
# for word
TP_REFUSALS = {
    "lora": (["--adapter", "a=/x"],
             "multi-LoRA serving is single-host tp=1 for now (adapter "
             "stacks are unsharded); use a merged --adapter dir with tp>1"),
    "paged": (["--kv-block", "16"],
              "--kv-block/--kv-blocks (paged KV) is single-host tp=1 for "
              "now (the sharded engine keeps the dense per-slot cache); "
              "drop the flags with tp>1"),
    "kv_int8": (["--kv-dtype", "int8"],
                "--kv-dtype int8 quantizes the paged block pool, which is "
                "single-host tp=1 for now; drop the flag with tp>1"),
    "host_tier": (["--prefix-cache-host-mb", "64"],
                  "--prefix-cache-host-mb (host-DRAM prefix tier) is "
                  "single-host tp=1 for now; drop the flag with tp>1"),
}


@pytest.mark.parametrize("case", sorted(TP_REFUSALS))
def test_tp_refusals_are_the_references(model_dir, case):
    argv, words = TP_REFUSALS[case]
    args = serve.build_parser().parse_args(
        ["--model-dir", model_dir, "--random-weights", "--tp", "2", *argv])
    with pytest.raises(SystemExit) as e:
        serve.check_tp(args)
    assert str(e.value) == words
    args.tp = 1
    serve.check_tp(args)  # tp 1 serves them


def test_tp_refusals_of_the_port(model_dir):
    # embeddings are one device's (the reference ignores --tp there)
    with pytest.raises(SystemExit, match="--tp configures generation"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--device", "cpu", "--task", "embed",
                            "--tp", "2"])
    # heads a tp does not divide exit naming --tp before any weight
    with pytest.raises(SystemExit, match="--tp 3: tp=3 must divide "
                                         "num_kv_heads=2"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--device", "cpu", "--tp", "3"])


def test_control_port_is_parsed():
    args = serve.build_parser().parse_args(
        ["--model-dir", "/m", "--control-port", "9000", "--tp", "2"])
    assert (args.control_port, args.tp) == (9000, 2)
    assert serve.build_parser().parse_args(
        ["--model-dir", "/m"]).control_port is None


@pytest.mark.parametrize("device,given,want", [
    ("cuda:0", None, "gloo"),      # every rank on the one card
    ("cuda", None, None),          # a card per rank: NCCL
    ("cpu", None, None),           # gloo by the device
    ("cuda:0", "nccl", "nccl")])   # the caller's choice stands
def test_single_host_tp_hands_its_backend_to_the_followers(
        monkeypatch, device, given, want):
    """`--tp 2` without the LWS environment: ranks that share the card
    `--device cuda:i` names run gloo (NCCL refuses two ranks on one
    device), and the leader passes that choice to the follower it
    starts; otherwise the backend follows the device."""
    started = []

    class Proc:
        pid = 0

        def __init__(self, cmd, env):
            started.append((cmd, env))
    monkeypatch.setattr(serve.subprocess, "Popen", Proc)
    argv = ["--model-dir", "/m", "--tp", "2", "--device", device] + (
        ["--tp-backend", given] if given else [])
    args = serve.build_parser().parse_args(argv)
    grp = serve._start_group(args, argv, None)
    assert args.tp_backend == want and len(grp.procs) == 1
    (cmd, env), = started
    assert env["JAX_PROCESS_ID"] == "1" and env["JAX_NUM_PROCESSES"] == "2"
    follower = serve.build_parser().parse_args(cmd[3:])
    assert follower.tp_backend == want and follower.device == device


def test_lws_named_card_keeps_nccl_and_warns(monkeypatch, caplog):
    """Under the LWS environment `--device cuda:0` is each pod's own
    card: NCCL, with a warning that ranks sharing it need
    `--tp-backend gloo`."""
    from ome_tpu_torch.engine.multihost import DistContext
    args = serve.build_parser().parse_args(
        ["--model-dir", "/m", "--device", "cuda:0"])
    dist = DistContext("leader:6000", 2, 0)
    with caplog.at_level("WARNING", logger=serve.log.name):
        grp = serve._start_group(args, [], dist)
    assert grp.procs == [] and args.tp_backend is None
    assert "--tp-backend gloo" in caplog.text


def test_tp2_server_answers_the_tp1_stream(model_dir, served):
    url, _, _ = served
    prompts = ["tensor parallel", [5, 9, 14, 3]]
    want = [json.loads(_post(url, {"prompt": p, "max_tokens": 12,
                                   "temperature": 0.0})[1])
            ["choices"][0]["text"] for p in prompts]
    server, sched, engine = _cpu_server(model_dir, "--tp", "2")
    try:
        from ome_tpu_torch.engine.multihost import ReplicatedEngine
        assert isinstance(engine, ReplicatedEngine)
        assert engine.tp == 2 and engine.cfg.num_heads == 2
        got = [json.loads(_post(f"http://127.0.0.1:{server.port}",
                                {"prompt": p, "max_tokens": 12,
                                 "temperature": 0.0})[1])
               ["choices"][0]["text"] for p in prompts]
    finally:
        server.stop()
    assert got == want


def test_follower_environment_serves_no_http(model_dir, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(SystemExit, match="follower rank serves no HTTP"):
        serve.build_server(["--model-dir", model_dir, "--random-weights",
                            "--device", "cpu", "--port", "0"])
