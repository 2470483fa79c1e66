"""The port's span logs export as the reference's do.

A port server (`serve.build_server`, tiny config on the CPU, two
decode steps per dispatch) writes `--span-log` over a few completions;
`ome_tpu_torch.telemetry.export` and the reference's
`ome_tpu.telemetry.export` must build identical Chrome trace documents
from that file (whole and filtered to one trace), and the port's CLI
(`python -m ome_tpu_torch.telemetry.export`) must write what the
reference's `scripts/trace_export.py` writes. The decode chunks' spans
carry the program ledger's attribution (`program`, `expected_ms`,
`program_bytes`).
"""

import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from ome_tpu.telemetry import export as jexport
from ome_tpu_torch.engine import serve
from ome_tpu_torch.telemetry import export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 256,
        "rope_theta": 10000.0}


@pytest.fixture(scope="module")
def span_log(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    (d / "config.json").write_text(json.dumps(TINY))
    path = str(d / "spans.jsonl")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    server, _, _ = serve.build_server(
        ["--model-dir", str(d), "--random-weights", "--device", "cpu",
         "--host", "127.0.0.1", "--port", "0", "--max-slots", "2",
         "--max-seq", "128", "--dtype", "float32", "--span-log", path,
         "--steps-per-dispatch", "2"])
    try:
        url = f"http://127.0.0.1:{server.port}/v1/completions"
        for prompt in ("one", "two two", "three three three"):
            req = urllib.request.Request(
                url, data=json.dumps({"prompt": prompt, "max_tokens": 6,
                                      "temperature": 0.0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
    finally:
        server.stop()
        torch.set_num_threads(n)
    return path


def test_documents_identical(span_log):
    spans = export.load_spans([span_log])
    assert spans == jexport.load_spans([span_log])
    assert len({s["trace_id"] for s in spans}) >= 3
    doc = export.build_trace(spans)
    assert doc == jexport.build_trace(jexport.load_spans([span_log]))
    assert doc["otherData"]["span_count"] == len(spans)
    tid = export.trace_ids(spans)[1]
    assert export.trace_ids(spans) == jexport.trace_ids(spans)
    one = export.build_trace(spans, trace_id=tid)
    assert one == jexport.build_trace(spans, trace_id=tid)
    assert 0 < one["otherData"]["span_count"] < len(spans)


def test_decode_chunks_carry_the_program(span_log):
    chunks = [s for s in export.load_spans([span_log])
              if s["name"] == "engine.decode_chunk"]
    assert chunks
    for s in chunks:
        attrs = s["attrs"]
        assert attrs["program"] == "decode_multi[n=2]"
        assert attrs["expected_ms"] > 0 and attrs["program_bytes"] > 0


def test_cli_writes_what_the_reference_script_writes(span_log, tmp_path):
    outs = []
    for cmd in ([sys.executable, "-m", "ome_tpu_torch.telemetry.export"],
                [sys.executable, os.path.join(REPO, "scripts",
                                              "trace_export.py")]):
        out = tmp_path / f"trace{len(outs)}.json"
        r = subprocess.run(cmd + [span_log, "-o", str(out)], cwd=REPO,
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr
        outs.append((out.read_text(), r.stdout.replace(str(out), "OUT")))
    assert outs[0] == outs[1]
