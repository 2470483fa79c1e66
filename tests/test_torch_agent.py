"""The port's ome-agent (ome_tpu_torch/agent/) against the JAX
package's (ome_tpu/agent/).

* the cases of tests/test_agent.py carry over: enigma's round trip and
  its tamper, header-tamper and wrong-key refusals; replication
  local -> local and pvc -> pvc, hf:// refused as a target; the serving
  agent's load / no-op / unload, zip extraction and zip-slip refusal;
  metadata extraction; and the CLI (`python -m ome_tpu_torch.agent`),
  each result equal to the reference's on the same inputs;
* a file that enigma encrypts in the port decrypts with the reference's
  enigma, and the other way round (`LocalKMS`, the same key file); the
  GCP KMS wrap and the GCE metadata client against stubs send and read
  the same;
* the serving agent stages a PEFT adapter zip from `local://` and
  hot-loads it into a port engine on the CPU (`POST /v1/adapters`): the
  adapter's greedy stream equals the JAX engine's with the same adapter,
  and taking the entry out of the info file removes the adapter from
  `/v1/models` (`DELETE /v1/adapters/NAME`).
"""

import dataclasses
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.request
import zipfile
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from ome_tpu import agent as jagent
from ome_tpu.agent import cloudkms as jcloudkms
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu_torch import agent
from ome_tpu_torch.agent import cloudkms
from ome_tpu_torch.engine.scheduler import Request

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_lora import write_adapter  # noqa: E402
from test_torch_weightplane import (JCFG, MAX_SEQ, PROMPTS, TCFG,  # noqa: E402
                                    cpu_server, jax_streams,
                                    write_jax_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": jagent, "port": agent}


def _crypto():
    pytest.importorskip("cryptography")  # enigma's AES-GCM backend


def make_model_dir(d, seed=0):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama",
                   "architectures": ["LlamaForCausalLM"],
                   "vocab_size": 512, "hidden_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "intermediate_size": 128,
                   "max_position_embeddings": 2048}, f)
    with open(os.path.join(d, "model.safetensors"), "wb") as f:
        f.write(np.random.default_rng(seed).bytes(300_000))


def _tree(root):
    out = {}
    for r, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(r, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


# -- enigma ---------------------------------------------------------------------


def test_enigma_roundtrip_and_cross_package(tmp_path):
    _crypto()
    src = tmp_path / "model"
    make_model_dir(src)
    agent.LocalKMS(str(tmp_path / "master.key"), create=True)
    plain = (src / "model.safetensors").read_bytes()
    for enc_tag, dec_tag in (("port", "port"), ("port", "ref"),
                             ("ref", "port")):
        enc_mod, dec_mod = PKGS[enc_tag], PKGS[dec_tag]
        enc = tmp_path / f"enc-{enc_tag}-{dec_tag}"
        dec = tmp_path / f"dec-{enc_tag}-{dec_tag}"
        n = enc_mod.encrypt_dir(str(src), str(enc),
                                enc_mod.LocalKMS(str(tmp_path / "master.key")))
        assert n == 2
        assert plain not in (enc / "model.safetensors.enc").read_bytes()
        m = dec_mod.decrypt_dir(str(enc), str(dec),
                                dec_mod.LocalKMS(str(tmp_path / "master.key")))
        assert m == 2
        assert _tree(dec) == _tree(src)


def _encrypted(tmp_path, tag):
    src = tmp_path / "model"
    if not src.exists():
        make_model_dir(src)
    kms = PKGS[tag].LocalKMS(str(tmp_path / f"{tag}.key"), create=True)
    PKGS[tag].encrypt_dir(str(src), str(tmp_path / f"enc-{tag}"), kms)
    return tmp_path / f"enc-{tag}" / "model.safetensors.enc", kms


def _tamper_body(p):
    raw = bytearray(p.read_bytes())
    raw[-10] ^= 0xFF
    p.write_bytes(bytes(raw))


def _tamper_header(p):
    raw = p.read_bytes()
    magic = b"OMEENC1\n"
    (hlen,) = struct.unpack("<I", raw[len(magic):len(magic) + 4])
    hstart = len(magic) + 4
    header = json.loads(raw[hstart:hstart + hlen])
    header["orig_size"] = 1
    new_header = json.dumps(header).encode().ljust(hlen)[:hlen]
    p.write_bytes(raw[:hstart] + new_header + raw[hstart + hlen:])


@pytest.mark.parametrize("attack", ["body", "header", "wrong_key"])
def test_enigma_refusals_equal(tmp_path, attack):
    _crypto()
    msgs = {}
    for tag, mod in PKGS.items():
        p, kms = _encrypted(tmp_path, tag)
        if attack == "body":
            _tamper_body(p)
        elif attack == "header":
            _tamper_header(p)
        else:
            kms = mod.LocalKMS(str(tmp_path / f"other-{tag}.key"),
                               create=True)
        with pytest.raises(mod.EnigmaError) as e:
            mod.decrypt_dir(str(p.parent), str(tmp_path / f"dec-{tag}"), kms)
        msgs[tag] = type(e.value).__name__
    assert msgs["port"] == msgs["ref"]


class _KMSStub(BaseHTTPRequestHandler):
    """A KMS that wraps by xor with 0x5a and records what it was sent."""

    seen = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        import base64
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        _KMSStub.seen.append((self.path, self.headers.get("Authorization"),
                              body))
        field = "plaintext" if self.path.endswith(":encrypt") else \
            "ciphertext"
        raw = bytes(b ^ 0x5A for b in base64.b64decode(body[field]))
        out = {"ciphertext" if field == "plaintext" else "plaintext":
               base64.b64encode(raw).decode()}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        answers = {"/computeMetadata/v1/instance/id": "42",
                   "/computeMetadata/v1/project/project-id": "proj",
                   "/computeMetadata/v1/instance/zone":
                       "projects/1/zones/us-east5-a",
                   "/computeMetadata/v1/instance/service-accounts/default/"
                   "email": "sa@proj.iam"}
        ok = self.headers.get("Metadata-Flavor") == "Google" and \
            self.path in answers
        data = answers.get(self.path, "").encode()
        self.send_response(200 if ok else 404)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_gcp_kms_and_metadata_against_a_stub_equal(tmp_path, monkeypatch):
    _crypto()
    monkeypatch.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)
    srv = HTTPServer(("127.0.0.1", 0), _KMSStub)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    key = "projects/p/locations/l/keyRings/r/cryptoKeys/k"
    got = {}
    try:
        for tag, mod in (("ref", jcloudkms), ("port", cloudkms)):
            _KMSStub.seen.clear()
            kms = mod.GCPKMS(key, endpoint=url, token="tkn")
            wrapped = kms.wrap_key(b"0123456789abcdef")
            imds = mod.IMDSClient(endpoint=url + "/computeMetadata/v1")
            got[tag] = (kms.key_id, wrapped, kms.unwrap_key(wrapped),
                        list(_KMSStub.seen), imds.available(),
                        imds.identity())
            # a whole directory through the stub-wrapped data key
            src = tmp_path / "model"
            if not src.exists():
                make_model_dir(src)
            enc = tmp_path / f"enc-{tag}"
            PKGS[tag].encrypt_dir(str(src), str(enc), kms)
        # each package decrypts what the other wrapped
        for enc_tag, mod in (("ref", agent), ("port", jagent)):
            kms = (cloudkms if mod is agent else jcloudkms).GCPKMS(
                key, endpoint=url, token="tkn")
            mod.decrypt_dir(str(tmp_path / f"enc-{enc_tag}"),
                            str(tmp_path / f"dec-{enc_tag}"), kms)
            assert _tree(tmp_path / f"dec-{enc_tag}") == _tree(src)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got["port"] == got["ref"]
    assert got["port"][2] == b"0123456789abcdef"
    assert got["port"][5]["region"] == "us-east5"
    with pytest.raises(ValueError, match="unknown KMS spec"):
        cloudkms.open_kms("vault:x")
    assert isinstance(cloudkms.open_kms(f"local:{tmp_path / 'l.key'}",
                                        create=True), agent.LocalKMS)


# -- replica --------------------------------------------------------------------


def test_replica_local_and_pvc_equal(tmp_path):
    make_model_dir(tmp_path / "src")
    got = {}
    for tag, mod in PKGS.items():
        res = mod.Replicator().replicate(f"local://{tmp_path / 'src'}",
                                         f"local://{tmp_path / tag}")
        pvc_root = tmp_path / f"pvc-{tag}"
        make_model_dir(pvc_root / "claim-a" / "models" / "m")
        res2 = mod.Replicator(pvc_mount_root=str(pvc_root)).replicate(
            "pvc://claim-a/models/m", "pvc://claim-b/models/m")
        with pytest.raises(ValueError) as e:
            mod.Replicator().replicate(f"local://{tmp_path / 'src'}",
                                       "hf://org/repo")
        got[tag] = (dataclasses.asdict(res) | {"target": None},
                    dataclasses.asdict(res2), _tree(tmp_path / tag),
                    _tree(pvc_root / "claim-b"), str(e.value))
    assert got["port"] == got["ref"]
    assert got["port"][0]["files"] == 2


# -- serving agent (staging) ------------------------------------------------------


def _info(path, entries):
    with open(path, "w") as f:
        json.dump(entries, f)


def test_serving_agent_load_update_unload_equal(tmp_path):
    got = {}
    for tag, mod in PKGS.items():
        base = tmp_path / tag
        adapter_src = base / "adapter-src"
        os.makedirs(adapter_src)
        (adapter_src / "adapter_model.bin").write_bytes(b"weights-v1")
        zsrc = base / "zip-src"
        os.makedirs(zsrc)
        with zipfile.ZipFile(zsrc / "adapter.zip", "w") as z:
            z.writestr("adapter_config.json", "{}")
            z.writestr("weights/adapter.bin", "wv2")
        info = base / "info.json"
        _info(info, [{"name": "ft1", "storageUri": f"local://{adapter_src}"},
                     {"name": "ftz", "storageUri": f"local://{zsrc}",
                      "revision": "r1"}])
        changed = []
        ag = mod.ServingAgent(str(info), str(base / "adapters"),
                              on_change=changed.append)
        steps = [ag.sync(), _tree(base / "adapters"), ag.sync()]
        _info(info, [{"name": "ftz", "storageUri": f"local://{zsrc}",
                      "revision": "r1"}])
        steps += [ag.sync(), _tree(base / "adapters"),
                  sorted(ag.loaded), changed]
        (base / "bad.json").write_text("{not json")
        steps.append(mod.ServingAgent(str(base / "bad.json"),
                                      str(base / "x")).sync())
        got[tag] = steps
    assert got["port"] == got["ref"]
    assert got["port"][1] == {"ft1/adapter_model.bin": b"weights-v1",
                              "ftz/adapter_config.json": b"{}",
                              "ftz/weights/adapter.bin": b"wv2"}
    assert got["port"][2] is False


def test_serving_agent_zip_slip_blocked_in_both(tmp_path):
    zsrc = tmp_path / "evil-src"
    os.makedirs(zsrc)
    with zipfile.ZipFile(zsrc / "adapter.zip", "w") as z:
        z.writestr("../../evil.txt", "pwned")
    msgs = {}
    for tag, mod in PKGS.items():
        ag = mod.ServingAgent(str(tmp_path / "info.json"),
                              str(tmp_path / tag / "adapters"))
        with pytest.raises(ValueError) as e:
            ag._load(mod.AdapterInfo(name="evil",
                                     storage_uri=f"local://{zsrc}"))
        msgs[tag] = str(e.value)
    assert msgs["port"] == msgs["ref"]
    assert not (tmp_path / "evil.txt").exists()
    assert not any(p.name == "evil.txt" for p in tmp_path.rglob("*"))


def test_metadata_equal(tmp_path):
    make_model_dir(tmp_path / "m")
    got = agent.extract_metadata(str(tmp_path / "m"))
    assert got == jagent.extract_metadata(str(tmp_path / "m"))
    assert got["architecture"] == "LlamaForCausalLM" and \
        got["parameter_size"]
    assert agent.publish_metadata(str(tmp_path / "none")) == \
        jagent.publish_metadata(str(tmp_path / "none"))


# -- the CLI ----------------------------------------------------------------------


def _cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        timeout=120)


def test_cli_equal(tmp_path):
    _crypto()
    make_model_dir(tmp_path / "m")
    asrc = tmp_path / "a"
    os.makedirs(asrc)
    (asrc / "w.bin").write_bytes(b"x")
    info = tmp_path / "info.json"
    info.write_text(json.dumps([{"name": "f",
                                 "storageUri": f"local://{asrc}"}]))
    got = {}
    for tag, module in (("ref", "ome_tpu.agent"),
                        ("port", "ome_tpu_torch.agent")):
        t = tmp_path / tag
        key = str(t / "k.key")
        runs = [
            _cli(module, "enigma", "encrypt", "--input", str(tmp_path / "m"),
                 "--output", str(t / "enc"), "--keyfile", key),
            _cli(module, "enigma", "decrypt", "--input", str(t / "enc"),
                 "--output", str(t / "dec"), "--keyfile", key),
            _cli(module, "replica", "--source", f"local://{tmp_path / 'm'}",
                 "--target", f"local://{t / 'rep'}"),
            _cli(module, "model-metadata", "--model-dir",
                 str(tmp_path / "m"), "--out-file", str(t / "meta.json")),
            _cli(module, "serving-agent", "--info-file", str(info),
                 "--adapters-dir", str(t / "out"), "--once"),
        ]
        for r in runs:
            assert r.returncode == 0, r.stderr
        bad = _cli(module, "replica", "--source", "notauri", "--target",
                   "alsonot")
        none = _cli(module, "enigma", "encrypt", "--input", "x",
                    "--output", "y")
        got[tag] = ([r.stdout.replace(str(t), "<t>") for r in runs],
                    _tree(t / "dec"), _tree(t / "rep"),
                    json.loads((t / "meta.json").read_text()),
                    _tree(t / "out"), bad.returncode,
                    bad.stderr.strip().splitlines()[-1],
                    none.returncode, none.stderr)
    assert got["port"] == got["ref"]
    assert got["port"][1] == _tree(tmp_path / "m")
    assert got["port"][4] == {"f/w.bin": b"x"}
    assert got["port"][5] == 1 and "error" in got["port"][6]


# -- the serving agent in front of a port engine -----------------------------------


def _models(url):
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        return sorted(m["id"] for m in json.loads(r.read())["data"])


def test_serving_agent_hot_loads_into_a_port_engine(tmp_path):
    jp = write_jax_checkpoint(tmp_path / "base")
    adapter = write_adapter(tmp_path / "peft", TCFG, seed=31, r=8)
    zsrc = tmp_path / "store"
    os.makedirs(zsrc)
    with zipfile.ZipFile(zsrc / "ft1.zip", "w") as z:
        for name in ("adapter_config.json", "adapter_model.safetensors"):
            z.write(os.path.join(adapter, name), name)
    info = tmp_path / "info.json"
    _info(info, [{"name": "ft1", "storageUri": f"local://{zsrc}"}])
    server, sched, _ = cpu_server(tmp_path / "base", "--lora-slots", "1",
                                  "--lora-rank", "8")
    url = f"http://127.0.0.1:{server.port}"
    try:
        before = _models(url)
        ag = agent.ServingAgent(str(info), str(tmp_path / "adapters"),
                                engine_url=url)
        assert ag.sync()
        loaded = _models(url)
        reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=8,
                                     adapter="ft1")) for p in PROMPTS]
        served = [list(r.wait_output(60)) for r in reqs]
        _info(info, [])
        assert ag.sync()
        after = _models(url)
    finally:
        server.stop()
    assert "ft1" not in before and "ft1" in loaded and "ft1" not in after
    assert after == before
    je = JaxEngine(jp, JCFG, max_slots=2, max_seq=MAX_SEQ, lora_slots=1,
                   lora_rank=8)
    # the same PEFT files the zip carried (the staged copy is gone)
    je.register_adapter("ft1", adapter)
    want = jax_streams(je, PROMPTS, 8, adapter="ft1")
    assert served == want
    assert want != jax_streams(je, PROMPTS, 8)  # the adapter matters
