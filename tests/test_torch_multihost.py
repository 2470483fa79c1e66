"""Multi-host serving (ome_tpu_torch/engine/multihost.py) against the
JAX package's engine/multihost.py.

* The reference's op-stream cases (tests/test_multihost.py): the
  ReplicatedEngine publishes every device-touching op with host
  arguments only, a PD decode group fetches a blob once, the follower
  replays and exits 1 on a dropped leader, a refused unregister clears
  only its own adapter's refs; and the control channel's frames are the
  reference's `_send_msg` bytes.
* A leader and a follower (two spawned gloo CPU processes, tp=2 over
  them) driven over the control channel by tests/multihost_driver.py's
  `run_script` and the scheduler's spec x chunk composition emit the
  streams the JAX ShardedInferenceEngine(tp=2) emits in process.
* `init_from_env` reads the LWS contract; an empty environment is single
  host. Two `serve` processes started under that environment with
  `--control-port` answer completions with the `--tp 1` server's
  streams, and killing the follower turns the leader unhealthy.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import multihost as jmultihost
from ome_tpu.engine.sharded import ShardedInferenceEngine as JaxSharded
from ome_tpu.models.config import tiny_test as jtiny
from ome_tpu_torch.engine import multihost
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import init_params, to_numpy
from tests import torch_tp_workers as workers
from tests.multihost_driver import run_script
from tests.multihost_driver import run_spec as jax_run_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_init_from_env_absent_is_single_host():
    assert multihost.init_from_env(env={}) is None
    assert multihost.init_from_env(
        env={"JAX_COORDINATOR_ADDRESS": "x:1",
             "JAX_NUM_PROCESSES": "1"}) is None
    ctx = multihost.init_from_env(env={
        "JAX_COORDINATOR_ADDRESS": "leader.svc:6000",
        "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "2",
        "LOCAL_RANK": "1"})
    assert (ctx.coordinator, ctx.num_processes, ctx.process_id,
            ctx.local_rank) == ("leader.svc:6000", 4, 2, 1)
    assert ctx.coordinator_host == "leader.svc" and not ctx.is_leader
    assert multihost.CONTROL_PORT == jmultihost.CONTROL_PORT
    # the contract's names are the reference's constants
    from ome_tpu import constants
    assert (multihost.JAX_COORDINATOR_ENV, multihost.JAX_NUM_PROCESSES_ENV,
            multihost.JAX_PROCESS_ID_ENV) == (
        constants.JAX_COORDINATOR_ENV, constants.JAX_NUM_PROCESSES_ENV,
        constants.JAX_PROCESS_ID_ENV)


@pytest.mark.parametrize("device,backend,want", [
    ("cuda", None, ("cuda:1", "nccl")),
    ("cuda:0", None, ("cuda:0", "nccl")),
    ("cuda:0", "gloo", ("cuda:0", "gloo")),
    ("cpu", None, ("cpu", "gloo"))])
def test_join_makes_the_rank_card_current(monkeypatch, device, backend,
                                          want):
    """A rank of local index 1 joins on its card (a host of two cards,
    mocked) and makes it the process's current device, so that the
    kernels' launches (which go to the current device) land on it; the
    CPU sets no device."""
    from ome_tpu_torch.parallel import comm
    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(comm.Group, "init", classmethod(
        lambda cls, address, rank, size, be, device=None, timeout=0:
        joined.append((address, rank, size, be, device)) or "group"))
    ctx = multihost.DistContext("leader:6000", 2, 1, local_rank=1)
    info, group = ctx.join(device, backend)
    assert group == "group" and (str(info.device), info.backend) == want
    assert joined == [("leader:6000", 1, 2, want[1], info.device)]
    assert current == ([] if device == "cpu" else [info.device])


MSGS = [{"op": "prefill", "ids": [1, 2, 3], "temperature": 0.5,
         "top_k": 4, "top_p": 0.9, "first_mask": None, "adapter": None},
        {"op": "decode", "temperature": [0.0, 0.8], "top_k": [0, 3],
         "top_p": [1.0, 0.5], "mask": None, "mask_idx": [0, 2]},
        {"op": "stop"}]


@pytest.mark.parametrize("msg", MSGS, ids=lambda m: m["op"])
def test_wire_bytes_equal_the_reference(msg):
    def frames(send):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            a.shutdown(socket.SHUT_WR)
            data = b""
            while True:
                chunk = b.recv(65536)
                if not chunk:
                    return data
                data += chunk
    ours = frames(multihost._send_msg)
    assert ours == frames(jmultihost._send_msg)
    assert len(ours) == 4 + int.from_bytes(ours[:4], "little")


def test_received_frames_decode_as_the_reference_decodes():
    for msg in MSGS:
        a, b = socket.socketpair()
        with a, b:
            jmultihost._send_msg(a, msg)
            assert multihost._recv_msg(b) == msg
            multihost._send_msg(a, msg)
            assert jmultihost._recv_msg(b) == msg


class FakePub:
    def __init__(self):
        self.msgs = []

    def send(self, m):
        self.msgs.append(m)


def test_replicated_engine_publishes_op_stream():
    """Every device-touching call on the leader reaches followers in
    order, carrying only host args (device tensors read back)."""
    class FakeEngine:
        def prefill(self, ids, t, k, p):
            return 7, ("k", "v"), len(ids), 16

        def insert(self, state, kv, slot, true_len, token, bucket):
            return state

        def decode(self, state, t, k, p):
            return state, np.asarray([1, 2], np.int32)

    pub = FakePub()
    eng = multihost.ReplicatedEngine(FakeEngine(), pub)
    tok, kv, tl, b = eng.prefill([1, 2, 3], 0.5, 4, 0.9)
    eng.insert(None, kv, 1, tl, tok, b)
    eng.decode(None, torch.zeros(2), np.zeros(2, np.int32),
               np.ones(2, np.float32))
    assert [m["op"] for m in pub.msgs] == ["prefill", "insert", "decode"]
    assert pub.msgs[0]["ids"] == [1, 2, 3]
    assert pub.msgs[0]["temperature"] == 0.5
    assert pub.msgs[1] == {"op": "insert", "slot": 1, "true_len": 3,
                           "token": 7, "bucket": 16, "adapter": None}
    assert pub.msgs[2]["temperature"] == [0.0, 0.0]
    # the same ops through the reference's wrapper publish the same dicts
    jpub = FakePub()
    jeng = jmultihost.ReplicatedEngine(FakeEngine(), jpub)
    t2, kv2, tl2, b2 = jeng.prefill([1, 2, 3], 0.5, 4, 0.9)
    jeng.insert(None, kv2, 1, tl2, t2, b2)
    jeng.decode(None, np.zeros(2, np.float32), np.zeros(2, np.int32),
                np.ones(2, np.float32))
    assert jpub.msgs == pub.msgs


def test_pd_blob_replication_single_fetch():
    """A PD decode-group leader fetches the KV wire blob ONCE and ships
    the bytes; followers deserialize without fetching."""
    from ome_tpu_torch.engine.pd import serialize_kv
    blob = serialize_kv(5, np.ones((1, 1, 2, 1, 2), np.float32),
                        np.zeros((1, 1, 2, 1, 2), np.float32), 2, 2)
    fetches = []

    class FakeRemoteEngine:
        def prefill_blob(self, ids, t, k, p):
            fetches.append(tuple(ids))
            return blob

    pub = FakePub()
    eng = multihost.ReplicatedEngine(FakeRemoteEngine(), pub)
    tok, kv, tl, b = eng.prefill([1, 2, 3])
    assert fetches == [(1, 2, 3)]
    assert (tok, tl, b) == (5, 2, 2)
    assert pub.msgs[0]["op"] == "prefill_blob"
    assert base64.b64decode(pub.msgs[0]["blob"]) == blob
    inserted = []

    class FakeEngine:
        def new_state(self):
            return "s0"

        def insert(self, state, kv, slot, true_len, token, bucket):
            inserted.append((slot, true_len, token, bucket,
                             float(np.asarray(kv[0]).sum())))
            return "s1"

    class FakeSub:
        def __init__(self, msgs):
            self.msgs = list(msgs)

        def recv(self):
            return self.msgs.pop(0) if self.msgs else {"op": "stop"}

    rc = multihost.follower_loop(FakeEngine(), FakeSub([
        pub.msgs[0],
        {"op": "insert", "slot": 1, "true_len": 2, "token": 5,
         "bucket": 2}]))
    assert rc == 0
    assert inserted == [(1, 2, 5, 2, 4.0)]


def test_follower_replays_and_exits_on_drop():
    ops = [
        {"op": "prefill", "ids": [1, 2], "temperature": 0.0,
         "top_k": 0, "top_p": 1.0},
        {"op": "insert", "slot": 0, "true_len": 2, "token": 9,
         "bucket": 16},
        {"op": "decode", "temperature": [0.0], "top_k": [0],
         "top_p": [1.0]},
    ]

    class FakeSub:
        def __init__(self, msgs):
            self.msgs = list(msgs)

        def recv(self):
            return self.msgs.pop(0) if self.msgs else None

    calls = []

    class FakeEngine:
        def new_state(self):
            return "s0"

        def prefill(self, ids, t, k, p):
            calls.append(("prefill", tuple(ids)))
            return 9, "kv", len(ids), 16

        def insert(self, state, kv, slot, true_len, token, bucket):
            calls.append(("insert", slot, true_len, token))
            return "s1"

        def decode(self, state, t, k, p):
            calls.append(("decode", state))
            return "s2", np.asarray([3], np.int32)

    rc = multihost.follower_loop(FakeEngine(), FakeSub(ops))
    assert rc == 1  # stream ended without an orderly stop
    assert calls == [("prefill", (1, 2)), ("insert", 0, 2, 9),
                     ("decode", "s1")]
    assert multihost.follower_loop(FakeEngine(),
                                   FakeSub([{"op": "stop"}])) == 0


def test_drift_repair_clears_only_refused_adapters_refs():
    unregisters = []

    class FakeEngine:
        _slot_adapters = np.asarray([0, 2, 1, 2], np.int32)

        def new_state(self):
            return "s0"

        def adapter_id(self, name):
            return {"keep": 1, "refused": 2}[name]

        def unregister_adapter(self, name):
            unregisters.append(name)
            if len(unregisters) == 1:
                raise ValueError(f"adapter {name!r} is busy")

    class FakeSub:
        def __init__(self, msgs):
            self.msgs = list(msgs)

        def recv(self):
            return self.msgs.pop(0) if self.msgs else {"op": "stop"}

    eng = FakeEngine()
    rc = multihost.follower_loop(eng, FakeSub(
        [{"op": "unregister_adapter", "name": "refused"}]))
    assert rc == 0
    assert unregisters == ["refused", "refused"]
    assert eng._slot_adapters.tolist() == [0, 0, 1, 0]


def _np_tree(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    tree = init_params(cfg, gen, "cpu")
    return {k: {kk: to_numpy(vv) for kk, vv in v.items()}
            if isinstance(v, dict) else to_numpy(v)
            for k, v in tree.items()}


def test_two_process_group_matches_jax_tp2():
    """Leader + follower over the control channel (tp=2 spanning both
    processes) emit the JAX tp=2 engine's streams for the scripted op
    mix (masked steps included) and the spec x chunk scheduler, and the
    follower's tokens equal the leader's, op for op, at temperature 0.8
    too."""
    tree = _np_tree(tiny_test().replace(dtype=torch.float32))
    leader, follower = workers.run_group(
        workers.replicated, tree, tiny_test().replace(dtype=torch.float32),
        workers.free_port())
    assert follower["rc"] == 0  # orderly stop
    # every op's tokens, greedy and sampled at temperature 0.8: the
    # follower fed its cache what the leader fed its own
    assert follower["log"] == leader["log"] and len(leader["log"]) > 20
    assert leader["sampled"] != [s[:8] for s in leader["script"]]
    jcfg = jtiny().replace(dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, tree)

    def ref():
        return JaxSharded(params, jcfg, tp=2, max_slots=2, max_seq=64,
                          prefill_buckets=[16])
    assert leader["script"] == run_script(ref())
    assert leader["spec"] == jax_run_spec(ref())


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _complete(port, prompt):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": prompt, "max_tokens": 10,
                         "temperature": 0.0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


def _model_dir(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": 300,
        "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 96, "max_position_embeddings": 128,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0}))
    return str(d)


def test_lws_environment_group_serves_and_fails_fast(tmp_path):
    from ome_tpu_torch.engine.serve import build_server
    model = _model_dir(tmp_path)
    common = ["--model-dir", model, "--random-weights", "--device", "cpu",
              "--dtype", "float32", "--max-slots", "2", "--max-seq", "64",
              "--host", "127.0.0.1"]
    prompts = ["hello there", "abcabcabc"]
    server, _, _ = build_server(common + ["--port", "0"])
    try:
        want = [_complete(server.port, p) for p in prompts]
    finally:
        server.stop()
    coord, ctrl, http = (workers.free_port() for _ in range(3))
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ome_tpu_torch.engine.serve", *common,
             "--port", str(http), "--control-port", str(ctrl)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    leader, follower = procs
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _get(f"http://127.0.0.1:{http}/health")[0] == 200:
                    break
            except OSError:
                pass
            assert leader.poll() is None and follower.poll() is None, \
                leader.stderr.read().decode()[-3000:] if leader.poll() \
                is not None else follower.stderr.read().decode()[-3000:]
            assert time.monotonic() < deadline, "the group never served"
            time.sleep(0.2)
        assert [_complete(http, p) for p in prompts] == want
        follower.kill()
        follower.wait()
        deadline = time.monotonic() + 30
        while _get(f"http://127.0.0.1:{http}/health")[0] != 503:
            assert time.monotonic() < deadline, \
                "the leader stayed healthy without its follower"
            time.sleep(0.1)
        assert _get(f"http://127.0.0.1:{http}/health")[1]["status"] == \
            "dead"
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def test_pd_roles_inside_a_group(tmp_path):
    """A tp=2 group as a PD decode node (the leader fetches each blob once
    and replicates it; every rank inserts its KV heads) and as a PD
    prefill node (the followers join the leader's gather of every rank's
    heads): each pair, with a tp=1 node on the other side, answers what
    a tp=1 monolithic server answers."""
    from ome_tpu_torch.engine.serve import build_server
    model = _model_dir(tmp_path)
    common = ["--model-dir", model, "--random-weights", "--device", "cpu",
              "--dtype", "float32", "--max-slots", "2", "--max-seq", "64",
              "--host", "127.0.0.1", "--port", "0"]
    prompts = ["disaggregated", [7, 8, 9, 10, 11, 12, 13]]

    def url(server):
        return f"http://127.0.0.1:{server.port}"

    servers = []

    def start(*extra):
        servers.append(build_server(common + list(extra))[0])
        return servers[-1]
    try:
        want = [_complete(start().port, p) for p in prompts]
        pre1 = start("--disaggregation-mode", "prefill")
        dec2 = start("--tp", "2", "--disaggregation-mode", "decode",
                     "--prefill-url", url(pre1))
        assert [_complete(dec2.port, p) for p in prompts] == want
        pre2 = start("--tp", "2", "--disaggregation-mode", "prefill")
        dec1 = start("--disaggregation-mode", "decode", "--prefill-url",
                     url(pre2))
        assert [_complete(dec1.port, p) for p in prompts] == want
    finally:
        for s in reversed(servers):
            s.stop()
