"""The port's chaos harness (`ome_tpu_torch/chaos.py`) held against the
reference's (`ome_tpu/chaos.py`) on its pure functions: seeded episode
plans, workloads, trace-driven requests, the journal parser, the fault
catalog and its preflight refusals; the port's own refusals (a CUDA
`--kv-block` the paged kernel does not take, before any child spawns;
the two parts left for later, by name); and, through one engine and one
router child on the CPU, that every metric family the port's chaos,
controller and replay read is exported under that name.
"""

import json
import pathlib
import random
import re
import subprocess
import sys

import pytest

from ome_tpu import chaos as ref
from ome_tpu.lint.plugins.catalog_drift import catalog_points
from ome_tpu_torch import chaos
from ome_tpu_torch.autoscale import trace as port_trace

REPO = pathlib.Path(__file__).resolve().parents[1]

# (kind, topology) pairs of the reference's chaos tests, plus its
# acceptance topology
PLANS = [
    ("mixed", dict(prefill=0, decode=0, unified=1, router=True)),
    ("mixed", dict(prefill=1, decode=1, unified=0, router=False,
                   pd_local_fallback=True)),
    ("mixed", dict(prefill=2, decode=2, unified=0, router=True)),
    ("mixed", dict(prefill=0, decode=0, unified=2, router=True,
                   routers=2)),
    ("noisy", dict(prefill=0, decode=0, unified=1, router=False)),
    ("noisy", dict(prefill=0, decode=2, unified=1, router=True,
                   max_slots=3)),
    ("router_loss", dict(prefill=0, decode=0, unified=2, router=True,
                         routers=2)),
    ("router_loss", dict(prefill=0, decode=0, unified=3, router=True,
                         routers=3)),
]


def _requests(reqs):
    return [(r.prompt, r.max_tokens, r.temperature, r.top_k, r.top_p,
             r.delay, r.priority) for r in reqs]


@pytest.mark.parametrize("kind,topo", PLANS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(PLANS)])
def test_plans_equal_the_reference(kind, topo):
    """Seeds 0-49: the same schedule dict, exact event times and the
    same workload (every field) as the reference's `_plan_episode`."""
    for seed in range(50):
        for index in (0, 3):
            mine = chaos._plan_episode(seed, index, chaos.Topology(**topo),
                                       7, 3.0, kind=kind)
            theirs = ref._plan_episode(seed, index, ref.Topology(**topo),
                                       7, 3.0, kind=kind)
            assert mine.schedule() == theirs.schedule()
            assert mine.events == theirs.events
            assert mine.fault_specs == theirs.fault_specs
            assert _requests(mine.requests) == _requests(theirs.requests)


def test_workload_generators_equal_the_reference():
    for seed in range(20):
        for n, spread in ((1, 0.5), (10, 4.0), (33, 9.0)):
            assert _requests(chaos._gen_workload(
                random.Random(seed), n, spread)) == _requests(
                ref._gen_workload(random.Random(seed), n, spread))
        for topo, flood in ((dict(unified=1, decode=0, prefill=0), 5),
                            (dict(decode=2, unified=1, max_slots=4), 2)):
            assert _requests(chaos._gen_noisy_workload(
                random.Random(seed), chaos.Topology(**topo), 2.0,
                flood)) == _requests(ref._gen_noisy_workload(
                    random.Random(seed), ref.Topology(**topo), 2.0,
                    flood))


def test_trace_driven_requests_equal_the_reference(tmp_path):
    """`requests_from_trace` over a saved trace and over an engine
    request log: the same prompts, budgets, gaps and classes; a plan
    with a trace workload keeps the seeded fault schedule."""
    saved = tmp_path / "trace.jsonl"
    tr = port_trace.synthetic_trace(3, n=12, greedy_fraction=0.5)
    tr[2].priority = "batch"
    port_trace.save_trace(tr, saved)
    reqlog = tmp_path / "reqlog.jsonl"
    with open(reqlog, "w") as f:
        for i in range(6):
            # schema v2 (admit_ts) and v1 (ts - e2e_s) records, out of
            # admission order
            when = ({"admit_ts": 100.0 + 0.3 * (5 - i)} if i % 2 else
                    {"ts": 101.0 + 0.3 * i, "e2e_s": 1.0})
            f.write(json.dumps({
                "component": "engine", **when,
                "prompt_tokens": 4 + i, "output_tokens": 3 + i,
                "temperature": 0.0, "class": "interactive",
                "trace_id": f"t{i}"}) + "\n")
        f.write('{"component": "router", "ts": 1}\n{"torn')
    for path in (saved, reqlog):
        mine = chaos.requests_from_trace(path, prompt_seed=2)
        assert _requests(mine) == _requests(
            ref.requests_from_trace(path, prompt_seed=2))
        topo = dict(unified=1, decode=0, prefill=0)
        a = chaos._plan_episode(7, 0, chaos.Topology(**topo), 5, 2.0,
                                workload=mine)
        b = ref._plan_episode(7, 0, ref.Topology(**topo), 5, 2.0,
                              workload=ref.requests_from_trace(
                                  path, prompt_seed=2))
        assert a.schedule() == b.schedule()
        assert _requests(a.requests) == _requests(b.requests)
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(chaos.ChaosError, match="no replayable"):
        chaos.requests_from_trace(empty)


def test_journal_parsers_equal_the_reference(tmp_path):
    """`journal_live_entries` on the same files as the reference's —
    torn tails, blank lines, prog before admit — and the port's
    `journal_streams` (finished streams, across incarnations)."""
    cases = {
        "torn": '{"t": "admit", "jid": 1, "prompt": [1], "pd": null}\n'
                '{"t": "admit", "jid": 2, "prompt": [2]}\n'
                '{"t": "prog", "jid": 1, "toks": [5, 6]}\n'
                '{"t": "fin", "jid": 2, "reason": "length"}\n'
                '{"t": "prog", "jid": 1, "to',
        "messy": '\n{"t": "prog", "jid": 9, "toks": [1]}\n'
                 '{"t": "admit", "jid": 3, "prompt": [7, 8], "temp": 0.7}\n'
                 'not json\n\n{"t": "prog", "jid": 3, "toks": [4]}\n'
                 '{"t": "prog", "jid": 3, "toks": [5]}\n',
        "done": '{"t": "admit", "jid": 0, "prompt": [1, 2], "max_new": 3,'
                ' "temp": 0.0}\n{"t": "prog", "jid": 0, "toks": [9]}\n'
                '{"t": "prog", "jid": 0, "toks": [8, 7]}\n'
                '{"t": "fin", "jid": 0, "reason": "length"}\n',
    }
    for name, text in cases.items():
        p = tmp_path / f"{name}.jsonl"
        p.write_text(text)
        assert chaos.journal_live_entries(p) == \
            ref.journal_live_entries(p)
    assert chaos.journal_live_entries(tmp_path / "none.jsonl") == {}
    assert chaos.journal_streams(tmp_path / "done.jsonl") == [
        {"prompt": [1, 2], "max_new": 3, "temp": 0.0, "toks": [9, 8, 7],
         "reason": "length"}]
    assert chaos.journal_streams(tmp_path / "torn.jsonl") == [
        {"prompt": [2], "max_new": None, "temp": 0.0, "toks": [],
         "reason": "length"}]
    assert chaos.journal_streams(tmp_path / "messy.jsonl") == []


def test_fault_catalog_equals_the_reference_lint():
    doc = REPO / "docs" / "failure-semantics.md"
    mine = chaos.catalog_points(doc)
    assert mine == catalog_points(doc)
    assert {"engine_step", "pd_insert", "router_forward"} <= mine


@pytest.mark.parametrize("specs", [
    ["not_a_point.raise@1"],
    ["engine_step.raise@2", "bogus|http://x:1.slow=1@1"],
    ["engine_step.raise@2",
     "pd_fetch|http://x:1.raise@1 pd_insert.raise@3"],
    ["", "router_forward.raise@1"],
])
def test_preflight_refusals_equal_the_reference(specs):
    def outcome(mod):
        try:
            mod.preflight_fault_points(specs)
        except mod.ChaosError as e:
            return str(e)
        return None
    assert outcome(chaos) == outcome(ref)


def test_kv_block_refused_on_cuda_before_any_child(tmp_path):
    """On a CUDA device a block the paged kernel does not take is
    refused before anything spawns, with the engine's own reason; the
    CPU takes the reference's default of 16."""
    from ome_tpu_torch.ops.flash import check_paged_coverage
    topo = chaos.Topology(prefill=0, decode=0, unified=1, kv_block=16)
    with pytest.raises(chaos.ChaosError) as ei:
        chaos.ChaosRunner(topo, tmp_path / "cuda", device="cuda")
    with pytest.raises(ValueError) as engine:
        check_paged_coverage(16, 16, 8, 4)   # tiny_test's heads
    assert str(ei.value) == f"--kv-block 16: {engine.value}"
    assert sorted(p.name for p in (tmp_path / "cuda").iterdir()) == [
        "model"]
    # a 32-row block passes the block rule at a served head_dim
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": 256, "num_hidden_layers": 1,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 512}))
    chaos.refuse_kv_block(32, "cuda", str(tmp_path / "m"))
    with pytest.raises(chaos.ChaosError, match="--kv-block 48"):
        chaos.refuse_kv_block(48, "cuda:0", str(tmp_path / "m"))
    chaos.refuse_kv_block(16, "cpu", str(tmp_path / "m"))
    chaos.refuse_kv_block(0, "cuda", str(tmp_path / "m"))
    chaos.ChaosRunner(topo, tmp_path / "cpu", device="cpu").close()


def test_parts_left_for_later_are_refused_by_name(tmp_path):
    # the weight-plane kill episode is ported (tests/
    # test_torch_weightplane.py runs it); --schedule still waits for sim/
    assert "sim/" in chaos.SCHEDULE_NOT_PORTED
    with pytest.raises(SystemExit) as ex:
        chaos.main(["--schedule", str(tmp_path / "plan.json")])
    assert ex.value.code == 2


def _cli(*args, module="ome_tpu_torch.chaos"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)


def test_cli_refusals(tmp_path):
    out = _cli("--schedule", "x.json")
    assert out.returncode == 2
    assert "--schedule is not ported yet" in out.stderr
    assert "sim/" in out.stderr
    out = _cli("--unified", "1", "--decode", "0", "--prefill", "0",
               "--no-router", "--device", "cuda", "--kv-block", "16",
               "--base-dir", str(tmp_path))
    assert out.returncode == 2, out.stdout + out.stderr
    assert "refused: --kv-block 16: the CUDA paged decode kernel" \
        in out.stdout
    assert not list(tmp_path.glob("ep*"))
    # the closed loop and the replay's --topology refuse the same block
    # before any engine starts (their default device is cuda)
    for module, args in (
            ("ome_tpu_torch.autoscale.controller",
             ("--base-dir", str(tmp_path / "loop"))),
            ("ome_tpu_torch.autoscale.replay",
             ("--topology", "1", "--base-dir", str(tmp_path / "rp")))):
        out = _cli("--kv-block", "16", *args, module=module)
        assert out.returncode != 0
        assert "--kv-block 16: the CUDA paged decode kernel" in out.stderr
        assert not list(tmp_path.rglob("*.log"))


def _literal_families(path: pathlib.Path):
    return set(re.findall(r'"(ome_(?:engine|router)_[a-z0-9_]+)',
                          path.read_text()))


def test_every_metric_the_harness_reads_is_exported(tmp_path,
                                                     monkeypatch):
    """Each metric family named in the port's chaos.py, controller.py
    and replay.py is on a port engine's or router's /metrics — a
    renamed family would read as 0 and pass an invariant vacuously."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    pkg = REPO / "ome_tpu_torch"
    read = set()
    for rel in ("chaos.py", "autoscale/controller.py",
                "autoscale/replay.py", "autoscale/pool.py"):
        read |= _literal_families(pkg / rel)
    assert {"ome_engine_kv_conservation_ok", "ome_engine_class_tokens_total",
            "ome_engine_prefix_host_bytes", "ome_router_backends_draining",
            "ome_engine_ttft_seconds", "ome_engine_queue_wait_seconds",
            "ome_engine_class_ttft_seconds"} <= read
    (tmp_path / "model").mkdir()
    eport = chaos.free_port()
    engine = chaos.ManagedProc(
        "engine", "engine",
        ["--model-dir", str(tmp_path / "model"), "--random-weights",
         "--device", "cpu", "--dtype", "float32", "--host", "127.0.0.1",
         "--port", str(eport), "--max-slots", "2",
         "--prefix-cache-host-mb", "4", "--kv-block", "16",
         "--kv-blocks", "40"], eport, tmp_path / "engine.log")
    rport = chaos.free_port()
    router = chaos.ManagedProc(
        "router", "router",
        ["--bind", "127.0.0.1", "--port", str(rport), "--backend",
         engine.url, "--health-interval", "0.5"], rport,
        tmp_path / "router.log")
    try:
        engine.start()
        router.start()
        engine.wait_ready()
        router.wait_ready()
        for cls in ("interactive", "standard", "batch"):
            status, _ = chaos._http(router.url + "/v1/completions", {
                "prompt": "abc", "max_tokens": 3, "priority": cls})
            assert status == 200
        text = "\n".join(
            chaos._http(p.url + "/metrics")[1].decode()
            for p in (engine, router))
        exported = {m.group(1) for m in re.finditer(
            r"^(ome_[a-z0-9_]+?)(?:_bucket|_sum|_count)?[{ ]", text,
            re.M)}
        assert len(engine.ready_s) == 1 and engine.ready_s[0] > 0
    finally:
        router.stop()
        engine.stop()
    missing = sorted(read - exported)
    assert not missing, missing
