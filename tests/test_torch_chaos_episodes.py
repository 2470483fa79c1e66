"""The reference's five fast chaos episodes (tests/test_chaos.py) through
the port's harness (`ome_tpu_torch/chaos.py`), with the port's engines
and routers as children on `--device cpu`: the same seeds, topologies
and plans, and no violation.

Besides the reference's invariants, the port's harness holds every
greedy stream a serving child's journal finished against the oracle's
journaled token ids (`_check_greedy_ids`); each episode reports how
many it compared in `ep.measured["greedy_ids"]`.

The children run with one intra-op thread each (OMP_NUM_THREADS, which
they inherit): the episodes start up to five processes on a host the
other test files share.
"""

import json
import pathlib

import pytest

from ome_tpu_torch import chaos


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _runner(tmp_path, topo, **kw):
    return chaos.ChaosRunner(topo, pathlib.Path(tmp_path),
                             journal_drain_timeout=60.0, device="cpu",
                             **kw)


def _run_one(tmp_path, topo, seed, episode=0, requests=5, spread=2.0):
    runner = _runner(tmp_path, topo)
    try:
        ep = chaos._plan_episode(seed, episode, topo, requests, spread)
        runner.run_episode(ep)
    finally:
        runner.close()
    assert ep.violations == [], "\n".join(
        ep.violations + [ep.replay_command()])
    return ep


def test_fixed_seed_unified_episode(tmp_path):
    """Router + one unified engine; seed 7 derives an engine_step
    fault AND a SIGKILL mid-decode: journal kill-and-resume, greedy
    streams against the fault-free oracle."""
    topo = chaos.Topology(prefill=0, decode=0, unified=1, router=True,
                          kv_block=16, kv_blocks=40)
    ep = _run_one(tmp_path, topo, seed=7)
    assert any(act == "sigkill" for _, act, _ in ep.events)
    assert "engine_step" in ep.fault_specs.get("unified0", "")
    # the victim really came back: a second incarnation reached /health
    assert len(ep.measured["ready_s"]["unified0"]) == 2
    assert "unified0" in ep.measured["programs"]


def test_fixed_seed_pd_episode(tmp_path):
    """Prefill + decode pair (no router); seed 4 derives a PD fault on
    the decode node AND a prefill-peer kill mid-handoff: failover /
    local fallback without a decode-scheduler restart."""
    topo = chaos.Topology(prefill=1, decode=1, unified=0, router=False,
                          kv_block=16, kv_blocks=40,
                          pd_local_fallback=True)
    ep = _run_one(tmp_path, topo, seed=4)
    assert any(act == "kill_prefill" for _, act, _ in ep.events)
    assert ep.fault_specs.get("decode0", "").startswith("pd_")
    # greedy streams finished on the decode node, held by token ids
    assert ep.measured["greedy_ids"] > 0


def test_fixed_seed_noisy_neighbor_episode(tmp_path):
    """Noisy-neighbor episode: a batch flood at 5x slot capacity
    against steady interactive traffic, plus one mid-episode SIGKILL;
    no admitted class starves, weighted shares hold, interactive is
    never shed."""
    topo = chaos.Topology(prefill=0, decode=0, unified=1,
                          router=False, kv_block=16, kv_blocks=40)
    runner = _runner(tmp_path, topo)
    try:
        ep = chaos._plan_episode(7, 0, topo, 5, 2.0, kind="noisy")
        assert ep.kind == "noisy"
        assert not ep.fault_specs
        assert any(act == "sigkill" for _, act, _ in ep.events)
        classes = {r.priority for r in ep.requests}
        assert {"batch", "interactive"} <= classes
        n_batch = sum(r.priority == "batch" for r in ep.requests)
        assert n_batch >= 5 * topo.max_slots
        assert "--noisy-neighbor" in ep.replay_command()
        runner.run_episode(ep)
    finally:
        runner.close()
    assert ep.violations == [], "\n".join(
        ep.violations + [ep.replay_command()])


def test_fixed_seed_router_loss_episode(tmp_path):
    """Router-loss episode: two asyncio router replicas gossiping
    front two engines; one takes a keyed forward fault and is then
    SIGKILLed mid-replay. Exactly one outcome per request fleet-wide,
    and the survivor holds the dead replica's breaker observations."""
    topo = chaos.Topology(prefill=0, decode=0, unified=2, router=True,
                          routers=2, kv_block=16, kv_blocks=40)
    runner = _runner(tmp_path, topo)
    try:
        ep = chaos._plan_episode(3, 0, topo, 4, 1.5,
                                 kind="router_loss")
        victims = [t for _, act, t in ep.events
                   if act == "sigkill_router"]
        assert len(victims) == 1 and victims[0].startswith("router")
        assert ep.fault_specs[victims[0]].startswith(
            "router_forward|")
        assert "--router-loss" in ep.replay_command()
        assert "--routers 2" in ep.replay_command()
        runner.run_episode(ep)
    finally:
        runner.close()
    assert ep.violations == [], "\n".join(
        ep.violations + [ep.replay_command()])
    assert all(r.answers == 1 for r in ep.requests)


def test_forced_violation_collects_bundle(tmp_path):
    """A violating episode leaves a replay bundle: schedule +
    violations, one flight dump per live engine child, and every span
    log merged into an exported trace. Seed 5 derives an empty
    schedule for this topology, so the only violation is the forced
    one."""
    topo = chaos.Topology(prefill=0, decode=0, unified=1, router=False,
                          kv_block=16, kv_blocks=40)
    runner = _runner(tmp_path, topo, force_violation=True)
    try:
        ep = chaos._plan_episode(5, 0, topo, 2, 0.5)
        assert not ep.fault_specs and not ep.events
        runner.run_episode(ep)
    finally:
        runner.close()
    assert ep.violations == ["forced violation (--force-violation)"]

    bundle = pathlib.Path(tmp_path) / "ep0" / "bundle"
    manifest = json.loads((bundle / "violation.json").read_text())
    assert manifest["schedule"]["seed"] == 5
    assert any("forced violation" in v
               for v in manifest["violations"])
    assert "--episode 0" in manifest["replay"]
    flight = json.loads((bundle / "flight-unified0.json").read_text())
    assert flight["component"] == "unified0"
    events = [e["event"] for e in flight["events"]]
    assert "admit" in events and "slot_assign" in events
    trace = json.loads((bundle / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert "engine.request" in names
    assert any(n.startswith("flight:") for n in names)
    assert trace["otherData"]["span_count"] > 0


@pytest.mark.slow
def test_soak_multinode(tmp_path):
    """The reference's acceptance-shaped topology: router + 2 prefill +
    2 decode port engines, several seeded episodes end to end."""
    topo = chaos.Topology(prefill=2, decode=2, unified=0, router=True,
                          pd_local_fallback=True)
    rc = chaos.run_soak(seed=11, episodes=range(3), topo=topo,
                        base_dir=pathlib.Path(tmp_path),
                        n_requests=8, spread=3.0,
                        journal_drain_timeout=90.0, device="cpu")
    assert rc == 0
