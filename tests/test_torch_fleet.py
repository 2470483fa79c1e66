"""The port's model fleet (`ome_tpu_torch/autoscale/fleet.py`) held
against the reference's (`ome_tpu/autoscale/fleet.py`) over the same
fake pools — eviction order, budget errors, warm standby, `reap_idle`,
one spawn under concurrent `ensure`, status rows — and, through the
port's engines on the CPU, the evict -> kill mid-drain -> respawn path:
the killed member resumes its journal, and the greedy streams before
and after, and the resumed one, are the same token ids.

The reference's test of the live path races a 400-token decode against
the kill. Here every decode step is paced by an `engine_step.slow`
rule, so the request is still live when the kill lands on any host.
"""

import json
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from ome_tpu.autoscale import fleet as ref_fleet
from ome_tpu_torch.autoscale import fleet
from ome_tpu_torch.chaos import journal_live_entries, journal_streams


class _FakePool:
    """EnginePool-shaped double recording the drain ladder."""

    def __init__(self, name, log, delay=0.0):
        self.name, self.log, self.delay = name, log, delay
        self.members = 1

    def spawn(self):
        time.sleep(self.delay)
        self.log.append(("spawn", self.name))

    def drain_one(self):
        if self.members == 0:
            return None
        self.members -= 1
        self.log.append(("drain_one", self.name))
        return object()

    def join_drains(self, timeout=None):
        self.log.append(("join_drains", self.name))

    def stop_all(self):
        self.log.append(("stop_all", self.name))

    def size(self):
        return self.members

    def draining_count(self):
        return 0


def _script(mod, tmp_path, budget, ops, warm_standby=1):
    """Run `ops` on one package's ModelFleet over fake pools and a
    scripted clock; return everything observable."""
    clock = [0.0]
    log = []
    f = mod.ModelFleet(None, tmp_path / mod.__name__, budget,
                       warm_standby=warm_standby,
                       pool_factory=lambda e: _FakePool(e.name, log),
                       clock=lambda: clock[0])
    args = lambda port, name, jdir: []  # noqa: E731
    out = []
    for op, *a in ops:
        try:
            if op == "register":
                f.register_model(a[0], a[1], args,
                                 warmup_ms=10.0 * len(a[0]))
                res = None
            elif op == "at":
                clock[0] = a[0]
                res = None
            elif op == "ensure":
                res = f.ensure(a[0]).name
            elif op == "touch":
                res = f.touch(a[0])
            elif op == "evict":
                res = f.evict(a[0], reason="test")
            elif op == "reap":
                res = f.reap_idle(a[0])
            out.append((op, res, f.resident_models(), f.resident_bytes()))
        except (mod.UnknownModelError, mod.FleetBudgetError) as e:
            out.append((op, type(e).__name__, str(e)))
    events = [(e.kind, e.model, e.reason, e.freed_bytes)
              for e in f.events]
    status = {k: {kk: vv for kk, vv in v.items() if kk != "last_used"}
              for k, v in f.status().items()}
    return out, events, log, f.catalog(), status


SCRIPTS = {
    "lru": (120, [("register", "a", 60), ("register", "b", 50),
                  ("register", "c", 40), ("ensure", "a"), ("at", 1.0),
                  ("ensure", "b"), ("at", 2.0), ("touch", "a"),
                  ("at", 3.0), ("ensure", "c"), ("ensure", "b"),
                  ("at", 4.0), ("ensure", "a"), ("evict", "a"),
                  ("evict", "a")]),
    "cold": (70, [("register", "a", 60), ("register", "b", 50),
                  ("ensure", "a"), ("ensure", "b"), ("ensure", "a"),
                  ("ensure", "nope"), ("register", "huge", 71)]),
    "reap": (200, [("register", "a", 60), ("register", "b", 50),
                   ("register", "c", 40), ("ensure", "a"), ("at", 5.0),
                   ("ensure", "b"), ("at", 20.0), ("ensure", "c"),
                   ("at", 100.0), ("reap", 30.0), ("at", 140.0),
                   ("reap", 30.0), ("reap", 30.0)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("warm_standby", [0, 1, 2])
def test_fleet_equals_the_reference_over_fake_pools(tmp_path, name,
                                                    warm_standby):
    budget, ops = SCRIPTS[name]
    mine = _script(fleet, tmp_path, budget, ops, warm_standby)
    theirs = _script(ref_fleet, tmp_path, budget, ops, warm_standby)
    assert mine == theirs
    if name == "lru":
        evicted = [e for e in mine[1] if e[0] == "evict"]
        assert evicted[0][:2] == ("evict", "b")
        assert [op for op, n in mine[2] if n == "b"][:4] == [
            "spawn", "drain_one", "join_drains", "stop_all"]


def test_concurrent_ensure_spawns_once(tmp_path):
    log = []
    f = fleet.ModelFleet(None, tmp_path, 100,
                         pool_factory=lambda e: _FakePool(e.name, log,
                                                          delay=0.2))
    f.register_model("m", 50, lambda p, n, j: [])
    pools = []
    threads = [threading.Thread(target=lambda: pools.append(
        f.ensure("m"))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert log == [("spawn", "m")]
    assert len(pools) == 4 and len({id(p) for p in pools}) == 1


def test_default_pool_runs_on_the_fleet_device(tmp_path):
    f = fleet.ModelFleet(None, tmp_path, 100)
    assert f.device == "cuda"
    f.register_model("m", 10, lambda p, n, j: [])
    assert f._default_pool(f._entries["m"]).device == "cuda"
    g = fleet.ModelFleet(None, tmp_path, 100, device="cpu")
    g.register_model("m", 10, lambda p, n, j: [])
    assert g._default_pool(g._entries["m"]).device == "cpu"


# -- evict, kill mid-drain, respawn (the port's engines, CPU) ----------

PACE_S = 0.05
PROMPT = "abcd"


def _engine_args_factory(model_dir):
    def engine_args(port, name, journal_dir):
        return ["--model-dir", str(model_dir), "--random-weights",
                "--dtype", "float32", "--host", "127.0.0.1",
                "--port", str(port), "--max-slots", "2",
                "--kv-block", "16", "--kv-blocks", "40",
                "--prefix-cache-mb", "8", "--drain-grace", "30",
                "--journal", str(journal_dir),
                "--journal-fsync", "always",
                "--faults", f"engine_step.slow={PACE_S}@1:1000000"]
    return engine_args


def _greedy_stream(url, max_tokens):
    body = json.dumps({"prompt": PROMPT, "max_tokens": max_tokens,
                       "temperature": 0.0, "stream": True}).encode()
    req = urllib.request.Request(
        url + "/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data:") and line != "data: [DONE]":
                ev = json.loads(line[len("data:"):])
                chunks.append(ev["choices"][0].get("text") or "")
    return "".join(chunks)


def _wait_tombstones(journals, timeout=30.0):
    """A response's last byte goes out before the scheduler appends its
    tombstone: wait until no journal holds a live entry."""
    deadline = time.monotonic() + timeout
    while any(journal_live_entries(p) for p in journals) and \
            time.monotonic() < deadline:
        time.sleep(0.05)


def test_evict_kill_mid_drain_respawn_identical_ids(tmp_path,
                                                    monkeypatch):
    """A pool evicted while holding journaled work drains first; a
    SIGKILL mid-evict respawns the member on the same journal, which
    finishes the request; the re-ensured pool then gives the same
    greedy token ids for the baseline prompt and for the resumed one."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    f = fleet.ModelFleet(None, tmp_path / "fleet", 1000,
                         ready_timeout=120.0, device="cpu")
    f.register_model("m1", 100, _engine_args_factory(model_dir))
    pool = f.ensure("m1")
    try:
        url = pool.member_urls()[0]
        baseline = _greedy_stream(url, 8)
        with pool._lock:
            member = pool._members[0]
        _wait_tombstones([member.journal])

        def long_request():
            try:
                _greedy_stream(url, 48)
            except (urllib.error.URLError, OSError):
                pass  # the mid-evict kill tears this stream

        t = threading.Thread(target=long_request, daemon=True)
        t.start()
        # wait until the request has journaled progress: 48 paced steps
        # take >= 2.4 s, so it is live when the kill lands
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            live = journal_live_entries(member.journal)
            if any(e.get("toks") for e in live.values()):
                break
            time.sleep(0.05)
        assert journal_live_entries(member.journal), "never admitted"

        evictor = threading.Thread(target=f.evict, args=("m1",),
                                   kwargs={"reason": "test"}, daemon=True)
        evictor.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not member.draining:
            time.sleep(0.02)
        assert member.draining
        member.proc.kill()     # mid-evict, journaled work live
        evictor.join(timeout=240)
        assert not evictor.is_alive()
        assert f.pool("m1") is None
        assert len(pool.drains) == 1
        rec = pool.drains[0]
        assert rec.resumed and rec.ok, vars(rec)
        assert sum(len(journal_live_entries(p))
                   for p in pool.journals()) == 0
        assert len(member.proc.ready_s) == 2

        pool2 = f.ensure("m1")
        assert pool2 is not pool
        url2 = pool2.member_urls()[0]
        assert _greedy_stream(url2, 8) == baseline
        _greedy_stream(url2, 48)
        _wait_tombstones(pool2.journals())
    finally:
        f.stop_all()
    # every incarnation journals into the same file: the baseline and
    # its rerun, the killed-and-resumed request and its fresh twin
    streams = [s for p in pool.journals() for s in journal_streams(p)]
    by_budget = {}
    for s in streams:
        assert s["reason"] == "length", s
        by_budget.setdefault(s["max_new"], []).append(s["toks"])
    assert sorted(by_budget) == [8, 48]
    for budget, runs in by_budget.items():
        assert len(runs) == 2 and runs[0] == runs[1], (budget, runs)
        assert len(runs[0]) == budget


@pytest.mark.parametrize("root", ["ome_tpu_torch/autoscale",
                                  "ome_tpu_torch/chaos.py"])
def test_concurrency_lint_is_clean(root):
    """omelint's blocking-in-async, lock-discipline and thread-shared-
    state rules find nothing in the fleet's layer (the reference's
    `autoscale/` has no finding of these rules either)."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    args = [sys.executable, str(repo / "scripts" / "omelint.py"),
            "--root", str(repo / root), "--no-baseline"]
    for rule in ("blocking-in-async", "lock-discipline",
                 "thread-shared-state"):
        args += ["--rule", rule]
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=300, cwd=repo)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout.strip().splitlines()[-1]
