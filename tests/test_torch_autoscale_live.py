"""The port's closed loop through its own engines on the CPU (the
reference's live tests in tests/test_autoscale.py, with the port's
router and engine children on `--device cpu`): a bursty trace scales
the pool 1 -> 2 -> 1 with no request lost and greedy streams consistent
across the scale events; a SIGKILL mid-drain respawns the engine on its
journal and the drain still completes clean.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from ome_tpu_torch.autoscale import controller as ctl_mod
from ome_tpu_torch.autoscale import replay as replay_mod
from ome_tpu_torch.autoscale import trace as trace_mod
from ome_tpu_torch.autoscale.policy import PolicyConfig, PoolPolicy
from ome_tpu_torch.autoscale.pool import EnginePool
from ome_tpu_torch.chaos import ManagedProc, free_port, journal_live_entries


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _engine_args_factory(model_dir, drain_grace=6.0, pace_s=None):
    def engine_args(port, name, journal_dir):
        args = ["--model-dir", str(model_dir), "--random-weights",
                "--dtype", "float32", "--host", "127.0.0.1",
                "--port", str(port), "--max-slots", "2",
                "--kv-block", "16", "--kv-blocks", "40",
                "--prefix-cache-mb", "8",
                "--drain-grace", str(drain_grace),
                "--journal", str(journal_dir),
                "--journal-fsync", "always"]
        if pace_s:
            # every decode step takes at least pace_s seconds
            args += ["--faults", f"engine_step.slow={pace_s}@1:1000000"]
        return args
    return engine_args


def _spawn_router(pool, base):
    rport = free_port()
    rargs = ["--bind", "127.0.0.1", "--port", str(rport),
             "--policy", "round_robin", "--health-interval", "0.5",
             "--debug-endpoints"]
    for url in pool.member_urls():
        rargs += ["--backend", url]
    router = ManagedProc("router", "router", rargs, rport,
                         base / "router.log")
    router.start()
    router.wait_ready()
    return router


def _journal_leftover(pool):
    return sum(len(journal_live_entries(p)) for p in pool.journals())


def _assert_greedy_prefix_consistent(results):
    """Greedy streams of one prompt agree whatever engine or scale
    event served them: equal budgets exactly, different budgets on the
    common prefix."""
    by_prompt = {}
    for r in results:
        if r.temperature == 0.0 and r.ok:
            by_prompt.setdefault(r.prompt, []).append(
                (r.max_tokens, r.text))
    compared = 0
    for pairs in by_prompt.values():
        pairs.sort()
        for (mt_a, a), (mt_b, b) in zip(pairs, pairs[1:]):
            if mt_a == mt_b:
                assert a == b, (a, b)
            else:
                assert b.startswith(a), (a, b)
            compared += 1
    assert compared > 0


def test_scale_up_burst_then_drain_down(tmp_path):
    """A bursty trace pushes the pool from 1 to 2 engines, the quiet
    after it drains back to 1, no admitted request is lost, and greedy
    streams stay consistent across the scale events. The reference's
    trace sustains its burst on the reference's CPU engines; the port's
    decode the tiny model several times faster, so each decode step is
    paced to 30 ms (an engine_step.slow rule) to hold the two slots
    across the controller's 0.5 s ticks on any host."""
    trace = trace_mod.synthetic_trace(
        7, n=16, base_rate=2.0, burst_factor=8.0, max_tokens=(24, 48))
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    pool = EnginePool("engine", None,
                      _engine_args_factory(model_dir, pace_s=0.03),
                      tmp_path, drain_exit_timeout=60.0, device="cpu")
    router = ctl = None
    try:
        pool.spawn()
        router = _spawn_router(pool, tmp_path)
        pool.router_url = router.url
        slo = ctl_mod.SLOConfig(ttft_p99_s=0.4, queue_wait_p99_s=0.2,
                                queue_depth_high=1.5)
        pol = PoolPolicy(PolicyConfig(
            min_size=1, max_size=2, up_stable_ticks=2,
            down_stable_ticks=4, cooldown_ticks=3, down_threshold=0.3))
        ctl = ctl_mod.ScaleController(
            {"engine": pool}, {"engine": pol}, slo,
            router_url=router.url, interval=0.5,
            clock=time.monotonic).start()
        results = replay_mod.replay(router.url, trace, timeout=180)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if (any(d.target < d.size for d in ctl.decisions)
                    and pool.draining_count() == 0
                    and pool.size() == 1):
                break
            time.sleep(0.5)
        ctl.stop()
        pool.join_drains(timeout=90.0)
        final_size = pool.size()
    finally:
        if ctl is not None:
            ctl.stop()
        pool.stop_all()
        if router is not None:
            router.stop()
    errs = [(r.trace_id, r.status, r.error) for r in results if not r.ok]
    assert errs == []
    decisions = [d.to_dict() for d in ctl.decisions]
    assert any(d["target"] > d["size"] for d in decisions), decisions
    assert any(d["target"] < d["size"] for d in decisions), decisions
    assert pool.drains and all(d.ok for d in pool.drains)
    assert _journal_leftover(pool) == 0
    assert final_size == 1
    _assert_greedy_prefix_consistent(results)
    assert all(r.output_tokens > 0 for r in results)
    # the scale-up's spawn was registered after it started
    assert len(pool.spawns) >= 2
    assert all(s["registered"] > s["started"] for s in pool.spawns)


def test_kill_during_scale_down_resumes_journal(tmp_path):
    """SIGKILL the victim mid-drain with admitted work outstanding:
    the pool respawns it on the same journal, restart-resume finishes
    the request, and the drain still ends with nothing left live.
    Decode is paced (10 ms a step) so that the 200-token request is
    still live when the kill lands, on any host."""
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    pool = EnginePool(
        "engine", None,
        _engine_args_factory(model_dir, drain_grace=30.0, pace_s=0.01),
        tmp_path, drain_exit_timeout=60.0, resume_timeout=90.0,
        device="cpu")
    try:
        pool.spawn()
        url = pool.member_urls()[0]
        body = json.dumps({"prompt": "abcd", "max_tokens": 200,
                           "temperature": 0.0, "stream": True}).encode()

        def long_request():
            req = urllib.request.Request(
                url + "/v1/completions", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    for _ in r:
                        pass
            except (urllib.error.URLError, OSError):
                pass  # the kill tears this stream

        t = threading.Thread(target=long_request, daemon=True)
        t.start()
        with pool._lock:
            member = pool._members[0]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if journal_live_entries(member.journal):
                break
            time.sleep(0.05)
        assert journal_live_entries(member.journal), \
            "request never admitted"
        assert pool.drain_one() is not None
        member.proc.kill()  # mid-drain, with journaled work live
        pool.join_drains(timeout=180.0)
        assert len(pool.drains) == 1
        rec = pool.drains[0]
        assert rec.resumed and rec.ok, vars(rec)
        assert _journal_leftover(pool) == 0
        assert pool.size() == 0
        # two incarnations of the member reached /health
        assert len(member.proc.ready_s) == 2
    finally:
        pool.stop_all()


@pytest.mark.slow
def test_bursty_soak_with_kill_mid_drain(tmp_path):
    """The reference's acceptance run through the port's engines: a
    bigger bursty trace scales 1 -> N and back with a SIGKILL landing on
    the first draining engine; no request lost, greedy streams
    consistent, fewer engine-seconds than static max provisioning.
    Decode is paced as in the smoke above."""
    trace = trace_mod.amplify_bursts(
        trace_mod.synthetic_trace(11, n=40, base_rate=2.0,
                                  burst_factor=8.0, max_tokens=(30, 60)),
        3, seed=11)
    killed = threading.Event()
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    pool = EnginePool("engine", None,
                      _engine_args_factory(model_dir, pace_s=0.03),
                      tmp_path, drain_exit_timeout=60.0, device="cpu")

    def chaos_kill():
        # SIGKILL the first member that starts draining
        while not killed.is_set():
            with pool._lock:
                victims = [m for m in pool._members if m.draining]
            if victims:
                victims[0].proc.kill()
                killed.set()
                return
            time.sleep(0.2)

    router = ctl = None
    t0 = time.monotonic()
    try:
        pool.spawn()
        router = _spawn_router(pool, tmp_path)
        pool.router_url = router.url
        ctl = ctl_mod.ScaleController(
            {"engine": pool}, {"engine": PoolPolicy(PolicyConfig(
                min_size=1, max_size=3, up_stable_ticks=2,
                down_stable_ticks=4, cooldown_ticks=3,
                down_threshold=0.3))},
            ctl_mod.SLOConfig(ttft_p99_s=0.4, queue_wait_p99_s=0.2,
                              queue_depth_high=1.5),
            router_url=router.url, interval=0.5).start()
        threading.Thread(target=chaos_kill, daemon=True).start()
        results = replay_mod.replay(router.url, trace, timeout=180)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if (any(d.target < d.size for d in ctl.decisions)
                    and pool.draining_count() == 0
                    and pool.size() == 1):
                break
            time.sleep(0.5)
        ctl.stop()
        pool.join_drains(timeout=90.0)
        wall = time.monotonic() - t0
    finally:
        if ctl is not None:
            ctl.stop()
        pool.stop_all()
        if router is not None:
            router.stop()
    assert [r for r in results if not r.ok] == []
    assert _journal_leftover(pool) == 0
    assert any(d.target > d.size for d in ctl.decisions)
    assert any(d.target < d.size for d in ctl.decisions)
    assert pool.drains and all(d.ok for d in pool.drains), \
        [vars(d) for d in pool.drains]
    assert killed.is_set()
    _assert_greedy_prefix_consistent(results)
    assert pool.engine_seconds() < 3 * wall
