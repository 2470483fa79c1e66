"""The port's autoscaling layers (`ome_tpu_torch/autoscale/`) held
against the reference's (`ome_tpu/autoscale/`) with no subprocess:
traces and their transforms, the hysteresis policy's decisions, the
controller's decisions over the same fake pool and scrape script, and
the replay report and SLO section over the same results. The live
closed loop through the port's engines is `test_torch_autoscale_live.py`.
"""

import dataclasses
import json

import numpy as np
import pytest

from ome_tpu.autoscale import controller as ref_ctl
from ome_tpu.autoscale import policy as ref_policy
from ome_tpu.autoscale import replay as ref_replay
from ome_tpu.autoscale import trace as ref_trace
from ome_tpu.slo import load as ref_load_slo
from ome_tpu_torch.autoscale import controller as ctl
from ome_tpu_torch.autoscale import policy
from ome_tpu_torch.autoscale import replay
from ome_tpu_torch.autoscale import trace
from ome_tpu_torch.slo import load as load_slo
from ome_tpu_torch.telemetry import RequestLog


def _rows(tr):
    return [dataclasses.astuple(r) for r in tr]


TRACES = [
    ("synthetic_trace", dict(n=40)),
    ("synthetic_trace", dict(n=16, base_rate=2.0, burst_factor=8.0,
                             max_tokens=(24, 48), greedy_fraction=0.5)),
    ("diurnal_trace", dict(n=300, period_s=30.0, cycles=1.5)),
    ("flash_crowd_trace", dict(n=200, crowd_at=10.0,
                               crowd_duration=4.0)),
]


@pytest.mark.parametrize("fn,kw", TRACES,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(TRACES)])
def test_traces_and_transforms_equal_the_reference(fn, kw, tmp_path):
    for seed in (0, 7, 11):
        mine = getattr(trace, fn)(seed, **kw)
        theirs = getattr(ref_trace, fn)(seed, **kw)
        assert _rows(mine) == _rows(theirs)
        for f in (0.5, 3.0):
            assert _rows(trace.compress(mine, f)) == _rows(
                ref_trace.compress(theirs, f))
        for k in (1, 3):
            assert _rows(trace.amplify_bursts(mine, k, seed=seed)) == \
                _rows(ref_trace.amplify_bursts(theirs, k, seed=seed))
        assert [r.prompt_text(seed) for r in mine[:10]] == \
            [r.prompt_text(seed) for r in theirs[:10]]
        path = tmp_path / f"{fn}-{seed}.jsonl"
        trace.save_trace(mine, path)
        assert _rows(trace.load_trace(path)) == _rows(
            ref_trace.load_trace(path)) == _rows(mine)
    merged = trace.merge_traces(trace.diurnal_trace(1, n=50),
                                trace.flash_crowd_trace(2, n=50))
    assert _rows(merged) == _rows(ref_trace.merge_traces(
        ref_trace.diurnal_trace(1, n=50),
        ref_trace.flash_crowd_trace(2, n=50)))
    with pytest.raises(ValueError):
        trace.compress(merged, 0)
    with pytest.raises(ValueError):
        trace.amplify_bursts(merged, 0)


def test_load_reqlog_reads_the_ports_request_log(tmp_path):
    """A request log the port's RequestLog wrote (schema v2, admit
    times) loads into the same trace through both packages, in
    admission order."""
    path = tmp_path / "engine.reqlog"
    log = RequestLog(str(path))
    for i in range(8):
        log.write({"component": "engine", "admit_ts": 50.0 + 0.5 * (7 - i),
                   "admit_mono": 9.0, "prompt_tokens": 3 + i,
                   "output_tokens": i, "temperature": 0.7 * (i % 2),
                   "trace_id": f"r{i}", "class": "batch"})
    log.write({"component": "router", "ts": 1.0})
    log.close()
    mine = trace.load_reqlog(path)
    assert len(mine) == 8 and mine[0].trace_id == "r7"
    assert _rows(mine) == _rows(ref_trace.load_reqlog(path))


POLICIES = [
    dict(min_size=1, max_size=3, up_stable_ticks=2, down_stable_ticks=3,
         cooldown_ticks=2, down_threshold=0.3),
    dict(),
    dict(min_size=0, max_size=5, step=2, up_threshold=1.5,
         down_threshold=0.2, cooldown_ticks=0, down_stable_ticks=1),
]


@pytest.mark.parametrize("cfg", POLICIES)
def test_policy_decisions_equal_the_reference(cfg):
    rng = np.random.default_rng(5)
    series = list(rng.choice([0.0, 0.1, 0.4, 0.6, 1.0, 2.0, 5.0],
                             size=400))
    series = [2.0] * 6 + [0.1] * 10 + [float(x) for x in series]
    clock = iter(range(10_000)).__next__
    clock2 = iter(range(10_000)).__next__
    mine = policy.PoolPolicy(policy.PolicyConfig(**cfg), clock=clock)
    theirs = ref_policy.PoolPolicy(ref_policy.PolicyConfig(**cfg),
                                   clock=clock2)
    a = b = 1
    for p in series:
        a, b = mine.decide(a, p), theirs.decide(b, p)
        assert a == b
        assert mine.last_action_at == theirs.last_action_at
    for bad in (dict(min_size=2, max_size=1), dict(down_threshold=1.5),
                dict(up_stable_ticks=0)):
        with pytest.raises(ValueError):
            policy.PolicyConfig(**bad).validate()


class _FakePool:
    """EnginePool stand-in: counters, no subprocesses."""

    def __init__(self, size=1, fail_spawn=False):
        self._size = size
        self.fail_spawn = fail_spawn
        self.spawned = self.drained = 0

    def size(self):
        return self._size

    def member_urls(self):
        return [f"http://fake:{i}" for i in range(self._size)]

    def draining_count(self):
        return 0

    def engine_seconds(self):
        return float(self._size)

    def spawn(self):
        if self.fail_spawn:
            raise RuntimeError("no capacity")
        self._size += 1
        self.spawned += 1

    def drain_one(self):
        if self._size == 0:
            return None
        self._size -= 1
        self.drained += 1
        return "victim"


def _scripted_fetch(script):
    """Per-tick scrape script; the ":0" member advances the tick. A
    None entry fails the scrape; histograms come as cumulative
    buckets so the windows difference them."""
    state = {"tick": -1, "cum": 0.0}

    def fetch(url):
        if url.endswith(":0"):
            state["tick"] += 1
            state["cum"] += 1.0
        i = min(max(state["tick"], 0), len(script) - 1)
        depth = script[i]
        if depth is None:
            raise OSError("scrape down")
        c = state["cum"] * (1 + depth)
        return {
            "ome_engine_queue_depth": float(depth),
            "ome_engine_kv_block_utilization_ratio": 0.1 * (depth % 4),
            'ome_engine_ttft_seconds_bucket{le="0.5"}': c,
            'ome_engine_ttft_seconds_bucket{le="2.0"}': 2 * c + depth,
            'ome_engine_ttft_seconds_bucket{le="+Inf"}': 2 * c + 2 * depth,
            'ome_engine_class_queue_wait_seconds_bucket{class='
            '"interactive",le="1.0"}': c,
            'ome_engine_class_queue_wait_seconds_bucket{class='
            '"interactive",le="+Inf"}': c + depth,
        }
    return fetch


SCRIPTS = [
    [8, 8, 8, 0, 0, 0, 0, 0, 0, 0],
    [1, 6, 7, 9, 9, 2, 1, 0, 0, 0, 0, 0, 0, 0],
    [None, None, 3, None, 5, 5, 0, 0],
    [9] * 5,
]


@pytest.mark.parametrize("script", SCRIPTS)
@pytest.mark.parametrize("fail_spawn", [False, True])
def test_controller_decisions_equal_the_reference(script, fail_spawn):
    def run(mod, pol_mod):
        pool = _FakePool(fail_spawn=fail_spawn)
        pol = pol_mod.PoolPolicy(pol_mod.PolicyConfig(
            min_size=1, max_size=3, up_stable_ticks=2,
            down_stable_ticks=3, cooldown_ticks=2, down_threshold=0.3))
        slo = mod.SLOConfig(ttft_p99_s=1.0, queue_wait_p99_s=1.0,
                            kv_util_high=0.9, queue_depth_high=2.0)
        ticks = iter(range(1000)).__next__
        c = mod.ScaleController({"engine": pool}, {"engine": pol}, slo,
                                fetch_fn=_scripted_fetch(script),
                                clock=lambda: float(ticks()))
        for _ in range(len(script)):
            c.tick()
        reg = c.registry
        counts = (reg.get("ome_autoscale_ticks_total"),
                  reg.get("ome_autoscale_scrape_errors_total"),
                  reg.get("ome_autoscale_scale_ups_total", pool="engine"),
                  reg.get("ome_autoscale_scale_downs_total",
                          pool="engine"),
                  reg.get("ome_autoscale_pool_size", pool="engine"))
        return ([d.to_dict() for d in c.decisions], counts,
                (pool.spawned, pool.drained))
    mine, theirs = run(ctl, policy), run(ref_ctl, ref_policy)
    assert mine == theirs
    assert any(d["pressure"] > 0 for d in mine[0]) or None in script


def _results(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        ok = rng.random() > 0.15
        n = int(rng.integers(0, 30))
        out.append(mod.ReplayResult(
            trace_id=f"t{i}", arrival=0.1 * i, prompt="abc",
            max_tokens=n + 1, temperature=0.0,
            priority=[None, "interactive", "batch", "standard"][i % 4],
            status=200 if ok else int(rng.choice([429, 500, 503])),
            ttft_s=float(rng.uniform(0.01, 3.0)) if ok else None,
            tpot_s=float(rng.uniform(0.005, 0.2)) if ok and n > 1
            else None,
            e2e_s=float(rng.uniform(0.1, 6.0)),
            output_tokens=n if ok else 0,
            error=None if ok or i % 3 else "HTTPError",
            failovers=int(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_report_and_slo_section_equal_the_reference(seed):
    mine, theirs = _results(replay, seed), _results(ref_replay, seed)
    for kw in ({}, {"slo_ttft_s": 0.5}, {"slo_ttft_s": 1.0,
                                         "slo_e2e_s": 3.0}):
        assert replay.report(mine, **kw) == ref_replay.report(theirs, **kw)
    spec, ref_spec = load_slo("config/slo.json"), ref_load_slo(
        "config/slo.json")
    got = replay.slo_section(mine, spec)
    assert got == ref_replay.slo_section(theirs, ref_spec)
    assert json.dumps(got)  # JSON-serializable, as the CLI prints it
    assert replay.report([]) == ref_replay.report([])
