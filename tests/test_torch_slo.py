"""The port's fleet SLO rollup (`ome_tpu_torch/slo/`, with
`autoscale/scrape.py`) against the reference's (`ome_tpu/slo/`,
`ome_tpu/autoscale/scrape.py`).

The same spec file and the same seeded scraped samples go through both:
two engines whose per-class TTFT / e2e / queue-wait histograms and
global TPOT histogram are observed from a seeded generator (slow in the
middle ticks, so that alerts fire and clear), one of them failing a
scrape and later leaving the fleet, and the router's own per-class
outcome counters. Each side parses the exposition text with its own
parser and reads it through its own `SharedScraper`. After every tick
the reports (burn rates, attainment, budgets, alert states and events)
are equal, and at the end the `ome_slo_*` metric lines are equal.

Last, `python -m ome_tpu_torch.router --slo-spec` serves the rollup at
`GET /slo`.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from ome_tpu.autoscale import scrape as ref_scrape
from ome_tpu import slo as ref_slo
from ome_tpu.slo import rollup as ref_rollup
from ome_tpu.telemetry import Registry as RefRegistry
from ome_tpu_torch import slo as port_slo
from ome_tpu_torch.autoscale import scrape as port_scrape
from ome_tpu_torch.slo import rollup as port_rollup
from ome_tpu_torch.telemetry import Registry as PortRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("interactive", "standard", "batch")
SPEC = {
    "schema_version": 1,
    "compliance_window_s": 600,
    "windows": {"page": {"long_s": 60, "short_s": 5, "burn_factor": 6.0},
                "warn": {"long_s": 240, "short_s": 30,
                         "burn_factor": 2.0}},
    "classes": {
        "interactive": {"objectives": [
            {"name": "ttft", "kind": "latency", "threshold_s": 0.5,
             "target": 0.9},
            {"name": "tpot", "kind": "latency", "threshold_s": 0.05,
             "target": 0.9},
            {"name": "availability", "kind": "availability",
             "target": 0.95}]},
        "standard": {"objectives": [
            {"name": "e2e", "kind": "latency", "threshold_s": 10.0,
             "target": 0.9},
            {"name": "queue_wait", "kind": "latency", "threshold_s": 1.0,
             "target": 0.8},
            {"name": "availability", "kind": "availability",
             "target": 0.9}]},
        "batch": {"objectives": [
            {"name": "availability", "kind": "availability",
             "target": 0.8}]}},
}


@pytest.fixture()
def spec_path(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text(json.dumps(SPEC))
    return str(p)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine_texts(seed, ticks):
    """Per tick, each engine's /metrics text (cumulative histograms from
    seeded observations; slow in ticks 6-19)."""
    rng = random.Random(seed)
    out = []
    regs = {}
    for url in ("http://e1", "http://e2"):
        reg = PortRegistry()
        regs[url] = (reg, {
            name: reg.histogram(f"ome_engine_class_{name}_seconds",
                                labelnames=("class",))
            for name in ("ttft", "e2e", "queue_wait")},
            reg.histogram("ome_engine_tpot_seconds"))
    for tick in range(ticks):
        slow = 6 <= tick < 20
        texts = {}
        for url, (reg, per_class, tpot) in regs.items():
            for _ in range(rng.randint(5, 25)):
                cls = rng.choice(CLASSES)
                base = 3.0 if slow and rng.random() < 0.9 else 0.2
                per_class["ttft"].labels(**{"class": cls}).observe(
                    rng.expovariate(1.0 / base))
                per_class["e2e"].labels(**{"class": cls}).observe(
                    rng.expovariate(1.0 / (base * 8)))
                per_class["queue_wait"].labels(**{"class": cls}).observe(
                    rng.expovariate(1.0 / base))
                tpot.observe(rng.expovariate(1.0 / (0.2 if slow
                                                    else 0.02)))
            texts[url] = reg.render()
        out.append(texts)
    return out


def _outcomes(seed, ticks):
    rng = random.Random(seed + 1)
    return [[(rng.choice(CLASSES), rng.random() < (0.5 if 10 <= t < 14
                                                   else 0.98))
             for _ in range(rng.randint(10, 40))] for t in range(ticks)]


def _run(side, spec_path, seed, ticks=30):
    slo, scrape, rollup_mod, Registry = {
        "reference": (ref_slo, ref_scrape, ref_rollup, RefRegistry),
        "port": (port_slo, port_scrape, port_rollup, PortRegistry)}[side]
    texts = _engine_texts(seed, ticks)
    outcomes = _outcomes(seed, ticks)
    clock = _Clock()
    reg = Registry()
    fam = reg.counter(rollup_mod.OUTCOME_FAMILY, "outcomes",
                      labelnames=("class", "result"))
    state = {"tick": 0, "backends": ["http://e1", "http://e2"]}

    def fetch(url):
        t = state["tick"]
        if url == "http://e2" and t in (5, 6):
            raise OSError("scrape failed")
        return scrape.parse_exposition(texts[t][url])

    scraper = scrape.SharedScraper(fetch_fn=fetch, clock=clock,
                                   max_age=0.0)
    roll = rollup_mod.FleetRollup(
        slo.load(spec_path), clock=clock, fetch_fn=scraper.fetch,
        backends_fn=lambda: [{"url": u} for u in state["backends"]],
        registry=reg, local_samples_fn=reg.snapshot)
    reports = []
    for t in range(ticks):
        state["tick"] = t
        if t == 22:
            state["backends"] = ["http://e1"]   # e2 leaves the fleet
        for cls, ok in outcomes[t]:
            fam.labels(**{"class": cls,
                          "result": "ok" if ok else "error"}).inc()
        clock.t += 5.0
        roll.tick()
        reports.append(json.dumps(roll.report(), sort_keys=True))
    slo_lines = [ln for ln in reg.render().splitlines()
                 if "ome_slo_" in ln]
    return reports, slo_lines, roll.max_burn(), scraper.fetches


@pytest.mark.parametrize("seed", [0, 1])
def test_rollup_equal_to_the_reference(spec_path, seed):
    want = _run("reference", spec_path, seed)
    got = _run("port", spec_path, seed)
    for t, (w, g) in enumerate(zip(want[0], got[0])):
        assert g == w, t
    assert got[1:] == want[1:]
    last = json.loads(got[0][-1])
    severities = {a["severity"] for a in last["alerts"]}
    assert severities == {"warn", "page"}      # alerts fired
    assert last["scrape_errors"] == 2
    assert got[2] > 1.0
    assert any("ome_slo_burn_rate" in ln for ln in got[1])


def test_spec_load_and_refusals_equal(spec_path, tmp_path):
    assert port_slo.load(spec_path).to_doc() == \
        ref_slo.load(spec_path).to_doc()
    for bad in ({**SPEC, "schema_version": 2},
                {**SPEC, "classes": {"vip": SPEC["classes"]["batch"]}},
                {**SPEC, "windows": {"page": SPEC["windows"]["warn"],
                                     "warn": SPEC["windows"]["page"]}}):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError) as want:
            ref_slo.load(str(p))
        with pytest.raises(ValueError) as got:
            port_slo.load(str(p))
        assert str(got.value) == str(want.value)


def test_exposition_parsing_equal():
    text = _engine_texts(3, 2)[1]["http://e1"]
    assert port_scrape.parse_exposition(text) == \
        ref_scrape.parse_exposition(text)
    samples = port_scrape.parse_exposition(text)
    fam = "ome_engine_class_ttft_seconds"
    for labels in (None, {"class": "batch"}):
        b = port_scrape.bucket_counts(samples, fam, labels)
        assert b == ref_scrape.bucket_counts(samples, fam, labels)
        for q in (0.5, 0.99):
            assert port_scrape.quantile_from_buckets(b, q) == \
                ref_scrape.quantile_from_buckets(b, q)
        assert port_scrape.count_le(b, 0.5) == ref_scrape.count_le(b, 0.5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_router_main_serves_the_rollup(spec_path):
    """`python -m ome_tpu_torch.router --slo-spec` starts the rollup
    loop and serves it at GET /slo (guarded by --debug-endpoints), with
    the ome_slo_* families on /metrics."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "ome_tpu_torch.router", "--backend",
         f"http://127.0.0.1:{_free_port()}", "--port", str(port),
         "--bind", "127.0.0.1", "--slo-spec", spec_path,
         "--slo-interval", "0.2", "--debug-endpoints"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        report = None
        deadline = time.time() + 90
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/slo", timeout=5) as r:
                    report = json.loads(r.read())
                if report.get("at") is not None:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert report is not None and report["at"] is not None, \
            proc.stderr.read1().decode() if proc.poll() is not None else ""
        assert report["spec"] == port_slo.load(spec_path).to_doc()
        assert report["scrape_errors"] >= 1      # the backend is down
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=5) as r:
            text = r.read().decode()
        assert "ome_slo_scrape_errors_total" in text
        assert "ome_slo_burn_rate" in text
    finally:
        proc.terminate()
        proc.wait(timeout=30)
