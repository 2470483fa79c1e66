"""SLO-aware scaling controller: scrape -> pressure -> policy -> act.

Port of ome_tpu/autoscale/controller.py: the same scrape script and
fake pools give the same decisions as the reference's. The closed
loop (``run_closed_loop``) runs the port's router and engines, the
engines on ``--device`` (default cuda).

Each tick the controller scrapes every pool member's /metrics (and
the router's guarded GET /backends for membership truth), reduces the
signals to one PRESSURE number per pool —

    max( ttft_p99        / slo.ttft_p99_s,        (windowed)
         queue_wait_p99  / slo.queue_wait_p99_s,  (windowed)
         kv_utilization  / slo.kv_util_high,      (instantaneous)
         queue_depth     / slo.queue_depth_high ) (instantaneous)

— and feeds it to the pool's tick-based hysteresis policy
(policy.py). The windowed quantiles come from differencing cumulative
histogram buckets between scrapes (scrape.HistogramWindow), so the
controller reacts to RECENT latency, not the since-boot average; the
instantaneous gauges keep the signal meaningful when a window holds
zero observations (an idle pool must still scale down).

Actions go through pool.py: scale-up spawns + registers, scale-down
SIGTERM-drains via the journal'd zero-loss path. Every decision lands
in a bounded in-memory log (and the registry) — the run-to-run
determinism test replays a seeded trace twice and asserts the two
decision sequences are identical.

The CLI (``python -m ome_tpu_torch.autoscale.controller``) runs the
whole closed loop on one machine: router + engine pool subprocesses, a
replayed trace, the controller, and a final JSON report with SLO
attainment, engine-seconds vs static max-provisioning, each spawn's
decision-to-registered seconds and the replay's TPOT p99.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys
import threading
import time
import urllib.error
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..chaos import ChaosError
from ..priority import PRIORITY_CLASSES, highest_class
from ..telemetry import Registry
from . import scrape
from .policy import PolicyConfig, PoolPolicy

log = logging.getLogger("ome.autoscale")


@dataclass
class SLOConfig:
    """The objectives pressure is normalized against. 1.0 pressure ==
    "exactly at objective"; the policy's up_threshold is in these
    units.

    ``priority_class`` keys the latency windows to ONE tenant class
    (default: the highest, interactive) — under a noisy-neighbor
    flood, scaling must react to the latency of the traffic the SLO
    protects, not the since-boot average the batch flood dominates.
    The global histograms stay as fallback when the class window has
    no observations."""

    ttft_p99_s: float = 2.0
    queue_wait_p99_s: float = 1.0
    kv_util_high: float = 0.9
    queue_depth_high: float = 4.0
    priority_class: str = highest_class()
    # error-budget burn rate that normalizes to 1.0 pressure; only
    # consulted when the controller was built with a burn_fn (the
    # fleet SLO rollup's max_burn; docs/slo.md)
    burn_high: Optional[float] = None


@dataclass
class Decision:
    tick: int
    pool: str
    size: int
    pressure: float
    target: int
    signals: Dict[str, float] = field(default_factory=dict)
    # injected-clock reading at decision time (virtual seconds under
    # the simulator, monotonic seconds live); None from legacy paths
    at: Optional[float] = None

    def to_dict(self) -> dict:
        out = {"tick": self.tick, "pool": self.pool,
               "size": self.size, "pressure": self.pressure,
               "target": self.target, "signals": self.signals}
        if self.at is not None:
            out["at"] = self.at
        return out


class ScaleController:
    """Drives one or more EnginePools from scraped metrics.

    Dependency injection keeps the decision path unit-testable with
    no subprocesses: ``fetch_fn(url) -> samples`` replaces the HTTP
    scrape, and anything exposing size()/member_urls()/spawn()/
    drain_one()/draining_count() can stand in for an EnginePool.
    """

    MAX_DECISIONS = 4096

    def __init__(self, pools: Dict[str, object],
                 policies: Dict[str, PoolPolicy], slo: SLOConfig,
                 router_url: Optional[str] = None,
                 registry: Optional[Registry] = None,
                 fetch_fn=scrape.fetch_metrics,
                 burn_fn=None,
                 interval: float = 1.0,
                 clock=None):
        self.pools = pools
        self.policies = policies
        self.slo = slo
        self.router_url = router_url.rstrip("/") if router_url else None
        self.fetch_fn = fetch_fn
        # optional SLO pressure input: burn_fn() -> current worst
        # error-budget burn rate (FleetRollup.max_burn); normalized
        # against slo.burn_high when both are set
        self.burn_fn = burn_fn
        self.interval = interval
        # the ONE clock the decision path reads, injected end to end:
        # decision stamps, histogram-window staleness, and the
        # policies' last_action_at all see the same time source. The
        # default is deliberately None — NOT wall time — so the
        # decision path stays tick-deterministic unless a caller
        # opts into timestamps (the CLI passes time.monotonic, the
        # simulator its VirtualClock).
        self.clock = clock
        if clock is not None:
            for policy in policies.values():
                if policy.clock is None:
                    policy.clock = clock
        self.registry = registry or Registry()
        self.decisions: List[Decision] = []
        self.tick_count = 0
        cls_filter = ({"class": slo.priority_class}
                      if getattr(slo, "priority_class", None) else None)
        self._windows: Dict[str, Dict[str, scrape.HistogramWindow]] = {
            name: {"ttft": scrape.HistogramWindow(
                       "ome_engine_ttft_seconds", clock=clock),
                   "queue_wait": scrape.HistogramWindow(
                       "ome_engine_queue_wait_seconds", clock=clock),
                   # per-class windows answer first; the global pair
                   # is the fallback when the class saw no traffic
                   "class_ttft": scrape.HistogramWindow(
                       "ome_engine_class_ttft_seconds",
                       labels=cls_filter, clock=clock),
                   "class_queue_wait": scrape.HistogramWindow(
                       "ome_engine_class_queue_wait_seconds",
                       labels=cls_filter, clock=clock)}
            for name in pools}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        r = self.registry
        self._c_ticks = r.counter(
            "ome_autoscale_ticks_total",
            "Controller scrape/decide/act iterations")
        self._c_ups = r.counter(
            "ome_autoscale_scale_ups_total",
            "Engines spawned by scale-up decisions",
            labelnames=("pool",))
        self._c_downs = r.counter(
            "ome_autoscale_scale_downs_total",
            "Engines drained by scale-down decisions",
            labelnames=("pool",))
        self._c_scrape_errors = r.counter(
            "ome_autoscale_scrape_errors_total",
            "Backend /metrics scrapes that failed")
        self._g_size = r.gauge(
            "ome_autoscale_pool_size",
            "Serving engines in the pool (draining excluded)",
            labelnames=("pool",))
        self._g_pressure = r.gauge(
            "ome_autoscale_pool_pressure",
            "Latest pressure signal (1.0 = at SLO objective)",
            labelnames=("pool",))
        self._g_engine_seconds = r.gauge(
            "ome_autoscale_engine_seconds",
            "Cumulative engine lifetime consumed by the pool",
            labelnames=("pool",))

    # -- observation --------------------------------------------------

    def router_backends(self) -> Optional[List[dict]]:
        """GET /backends (requires the router's --debug-endpoints);
        None when unavailable — membership then comes from the pools
        alone."""
        if self.router_url is None:
            return None
        try:
            status, body = scrape._http(
                self.router_url + "/backends", timeout=5.0)
        except (urllib.error.URLError, OSError):
            return None
        if status != 200 or not isinstance(body, dict):
            return None
        return body.get("backends")

    def _pool_signals(self, name: str, pool) -> Dict[str, float]:
        windows = self._windows[name]
        kv_utils: List[float] = []
        depths: List[float] = []
        urls = pool.member_urls()
        for url in urls:
            try:
                samples = self.fetch_fn(url)
            except (urllib.error.URLError, OSError, ValueError):
                self._c_scrape_errors.inc()
                for w in windows.values():
                    w.forget(url)
                continue
            for w in windows.values():
                w.update(url, samples)
            kv = samples.get("ome_engine_kv_block_utilization_ratio")
            if kv is not None:
                kv_utils.append(kv)
            depth = samples.get("ome_engine_queue_depth")
            if depth is not None:
                depths.append(depth)
        signals: Dict[str, float] = {}
        ttft = windows["class_ttft"].quantile(0.99)
        if ttft is None:
            ttft = windows["ttft"].quantile(0.99)
        if ttft is not None:
            signals["ttft_p99"] = round(ttft, 4)
        qw = windows["class_queue_wait"].quantile(0.99)
        if qw is None:
            qw = windows["queue_wait"].quantile(0.99)
        if qw is not None:
            signals["queue_wait_p99"] = round(qw, 4)
        if kv_utils:
            signals["kv_util"] = round(max(kv_utils), 4)
        if depths:
            signals["queue_depth"] = round(max(depths), 4)
        if self.burn_fn is not None \
                and self.slo.burn_high is not None:
            signals["burn_rate"] = round(self.burn_fn(), 4)
        return signals

    def _pressure(self, signals: Dict[str, float]) -> float:
        slo = self.slo
        parts = []
        if "ttft_p99" in signals:
            parts.append(signals["ttft_p99"] / slo.ttft_p99_s)
        if "queue_wait_p99" in signals:
            parts.append(signals["queue_wait_p99"]
                         / slo.queue_wait_p99_s)
        if "kv_util" in signals:
            parts.append(signals["kv_util"] / slo.kv_util_high)
        if "queue_depth" in signals:
            parts.append(signals["queue_depth"]
                         / slo.queue_depth_high)
        if "burn_rate" in signals and slo.burn_high:
            parts.append(signals["burn_rate"] / slo.burn_high)
        return max(parts) if parts else 0.0

    # -- the tick -----------------------------------------------------

    def tick(self) -> List[Decision]:
        self.tick_count += 1
        self._c_ticks.inc()
        made: List[Decision] = []
        for name, pool in self.pools.items():
            signals = self._pool_signals(name, pool)
            pressure = round(self._pressure(signals), 4)
            size = pool.size()
            target = self.policies[name].decide(size, pressure)
            decision = Decision(tick=self.tick_count, pool=name,
                                size=size, pressure=pressure,
                                target=target, signals=signals,
                                at=(round(self.clock(), 6)
                                    if self.clock is not None
                                    else None))
            made.append(decision)
            if len(self.decisions) < self.MAX_DECISIONS:
                self.decisions.append(decision)
            self._g_pressure.labels(pool=name).set(pressure)
            if target > size:
                for _ in range(target - size):
                    try:
                        pool.spawn()
                        self._c_ups.labels(pool=name).inc()
                    except Exception as e:  # noqa: BLE001 — a failed
                        # spawn must not kill the loop; pressure stays
                        # high and the next tick retries
                        log.warning("pool %s: spawn failed: %s",
                                    name, e)
                        break
            elif target < size:
                for _ in range(size - target):
                    if pool.drain_one() is None:
                        break
                    self._c_downs.labels(pool=name).inc()
            self._g_size.labels(pool=name).set(pool.size())
            es = getattr(pool, "engine_seconds", None)
            if callable(es):
                self._g_engine_seconds.labels(pool=name).set(
                    round(es(), 3))
        return made

    # -- the loop -----------------------------------------------------

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                log.exception("autoscale tick failed")

    def start(self) -> "ScaleController":
        self._thread = threading.Thread(target=self.run,
                                        name="autoscale-controller",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def report(self) -> dict:
        return {"ticks": self.tick_count,
                "decisions": [d.to_dict() for d in self.decisions],
                "metrics": {k: v for k, v in
                            self.registry.snapshot().items()}}


# -- closed-loop CLI -------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="autoscale",
        description="Closed-loop autoscaling demo: spawns a router + "
                    "engine pool, replays a (synthetic or reqlog) "
                    "trace through it, and scales the pool against "
                    "its SLOs (docs/autoscaling.md). Engines run as "
                    "subprocesses via the chaos harness re-entry, on "
                    "--device.")
    p.add_argument("--trace", default=None,
                   help="trace file (save_trace JSONL) or engine "
                        "reqlog to replay; default: a synthetic "
                        "bursty trace from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=40,
                   help="synthetic trace length")
    p.add_argument("--base-rate", type=float, default=3.0,
                   help="synthetic arrivals/s outside the burst")
    p.add_argument("--burst-factor", type=float, default=5.0)
    p.add_argument("--compress", type=float, default=1.0,
                   help="time-compression factor (>1 replays faster)")
    p.add_argument("--amplify", type=int, default=1,
                   help="burst amplification factor (duplicates "
                        "requests in the busiest window)")
    p.add_argument("--min-engines", type=int, default=1)
    p.add_argument("--max-engines", type=int, default=3)
    p.add_argument("--interval", type=float, default=0.5,
                   help="controller tick seconds")
    p.add_argument("--slo-ttft-p99", type=float, default=2.0)
    p.add_argument("--slo-queue-wait-p99", type=float, default=1.0)
    p.add_argument("--slo-class", default=highest_class(),
                   choices=list(PRIORITY_CLASSES),
                   help="priority class the latency SLO windows key "
                        "to (default: the highest class); the global "
                        "histograms are the fallback when that class "
                        "saw no traffic in a window")
    p.add_argument("--queue-depth-high", type=float, default=3.0)
    p.add_argument("--up-stable-ticks", type=int, default=2)
    p.add_argument("--down-stable-ticks", type=int, default=6)
    p.add_argument("--cooldown-ticks", type=int, default=4)
    p.add_argument("--down-threshold", type=float, default=0.3)
    p.add_argument("--model-dir", default=None,
                   help="model directory (default: empty dir + "
                        "--random-weights = deterministic tiny_test)")
    p.add_argument("--max-slots", type=int, default=2)
    p.add_argument("--kv-block", type=int, default=16)
    p.add_argument("--kv-blocks", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="device of every engine (cuda, cuda:N or cpu); "
                        "an engine that cannot start there fails the "
                        "run. On a CUDA device --kv-block must be a "
                        "multiple of 32, else refused before any spawn")
    p.add_argument("--drain-grace", type=float, default=4.0)
    p.add_argument("--base-dir", default=None,
                   help="scratch dir for logs/journals (default: "
                        "fresh temp dir, deleted on success)")
    p.add_argument("--settle-seconds", type=float, default=8.0,
                   help="keep ticking after the replay finishes so "
                        "scale-down can be observed: until the pool is "
                        "back at --min-engines with its drains done, "
                        "at most this long")
    p.add_argument("--json", action="store_true",
                   help="print the report as one JSON line only")
    return p


def run_closed_loop(args) -> dict:
    """The CLI body, importable for the soak test: builds topology,
    replays, scales, and returns the report dict."""
    from .pool import EnginePool
    from . import replay as replay_mod
    from . import trace as trace_mod
    from ..chaos import ManagedProc, free_port, refuse_kv_block

    base = pathlib.Path(args.base_dir)
    base.mkdir(parents=True, exist_ok=True)
    model_dir = args.model_dir
    if model_dir is None:
        model_dir = str(base / "model")
        pathlib.Path(model_dir).mkdir(parents=True, exist_ok=True)
    device = getattr(args, "device", "cuda")
    refuse_kv_block(args.kv_block, device, model_dir)

    if args.trace:
        path = pathlib.Path(args.trace)
        try:
            tr = trace_mod.load_trace(path)
        except (KeyError, ValueError):
            tr = trace_mod.load_reqlog(path)
    else:
        tr = trace_mod.synthetic_trace(
            args.seed, n=args.requests, base_rate=args.base_rate,
            burst_factor=args.burst_factor)
    if args.amplify > 1:
        tr = trace_mod.amplify_bursts(tr, args.amplify, seed=args.seed)
    if args.compress != 1.0:
        tr = trace_mod.compress(tr, args.compress)
    if not tr:
        raise SystemExit("empty trace")

    def engine_args(port: int, name: str,
                    journal_dir: pathlib.Path) -> List[str]:
        return ["--model-dir", model_dir, "--random-weights",
                "--dtype", "float32", "--host", "127.0.0.1",
                "--port", str(port),
                "--max-slots", str(args.max_slots),
                "--kv-block", str(args.kv_block),
                "--kv-blocks", str(args.kv_blocks),
                "--prefix-cache-mb", "8",
                "--drain-grace", str(args.drain_grace),
                "--journal", str(journal_dir),
                "--journal-fsync", "always",
                "--request-log", str(base / f"{name}.reqlog")]

    pool = EnginePool("engine", None, engine_args, base,
                      drain_exit_timeout=args.drain_grace + 30.0,
                      device=device)
    router: Optional[ManagedProc] = None
    controller: Optional[ScaleController] = None
    try:
        for _ in range(args.min_engines):
            pool.spawn()
        rport = free_port()
        rargs = ["--bind", "127.0.0.1", "--port", str(rport),
                 "--policy", "round_robin",
                 "--health-interval", "0.5", "--debug-endpoints"]
        for url in pool.member_urls():
            rargs += ["--backend", url]
        router = ManagedProc("router", "router", rargs, rport,
                             base / "router.log")
        router.start()
        router.wait_ready()
        pool.router_url = router.url  # later spawns self-register

        slo = SLOConfig(ttft_p99_s=args.slo_ttft_p99,
                        queue_wait_p99_s=args.slo_queue_wait_p99,
                        queue_depth_high=args.queue_depth_high,
                        priority_class=args.slo_class)
        policy = PoolPolicy(PolicyConfig(
            min_size=args.min_engines, max_size=args.max_engines,
            up_stable_ticks=args.up_stable_ticks,
            down_stable_ticks=args.down_stable_ticks,
            cooldown_ticks=args.cooldown_ticks,
            down_threshold=args.down_threshold))
        controller = ScaleController(
            {"engine": pool}, {"engine": policy}, slo,
            router_url=router.url, interval=args.interval,
            clock=time.monotonic).start()

        results = replay_mod.replay(router.url, tr)
        # keep ticking so that the scale-down can be observed: until the
        # pool is back at --min-engines with its drains done, at most
        # --settle-seconds
        settle_start = time.monotonic()
        while time.monotonic() - settle_start < args.settle_seconds:
            if (any(d.target < d.size for d in controller.decisions)
                    and pool.draining_count() == 0
                    and pool.size() == args.min_engines):
                break
            time.sleep(0.5)
        settled = time.monotonic() - settle_start
        controller.stop()
        pool.join_drains()

        rep = replay_mod.report(
            results, slo_ttft_s=args.slo_ttft_p99)
        rep["tpot_p99_s"] = replay_mod._pct(
            [r.tpot_s for r in results
             if r.ok and r.tpot_s is not None], 99)
        # the engines' own view, from their request logs: the client's
        # TTFT/TPOT read SSE text deltas, and a token that decodes to
        # no text (most of a large vocabulary under the byte-level
        # tokenizer) streams none
        rep.update(_engine_latency(base))
        rep["trace_requests"] = len(tr)
        rep["engine_seconds"] = round(pool.engine_seconds(), 3)
        wall = max(r.arrival for r in tr) + settled
        rep["static_max_engine_seconds"] = round(
            args.max_engines * wall, 3)
        rep["decisions"] = [d.to_dict()
                            for d in controller.decisions]
        rep["drains"] = [vars(d) for d in pool.drains]
        # each scale-up's decision (the tick that chose it, on the
        # controller's clock) to the router registering the engine
        ups = [d for d in controller.decisions if d.target > d.size]
        rep["spawns"] = [dict(s) for s in pool.spawns]
        for s, d in zip(rep["spawns"][args.min_engines:], ups):
            s["decided"] = d.at
            s["decision_to_registered_s"] = round(
                s["registered"] - d.at, 6)
        from ..chaos import journal_live_entries
        rep["journal_leftover"] = sum(
            len(journal_live_entries(p)) for p in pool.journals())
        return rep
    finally:
        if controller is not None:
            controller.stop()
        pool.stop_all()
        if router is not None:
            router.stop()


def _engine_latency(base: pathlib.Path) -> dict:
    """TTFT/TPOT p50/p99 over every finished request the pool's engines
    logged (``<base>/<engine>.reqlog``), drained engines included."""
    from . import replay as replay_mod
    ttft, tpot = [], []
    for path in sorted(base.glob("*.reqlog")):
        for line in path.read_text(encoding="utf-8",
                                   errors="replace").splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("finish_reason") not in ("stop", "length"):
                continue
            if rec.get("ttft_s") is not None:
                ttft.append(rec["ttft_s"])
            if rec.get("tpot_s") is not None:
                tpot.append(rec["tpot_s"])
    return {"engine_requests": len(ttft),
            "engine_ttft_p50_s": replay_mod._pct(ttft, 50),
            "engine_ttft_p99_s": replay_mod._pct(ttft, 99),
            "engine_tpot_p50_s": replay_mod._pct(tpot, 50),
            "engine_tpot_p99_s": replay_mod._pct(tpot, 99)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cleanup = False
    if args.base_dir is None:
        import tempfile
        args.base_dir = tempfile.mkdtemp(prefix="ome-autoscale-")
        cleanup = True
    try:
        rep = run_closed_loop(args)
    except ChaosError as e:
        raise SystemExit(str(e))
    finally:
        if cleanup:
            import shutil
            shutil.rmtree(args.base_dir, ignore_errors=True)
    line = json.dumps(rep if args.json else {
        k: v for k, v in rep.items() if k != "decisions"},
        separators=(",", ":"), default=str)
    print(line)
    sys.stdout.flush()
    ok = (rep["journal_leftover"] == 0
          and rep["errors"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
