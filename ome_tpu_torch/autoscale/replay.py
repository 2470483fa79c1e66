"""Open-loop trace replay: the load half of the closed loop.

Port of ome_tpu/autoscale/replay.py: the same results give the same
`report` and `slo_section` (over the port's slo/). Its `--topology N`
mode spawns the port's engines on `--device` (default cuda).

Replays a trace (trace.py) against an endpoint with the ORIGINAL
inter-arrival gaps — open-loop, i.e. arrivals never wait for earlier
responses, so queueing delay shows up as queueing delay instead of
being absorbed by a closed-loop client (the coordinated-omission
trap). Each request runs on its own thread: sleep until its arrival
offset, POST /v1/completions with stream=true, and measure
CLIENT-SIDE TTFT (first SSE delta), TPOT, and e2e, collecting the
full text for greedy byte-comparison.

``report()`` folds the per-request results into percentiles and SLO
attainment — the JSON the bench `replay` subcommand and
``scripts/replay.py`` print, and the numbers the autoscale soak
judges the controller by.
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
import urllib.request
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from . import trace as trace_mod
from .trace import TraceRequest

log = logging.getLogger("ome.autoscale")


@dataclass
class ReplayResult:
    trace_id: Optional[str]
    arrival: float
    prompt: str
    max_tokens: int
    temperature: float
    priority: Optional[str] = None
    status: Optional[int] = None
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    output_tokens: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    # router fronts tried before a response arrived (HA failover)
    failovers: int = 0

    @property
    def ok(self) -> bool:
        return self.status == 200 and self.error is None


def _stream_one(urls, result: ReplayResult,
                timeout: float) -> None:
    """One request against an endpoint, or a list of router replicas
    tried in order: a transport failure BEFORE any response bytes
    (connection refused, reset — the front is dead) fails over to the
    next URL; once a status line has arrived the request is never
    retried, because retrying a request some router already answered
    is how a client manufactures duplicates (docs/router-ha.md)."""
    if isinstance(urls, str):
        urls = [urls]
    payload = {
        "prompt": result.prompt, "max_tokens": result.max_tokens,
        "temperature": result.temperature, "stream": True}
    headers = {"Content-Type": "application/json"}
    if result.priority:
        # class in BOTH forms: the payload survives router
        # passthrough, the header is what the engine prefers
        payload["priority"] = result.priority
        headers["X-OME-Priority"] = result.priority
    body = json.dumps(payload).encode()
    t0 = time.monotonic()
    first = last = None
    for attempt, url in enumerate(urls):
        req = urllib.request.Request(
            url + "/v1/completions", data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                result.status = resp.status
                for raw in resp:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line.startswith("data:"):
                        continue
                    data = line[5:].strip()
                    if data == "[DONE]":
                        break
                    try:
                        chunk = json.loads(data)
                    except ValueError:
                        continue
                    for choice in chunk.get("choices", []):
                        text = choice.get("text") or choice.get(
                            "delta", {}).get("content")
                        if text:
                            now = time.monotonic()
                            if first is None:
                                first = now
                            last = now
                            result.output_tokens += 1
                            result.text += text
                        fin = choice.get("finish_reason")
                        if fin:
                            result.finish_reason = fin
        except urllib.error.HTTPError as e:
            result.status = e.code
            result.error = e.read().decode("utf-8", "replace")[:200]
            e.close()
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            result.error = f"{type(e).__name__}: {e}"
            if result.status is None and attempt + 1 < len(urls):
                result.failovers += 1
                continue
        break
    end = time.monotonic()
    result.e2e_s = round(end - t0, 6)
    if first is not None:
        result.ttft_s = round(first - t0, 6)
        if result.output_tokens > 1 and last is not None:
            result.tpot_s = round(
                (last - first) / (result.output_tokens - 1), 6)


def replay(url, trace: Sequence[TraceRequest],
           timeout: float = 120.0, prompt_seed: int = 0,
           on_result: Optional[Callable[[ReplayResult], None]] = None
           ) -> List[ReplayResult]:
    """Replay ``trace`` against ``url`` (router or engine; a LIST of
    URLs spreads arrivals round-robin across N router replicas with
    client-side failover), honoring arrival offsets; blocks until
    every request has an outcome."""
    urls = [url] if isinstance(url, str) else list(url)
    urls = [u.rstrip("/") for u in urls]
    t0 = time.monotonic()
    results = [ReplayResult(trace_id=r.trace_id, arrival=r.arrival,
                            prompt=r.prompt_text(prompt_seed),
                            max_tokens=r.max_tokens,
                            temperature=r.temperature,
                            priority=getattr(r, "priority", None))
               for r in trace]

    def one(i: int, r: ReplayResult):
        delay = t0 + r.arrival - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        k = i % len(urls)
        _stream_one(urls[k:] + urls[:k], r, timeout)
        if on_result is not None:
            on_result(r)

    threads = [threading.Thread(target=one, args=(i, r), daemon=True)
               for i, r in enumerate(results)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 60.0)
    return results


def _pct(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return round(xs[i], 6)


def _stats(results: Sequence[ReplayResult], slo_ttft_s: float,
           slo_e2e_s: Optional[float]) -> dict:
    ok = [r for r in results if r.ok]
    ttfts = [r.ttft_s for r in ok if r.ttft_s is not None]
    tpots = [r.tpot_s for r in ok if r.tpot_s is not None]
    e2es = [r.e2e_s for r in ok if r.e2e_s is not None]
    ttft_ok = sum(1 for t in ttfts if t <= slo_ttft_s)
    out = {
        "requests": len(results),
        "completed": len(ok),
        "errors": len(results) - len(ok),
        "failovers": sum(r.failovers for r in results),
        "output_tokens": sum(r.output_tokens for r in ok),
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p95_s": _pct(ttfts, 95),
        "ttft_p99_s": _pct(ttfts, 99),
        "tpot_p50_s": _pct(tpots, 50),
        "e2e_p50_s": _pct(e2es, 50),
        "e2e_p99_s": _pct(e2es, 99),
        "slo_ttft_s": slo_ttft_s,
        "slo_ttft_attainment": (round(ttft_ok / len(ttfts), 4)
                                if ttfts else None),
    }
    if slo_e2e_s is not None:
        e2e_ok = sum(1 for t in e2es if t <= slo_e2e_s)
        out["slo_e2e_s"] = slo_e2e_s
        out["slo_e2e_attainment"] = (round(e2e_ok / len(e2es), 4)
                                     if e2es else None)
    return out


def report(results: Sequence[ReplayResult],
           slo_ttft_s: float = 2.0,
           slo_e2e_s: Optional[float] = None) -> dict:
    """Percentiles + SLO attainment over a replay's results. When any
    request carried a priority class, the report also breaks the same
    stats out per class under ``classes`` — the view that shows a
    batch flood hurting batch latency while interactive holds."""
    out = _stats(results, slo_ttft_s, slo_e2e_s)
    by_class: dict = {}
    for r in results:
        if r.priority is not None:
            by_class.setdefault(r.priority, []).append(r)
    if by_class:
        out["classes"] = {
            cls: _stats(rs, slo_ttft_s, slo_e2e_s)
            for cls, rs in sorted(by_class.items())}
    return out


def slo_section(results: Sequence[ReplayResult], spec) -> dict:
    """Client-observed SLO attainment against an ``SLOSpec`` — the
    replay half of the sim-vs-real parity contract (docs/slo.md):
    per-(class, objective) good/total counts that ``GET /slo`` on
    the router must match within +-1 request on a clean run.
    Latency objectives count completed requests (the population the
    engine histograms observe); availability counts every answered
    request as good unless it failed server-side (5xx, timeout,
    transport error, aborted stream)."""
    from ..priority import DEFAULT_PRIORITY
    by_class: dict = {}
    for r in results:
        by_class.setdefault(r.priority or DEFAULT_PRIORITY,
                            []).append(r)
    metric = {"ttft": lambda r: r.ttft_s,
              "e2e": lambda r: r.e2e_s,
              "tpot": lambda r: r.tpot_s}
    out: dict = {}
    for cls in sorted(spec.classes):
        rs = by_class.get(cls, [])
        cls_out: dict = {}
        for obj in spec.classes[cls]:
            if obj.kind == "availability":
                good = sum(
                    1 for r in rs
                    if r.status is not None and r.status < 500
                    and not (r.status == 200 and r.error is not None))
                total = len(rs)
            else:
                get = metric.get(obj.name)
                if get is None:  # not client-measurable (queue_wait)
                    continue
                xs = [x for x in (get(r) for r in rs if r.ok)
                      if x is not None]
                good = sum(1 for x in xs if x <= obj.threshold_s)
                total = len(xs)
            cls_out[obj.name] = {
                "good": good, "total": total,
                "target": obj.target,
                "attainment": (round(good / total, 6)
                               if total else None),
                "budget_consumed": (round(
                    (total - good) / (total * obj.budget), 6)
                    if total else 0.0),
            }
        out[cls] = cls_out
    return out


# -- CLI -------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="replay",
        description="Replay a request trace (engine reqlog, saved "
                    "trace file, or seeded synthetic) against an "
                    "OpenAI-compatible endpoint with original "
                    "inter-arrival gaps; prints a one-line JSON SLO "
                    "report (docs/autoscaling.md). With --topology N "
                    "it spawns its own router + N engines on "
                    "--device first.")
    p.add_argument("--url", action="append", default=None,
                   help="endpoint to replay against (router or "
                        "engine); repeatable — extra URLs are "
                        "failover fronts tried on transport failure "
                        "(docs/router-ha.md); omit with --topology "
                        "to self-spawn")
    p.add_argument("--topology", type=int, default=0, metavar="N",
                   help="spawn a router + N engine subprocesses and "
                        "replay against them (CI / laptop mode)")
    p.add_argument("--trace", default=None,
                   help="trace source: a save_trace JSONL or an "
                        "engine reqlog (schema v1 or v2)")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic trace seed (used when --trace is "
                        "not given)")
    p.add_argument("--requests", type=int, default=20)
    p.add_argument("--base-rate", type=float, default=3.0)
    p.add_argument("--burst-factor", type=float, default=4.0)
    p.add_argument("--compress", type=float, default=1.0,
                   help="time-compression factor (>1 replays faster)")
    p.add_argument("--amplify", type=int, default=1,
                   help="duplicate requests in the busiest window "
                        "this many times")
    p.add_argument("--slo-ttft-p99", type=float, default=2.0)
    p.add_argument("--slo-e2e-p99", type=float, default=None)
    p.add_argument("--slo-spec", default=None,
                   help="SLO spec JSON (config/slo.json format): "
                        "adds a per-class 'slo' section of "
                        "client-observed attainment + budget burn "
                        "to the report (docs/slo.md)")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--save-trace", default=None,
                   help="also write the (transformed) trace to this "
                        "path for re-replay")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--max-slots", type=int, default=2)
    p.add_argument("--kv-block", type=int, default=16)
    p.add_argument("--kv-blocks", type=int, default=40)
    p.add_argument("--device", default="cuda",
                   help="device of the --topology engines (cuda, "
                        "cuda:N or cpu); a child that cannot start "
                        "there fails the run")
    p.add_argument("--base-dir", default=None,
                   help="scratch dir for --topology logs (default: "
                        "fresh temp dir)")
    return p


def _load_trace_arg(args) -> List[TraceRequest]:
    if args.trace:
        path = pathlib.Path(args.trace)
        try:
            tr = trace_mod.load_trace(path)
        except (KeyError, ValueError):
            tr = trace_mod.load_reqlog(path)
        if not tr:
            raise SystemExit(f"no replayable records in {path}")
    else:
        tr = trace_mod.synthetic_trace(
            args.seed, n=args.requests, base_rate=args.base_rate,
            burst_factor=args.burst_factor)
    if args.amplify > 1:
        tr = trace_mod.amplify_bursts(tr, args.amplify,
                                      seed=args.seed)
    if args.compress != 1.0:
        tr = trace_mod.compress(tr, args.compress)
    return tr


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.url and not args.topology:
        build_parser().error("need --url or --topology N")
    tr = _load_trace_arg(args)
    if args.save_trace:
        trace_mod.save_trace(tr, args.save_trace)

    cleanup = False
    base_dir = args.base_dir
    if args.topology and base_dir is None:
        import tempfile
        base_dir = tempfile.mkdtemp(prefix="ome-replay-")
        cleanup = True

    pool = None
    router = None
    try:
        url = args.url
        if args.topology:
            from ..chaos import (ChaosError, ManagedProc, free_port,
                                 refuse_kv_block)
            from .pool import EnginePool
            base = pathlib.Path(base_dir)
            model_dir = args.model_dir
            if model_dir is None:
                model_dir = str(base / "model")
                pathlib.Path(model_dir).mkdir(parents=True,
                                              exist_ok=True)
            try:
                refuse_kv_block(args.kv_block, args.device, model_dir)
            except ChaosError as e:
                raise SystemExit(str(e))

            def engine_args(port, name, journal_dir):
                return ["--model-dir", model_dir, "--random-weights",
                        "--dtype", "float32", "--host", "127.0.0.1",
                        "--port", str(port),
                        "--max-slots", str(args.max_slots),
                        "--kv-block", str(args.kv_block),
                        "--kv-blocks", str(args.kv_blocks),
                        "--prefix-cache-mb", "8",
                        "--journal", str(journal_dir),
                        "--journal-fsync", "always"]

            pool = EnginePool("engine", None, engine_args, base,
                              device=args.device)
            for _ in range(args.topology):
                pool.spawn()
            rport = free_port()
            rargs = ["--bind", "127.0.0.1", "--port", str(rport),
                     "--policy", "round_robin",
                     "--health-interval", "1.0"]
            for u in pool.member_urls():
                rargs += ["--backend", u]
            router = ManagedProc("router", "router", rargs, rport,
                                 base / "router.log")
            router.start()
            router.wait_ready()
            url = router.url

        results = replay(url, tr, timeout=args.timeout,
                         prompt_seed=args.seed)
        rep = report(results, slo_ttft_s=args.slo_ttft_p99,
                     slo_e2e_s=args.slo_e2e_p99)
        if args.slo_spec:
            from ..slo import load as load_slo
            rep["slo"] = slo_section(results,
                                     load_slo(args.slo_spec))
        rep["endpoint"] = (url if isinstance(url, str)
                           else url[0] if len(url) == 1 else url)
        print(json.dumps(rep, separators=(",", ":"), default=str))
        sys.stdout.flush()
        return 0 if rep["errors"] == 0 else 1
    finally:
        if pool is not None:
            pool.stop_all()
        if router is not None:
            router.stop()
        if cleanup:
            import shutil
            shutil.rmtree(base_dir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
