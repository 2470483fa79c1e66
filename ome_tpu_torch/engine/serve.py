"""`python -m ome_tpu_torch.engine.serve` — the port's engine entrypoint.

Counterpart of ome_tpu/engine/serve.py for the PyTorch engine: builds
the InferenceEngine on one device, the continuous-batching Scheduler
and the OpenAI-compatible HTTP surface, then serves until SIGTERM (first
signal drains, a second forces). Runs on CUDA unless `--device cpu`.

    python -m ome_tpu_torch.engine.serve --model-dir DIR --random-weights \\
        [--device cpu] [--kv-block 128 [--kv-blocks N] [--kv-dtype int8]] \\
        [--quantization int8|int4|fp8]

`--random-weights` draws the weights from `--seed` for the shape in
DIR/config.json (loading a safetensors checkpoint is not ported yet).
`--kv-block` serves from a paged KV pool (bf16, or int8 with
`--kv-dtype int8`) whose decode attention runs the paged CUDA kernel;
a model or block size that kernel does not take exits with the
engine's message — there is no silent fall back to the dense cache.
`--quantization` quantizes the weights at load as the reference does
(`models/quant.quantize_params`); under int4 the eligible projections
run the int4 CUDA kernel.
`build_server(argv)` does everything `main` does except block, so a
caller (chip_smoke.py, the tests) drives the same code in process.

Flags of the reference outside this slice are either not defined here
(argparse then names them as unrecognized) or refused when given a
non-default value, with a message naming the flag: nothing is silently
ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time

import torch

log = logging.getLogger("ome.engine.serve")

# multi-host serving is configured through this environment contract
# (controllers/reconcilers/multinode.py); the port serves one host
_MULTIHOST_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ome-engine-torch",
        description="OME serving engine, PyTorch/CUDA port")
    p.add_argument("--model-dir", required=True,
                   help="staged model directory (config.json)")
    p.add_argument("--model-name", default=None,
                   help="name reported by /v1/models (default: dir name)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' "
                        "only when asked for, e.g. in tests)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of --random-weights and of the sampling "
                        "generator")
    p.add_argument("--max-slots", type=int, default=16,
                   help="decode batch width (continuous-batching slots)")
    p.add_argument("--max-seq", type=int, default=None,
                   help="KV capacity per slot (default: model max, "
                        "capped at 8192)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--random-weights", action="store_true",
                   help="random weights from --seed instead of loading "
                        "a checkpoint")
    p.add_argument("--prefix-cache-mb", type=int, default=256,
                   help="device byte budget (MiB) for the radix prompt-"
                        "prefix KV cache (0 disables)")
    p.add_argument("--kv-block", type=int, default=0,
                   help="paged KV cache block size in tokens (0 = "
                        "dense per-slot cache); pool-allocated device "
                        "memory sized by tokens in flight, not "
                        "slots x max-seq (GQA models)")
    p.add_argument("--kv-blocks", type=int, default=None,
                   help="paged KV pool size in blocks (default: "
                        "dense-equivalent capacity)")
    p.add_argument("--kv-dtype", choices=("bf16", "int8"),
                   default="bf16",
                   help="paged KV block pool storage dtype: int8 "
                        "halves pool memory per cached token (per-row-"
                        "per-head scales, quantize on append, "
                        "dequantize in the attention kernel) so the "
                        "same budget holds ~2x the sequences; needs "
                        "--kv-block")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="consecutive engine-fault recovery attempts "
                        "before the scheduler goes permanently dead")
    p.add_argument("--max-queue-wait", type=float, default=30.0,
                   help="reject new requests (429 + Retry-After) when "
                        "the estimated pending-queue wait exceeds this "
                        "many seconds")
    p.add_argument("--class-weights", default=None, metavar="SPEC",
                   help="weighted-fair scheduling weights per priority "
                        "class, e.g. 'interactive=8,standard=4,batch=1'")
    p.add_argument("--class-wait-cap", action="append", default=None,
                   metavar="CLASS=SECONDS",
                   help="per-class queue-wait admission cap in seconds "
                        "(repeatable)")
    p.add_argument("--no-priority-scheduling", action="store_true",
                   help="schedule every request FIFO as one class")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="decode steps dispatched ahead of token emission "
                        "(1 overlaps the host-side token fetch with the "
                        "next device step; 0 fetches every step)")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="graceful-drain window after SIGTERM")
    p.add_argument("--faults", default=None,
                   help="deterministic fault-injection spec (faults.py "
                        "grammar, e.g. 'engine_step.raise@100'); also "
                        "via OME_FAULTS")
    p.add_argument("--request-log", default=None,
                   help="JSONL request-log path")
    p.add_argument("--span-log", default=None, metavar="PATH",
                   help="span-timeline JSONL path")
    p.add_argument("--debug-endpoints", action="store_true",
                   help="enable GET /debug/events and GET /debug/state")
    p.add_argument("--flight-events", type=int, default=2048,
                   metavar="N", help="flight-recorder ring capacity")
    p.add_argument("--quantization",
                   choices=("none", "int8", "int4", "fp8"),
                   default="none",
                   help="weight-only quantization at load time: int8 or "
                        "fp8 (float8_e4m3fn) per output channel, one "
                        "byte per weight; int4 groupwise (group 128) "
                        "for wq/wk/wv/w_gate/w_up, whose decode "
                        "projections run the int4 CUDA kernel, with the "
                        "other matmul weights at int8")
    p.add_argument("--flight-dump-dir", default=None, metavar="DIR",
                   help="auto-dump the flight-recorder ring into DIR on "
                        "engine-fault recovery and permanent death")
    # flags of the reference kept for their default only: any other
    # value asks for a feature this port does not have yet
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--task", default="generate")
    p.add_argument("--prefix-cache-host-mb", type=int, default=0)
    p.add_argument("--disaggregation-mode", default="none")
    p.add_argument("--spec-tokens", type=int, default=0)
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.add_argument("--ledger-mode", default="off")
    return p


# flag -> the only value this slice serves
_SLICE_DEFAULTS = {
    "tp": 1, "task": "generate",
    "prefix_cache_host_mb": 0,
    "disaggregation_mode": "none", "spec_tokens": 0,
    "steps_per_dispatch": 1, "ledger_mode": "off",
}


def check_slice(args, env=None) -> None:
    """Exit with a message naming the flag (or environment) that asks
    for something outside this slice of the port."""
    for dest, want in _SLICE_DEFAULTS.items():
        got = getattr(args, dest)
        if got != want:
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(
                f"{flag} {got}: not supported by the PyTorch engine yet "
                f"(this slice serves only {flag} {want})")
    if args.kv_block < 0:
        raise SystemExit(f"--kv-block {args.kv_block}: must be 0 (dense "
                         "cache) or a positive block size in tokens")
    if args.kv_dtype == "int8" and not args.kv_block:
        raise SystemExit("--kv-dtype int8 quantizes the paged block pool; "
                         "enable paged KV (--kv-block) to use it")
    env = os.environ if env is None else env
    if env.get(_MULTIHOST_ENV[0]) and \
            int(env.get(_MULTIHOST_ENV[1], "1") or 1) > 1:
        raise SystemExit(
            f"multi-host environment ({', '.join(_MULTIHOST_ENV)}) is "
            "not supported by the PyTorch engine yet; serve one host")
    if not args.random_weights:
        raise SystemExit(
            "loading a checkpoint is not ported to the PyTorch engine "
            "yet; pass --random-weights")


def _load_cfg(model_dir: str, dtype):
    from ..models.config import ModelConfig, tiny_test
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = ModelConfig.from_hf_config(json.load(f))
    else:
        cfg = tiny_test()
    return cfg.replace(dtype=dtype)


def load_engine(args):
    """The InferenceEngine for `args`, with random weights from
    --seed on --device."""
    from ..device import resolve_device
    from ..models.params import init_params, param_count
    from ..models.quant import quantize_params, quantized_bytes
    from .core import InferenceEngine, PagedKVUnsupported

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = _load_cfg(args.model_dir, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.monotonic()
    params = init_params(cfg, gen, device)
    log.info("initialized random weights: %.2fM params on %s in %.1fs",
             param_count(params) / 1e6, device, time.monotonic() - t0)
    if args.quantization != "none":
        t0 = time.monotonic()
        # leaf by leaf, dropping each bf16 leaf once quantized
        params = quantize_params(params, mode=args.quantization,
                                 consume=True)
        log.info("quantized weights to %s (weight-only) in %.1fs: %.2f GB "
                 "of weights", args.quantization, time.monotonic() - t0,
                 quantized_bytes(params) / 1e9)
    max_seq = args.max_seq or min(cfg.max_seq_len, 8192)
    try:
        return InferenceEngine(
            params, cfg, max_slots=args.max_slots, max_seq=max_seq,
            prefix_cache_bytes=args.prefix_cache_mb << 20,
            kv_block=args.kv_block, kv_blocks=args.kv_blocks,
            kv_dtype=args.kv_dtype if args.kv_block else None,
            device=device, seed=args.seed)
    except PagedKVUnsupported as e:
        # the paged guards (model family, the CUDA kernel's coverage):
        # exit with the engine's reason instead of serving another cache
        raise SystemExit(f"--kv-block {args.kv_block}: {e}")


class DrainController:
    """SIGTERM/SIGINT choreography: the FIRST signal begins a graceful
    drain — /ready flips 503, new admissions are rejected 503 +
    Retry-After, in-flight and queued requests get up to `grace`
    seconds to finish; a SECOND signal forces immediate shutdown."""

    def __init__(self, server, scheduler, grace: float = 30.0,
                 poll_interval: float = 0.02):
        self.server = server
        self.scheduler = scheduler
        self.grace = grace
        self.poll_interval = poll_interval
        self._signalled = threading.Event()
        self._force = threading.Event()
        self.drained: bool = False
        reg = scheduler.registry
        self._g_draining = reg.gauge(
            "ome_engine_draining",
            "1 while this replica is draining after SIGTERM")
        self._g_duration = reg.gauge(
            "ome_engine_drain_duration_seconds",
            "Seconds the last (or current) drain has taken")

    def install(self):
        """Install the signal handlers (main thread only)."""
        import signal
        signal.signal(signal.SIGTERM, self.handle_signal)
        signal.signal(signal.SIGINT, self.handle_signal)

    def handle_signal(self, *_):
        if self._signalled.is_set():
            self._force.set()  # second signal: stop waiting
        else:
            self._signalled.set()

    def wait(self):
        """Block until the first signal, then run the drain."""
        self._signalled.wait()
        return self.drain()

    def drain(self) -> bool:
        """Run the drain window; returns True when every in-flight
        request finished inside the grace period."""
        from .. import faults
        t0 = time.monotonic()
        log.warning("shutdown signal: draining (grace %.1fs; signal "
                    "again to force)", self.grace)
        self.server.begin_drain()
        self._g_draining.set(1)
        drained = False
        while time.monotonic() - t0 < self.grace:
            if self._force.is_set():
                log.warning("second signal: forcing shutdown with "
                            "work in flight")
                break
            if self.scheduler.drain_idle():
                drained = True
                break
            self._g_duration.set(time.monotonic() - t0)
            time.sleep(self.poll_interval)
        if not drained and not self._force.is_set():
            faults.fire("drain_timeout")
        dur = time.monotonic() - t0
        self._g_duration.set(dur)
        self.scheduler.flight.record("drain_end", drained=drained,
                                     dur_s=round(dur, 3),
                                     forced=self._force.is_set())
        if drained:
            log.info("drain complete in %.2fs (all requests finished)",
                     dur)
        else:
            log.warning("drain window closed after %.2fs with work in "
                        "flight; evicting with finish_reason=shutdown",
                        dur)
        self.drained = drained
        return drained


def build_server(argv=None):
    """Everything `main` does short of blocking: parse `argv`, check
    the slice, build engine, scheduler and server, and start serving.
    Returns (server, scheduler, engine); the caller stops the server."""
    from ..priority import coerce_priority, parse_weight_spec
    from ..telemetry.flight import FlightRecorder
    from .scheduler import Scheduler
    from .server import EngineServer
    from .tokenizer import load_tokenizer

    args = build_parser().parse_args(argv)
    check_slice(args)
    if args.faults:
        from .. import faults
        faults.install(args.faults)
        log.warning("fault injection ACTIVE: %s", args.faults)
    # parse the multi-tenancy flags before the weights, so a bad spec
    # fails fast
    class_weights = None
    class_wait_caps = None
    try:
        if args.class_weights:
            class_weights = parse_weight_spec(args.class_weights)
        if args.class_wait_cap:
            class_wait_caps = {}
            for spec in args.class_wait_cap:
                cls, sep, secs = spec.partition("=")
                if not sep:
                    raise ValueError(
                        f"bad --class-wait-cap {spec!r} "
                        "(expected class=seconds)")
                class_wait_caps[coerce_priority(cls)] = float(secs)
    except ValueError as e:
        raise SystemExit(str(e))
    engine = load_engine(args)
    scheduler = Scheduler(engine, overlap=True,
                          max_restarts=args.max_restarts,
                          max_queue_wait=args.max_queue_wait,
                          pipeline_depth=args.pipeline_depth,
                          span_log=args.span_log,
                          flight=FlightRecorder(
                              capacity=max(args.flight_events, 16)),
                          flight_dump_dir=args.flight_dump_dir,
                          class_weights=class_weights,
                          class_wait_caps=class_wait_caps,
                          priority_scheduling=not
                          args.no_priority_scheduling)
    name = args.model_name or args.model_dir.rstrip("/").rsplit("/", 1)[-1]
    server = EngineServer(scheduler, tokenizer=load_tokenizer(
                              args.model_dir),
                          model_name=name, host=args.host, port=args.port,
                          request_log=args.request_log,
                          debug_endpoints=args.debug_endpoints)
    log.info("serving %s on %s:%d (device=%s slots=%d max_seq=%d "
             "kv_block=%d kv_dtype=%s quantization=%s)", name, args.host,
             server.port, engine.device, engine.max_slots, engine.max_seq,
             engine.kv_block, args.kv_dtype if engine.kv_block else "-",
             args.quantization)
    server.start()
    return server, scheduler, engine


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    grace = build_parser().parse_args(argv).drain_grace
    server, scheduler, _ = build_server(argv)
    ctl = DrainController(server, scheduler, grace=grace)
    try:
        ctl.install()
        ctl.wait()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
