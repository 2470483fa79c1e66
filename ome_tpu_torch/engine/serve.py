"""`python -m ome_tpu_torch.engine.serve` — the port's engine entrypoint.

Counterpart of ome_tpu/engine/serve.py for the PyTorch engine: builds
the InferenceEngine on one device, the continuous-batching Scheduler
and the OpenAI-compatible HTTP surface, then serves until SIGTERM (first
signal drains, a second forces). Runs on CUDA unless `--device cpu`.

    python -m ome_tpu_torch.engine.serve --model-dir DIR [--random-weights] \\
        [--device cpu] [--kv-block 128 [--kv-blocks N] [--kv-dtype int8]] \\
        [--quantization int8|int4|fp8] [--spec-tokens N] \\
        [--steps-per-dispatch K] [--prefix-cache-host-mb MB] \\
        [--journal DIR [--journal-fsync always|batch|off] \\
         [--journal-compact-mb MB]] \\
        [--disaggregation-mode prefill | --disaggregation-mode decode \\
         --prefill-url URL [--prefill-url URL ...] [--pd-local-fallback] \\
         [--pd-attempt-timeout S]] \\
        [--adapter DIR | --adapter NAME=DIR ... [--lora-slots N] \\
         [--lora-rank R]]
    python -m ome_tpu_torch.engine.serve --task embed --model-dir DIR ...

DIR is a HuggingFace model directory: config.json plus safetensors
weights (one file, or shards with model.safetensors.index.json), loaded
by `models/checkpoint.load_params` onto the device;
`--random-weights` instead draws the weights from `--seed` for the
shape in DIR/config.json. Every architecture of the reference's gate is
served, the MLA family included (`DeepseekV2ForCausalLM`,
`DeepseekV3ForCausalLM`: DeepSeek-V2, V2-Lite, V3, Kimi-K2, over a
latent KV cache); a MoE model runs the ragged dispatch
(`moe_impl="ragged"`), as the reference serves it on one device.
`--kv-block` serves from a paged KV pool (bf16, or int8 with
`--kv-dtype int8`) whose decode attention runs the paged CUDA kernel;
a model or block size that kernel does not take exits with the
engine's message — there is no silent fall back to the dense cache.
`--quantization` quantizes the weights at load as the reference does
(`models/quant.quantize_params`); under int4 the eligible projections
run the int4 CUDA kernel. `--spec-tokens N` verifies up to N n-gram
drafts per slot in one forward, `--steps-per-dispatch K` runs K decode
iterations per engine call; both compose with pipelining and with
`response_format` grammar masks, as in the reference.
`--prefix-cache-host-mb` gives the prefix cache a host-memory spill
tier. `--disaggregation-mode prefill` serves `/pd/prefill` only (no
decode loop; completions answer 503); `--disaggregation-mode decode`
fetches each prompt's KV from the `--prefill-url` pool
(`engine/pd.py`), failing over between peers, and with
`--pd-local-fallback` computes the prefill itself when every peer is
out. A plain replica with a prefix cache also serves `/pd/prefill` as a
donor of cross-replica prefix reuse (`engine/peering.py`).
`--journal DIR` makes requests durable (`engine/journal.py`): admitted
requests and their generated tokens are journaled, leftovers of a drain
or a dead scheduler stay live, and a process started over the same DIR
resumes them byte-identical (greedy) before it serves new traffic; on a
PD decode node the admit records carry the prefill pool, and a resumed
request re-prefills through it.
`--adapter DIR` (one bare PEFT directory) merges the adapter into the
checkpoint's weights at load (`models/lora.merge_lora`, before
quantization; not with `--random-weights`); `--adapter NAME=DIR`
(repeatable) serves each adapter as its own model id from
`--lora-slots` hot-swappable slots of rank `--lora-rank` (default: 4
slots, or one per named adapter when more), registered after the engine
is built; `POST /v1/adapters` and `DELETE /v1/adapters/NAME` add and
remove adapters while serving.
`--task embed` serves `/v1/embeddings` from `engine/embed.py`'s
EmbeddingEngine instead of a decode loop (completions answer 503); the
flags that configure generation (`--journal`, paged KV, quantization,
step plans, PD, named adapters) are refused with it by name. On a card
it needs cuBLAS without a workspace (`CUBLAS_WORKSPACE_CONFIG=:0:0`), so
that an input's embedding does not depend on its batch: `main` sets it
before anything touches CUDA, and `build_server` refuses to start
without it.
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
    p.add_argument("--journal", default=None, metavar="DIR",
                   help="durable requests: append-only JSONL request "
                        "journal in DIR; admitted requests and their "
                        "generated tokens are journaled, and on restart "
                        "unfinished requests resume byte-identical "
                        "(greedy) to an uninterrupted run")
    p.add_argument("--journal-fsync",
                   choices=("always", "batch", "off"), default="batch",
                   help="journal durability: 'always' fsyncs every "
                        "append, 'batch' (default) fsyncs at most every "
                        "~100ms from the scheduler loop, 'off' leaves "
                        "flushing to the OS")
    p.add_argument("--journal-compact-mb", type=int, default=4,
                   help="rewrite the journal (dropping tombstoned "
                        "entries, consolidating progress) when it exceeds "
                        "this many MiB")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="graceful-drain window after SIGTERM; leftovers "
                        "are journaled (with --journal) and evicted with "
                        "finish_reason=shutdown")
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
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="decode iterations per engine call: the host "
                        "dispatches and syncs once per K-token chunk "
                        "instead of per token; greedy output is "
                        "byte-identical to K=1")
    p.add_argument("--prefix-cache-host-mb", type=int, default=0,
                   help="host-memory budget (MiB) of the prefix cache's "
                        "spill tier (0 disables): evicted blocks spill "
                        "to host memory instead of being dropped and swap "
                        "back in asynchronously on the next hit")
    p.add_argument("--disaggregation-mode",
                   choices=("none", "prefill", "decode"), default="none",
                   help="PD-disaggregated serving role: 'prefill' exports "
                        "KV over /pd/prefill; 'decode' fetches KV from "
                        "the --prefill-url pool instead of computing "
                        "prefill locally")
    p.add_argument("--prefill-peer", default=None,
                   help="single prefill peer URL (alias of --prefill-url, "
                        "merged first into the pool)")
    p.add_argument("--prefill-url", action="append", default=None,
                   metavar="URL",
                   help="prefill pool peer URL; repeatable. A decode node "
                        "tracks each peer's health (the router's breaker/"
                        "draining discipline) and fails a dropped "
                        "/pd/prefill fetch over to the next healthy peer")
    p.add_argument("--pd-local-fallback", action="store_true",
                   help="decode role: when every prefill peer is out of "
                        "rotation, compute the prefill locally instead of "
                        "failing the request")
    p.add_argument("--pd-attempt-timeout", type=float, default=120.0,
                   metavar="SECONDS",
                   help="per-attempt /pd/prefill fetch timeout; each "
                        "attempt is further capped by the request's own "
                        "deadline")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative decoding: max draft tokens per slot "
                        "per step proposed by the host-side n-gram "
                        "drafter and verified in one batched multi-token "
                        "forward; 0 = off (default). Greedy output is "
                        "byte-identical either way")
    p.add_argument("--task", choices=("generate", "embed"),
                   default="generate",
                   help="'embed' serves /v1/embeddings (last-token "
                        "pooled, L2-normalized decoder embeddings) "
                        "instead of generation")
    p.add_argument("--adapter", action="append", default=None,
                   help="LoRA serving: a bare PEFT dir merges into the "
                        "base weights at load; repeatable name=dir pairs "
                        "serve MULTIPLE adapters concurrently (per-request "
                        "routing by model id, hot add via POST "
                        "/v1/adapters)")
    p.add_argument("--lora-slots", type=int, default=None,
                   help="preallocated hot-swappable LoRA adapter slots "
                        "(default: number of name=dir adapters, min 4 "
                        "when any are given)")
    p.add_argument("--lora-rank", type=int, default=16,
                   help="max adapter rank a LoRA slot holds")
    # flags of the reference kept for their default only: any other
    # value asks for a feature this port does not have yet
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ledger-mode", default="off")
    return p


# flag -> the only value this slice serves
_SLICE_DEFAULTS = {"tp": 1, "ledger_mode": "off"}

# flags that configure generation, at their defaults: an embeddings
# deployment refuses any other value by name (the reference ignores
# them there)
_GENERATION_ONLY = {"journal": None, "disaggregation_mode": "none",
                    "kv_block": 0, "quantization": "none",
                    "spec_tokens": 0, "steps_per_dispatch": 1,
                    "prefix_cache_host_mb": 0, "lora_slots": None}


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
    if args.prefix_cache_host_mb < 0:
        raise SystemExit(f"--prefix-cache-host-mb "
                         f"{args.prefix_cache_host_mb}: must be >= 0")
    if args.disaggregation_mode == "decode" and not prefill_urls(args):
        raise SystemExit("--disaggregation-mode decode requires at least "
                         "one --prefill-url (or --prefill-peer)")
    if args.journal and args.disaggregation_mode == "prefill":
        raise SystemExit("--journal journals the requests of a decode "
                         "loop; a --disaggregation-mode prefill node has "
                         "none")
    if args.task == "embed":
        for dest, default in _GENERATION_ONLY.items():
            if getattr(args, dest) != default:
                flag = "--" + dest.replace("_", "-")
                raise SystemExit(
                    f"{flag} configures generation; --task embed serves "
                    "embeddings only and has no decode loop")
        if _adapter_args(args)[1]:
            raise SystemExit("--adapter name=dir serves adapters for "
                             "generation; --task embed takes only a bare "
                             "--adapter dir, merged at load")
    if args.lora_slots is not None and args.lora_slots < 0:
        raise SystemExit(f"--lora-slots {args.lora_slots}: must be >= 0")
    if args.lora_rank < 1:
        raise SystemExit(f"--lora-rank {args.lora_rank}: must be >= 1")
    if args.disaggregation_mode != "decode" and (
            prefill_urls(args) or args.pd_local_fallback):
        raise SystemExit("--prefill-url/--prefill-peer/--pd-local-fallback "
                         "configure a PD decode node: they need "
                         "--disaggregation-mode decode")
    env = os.environ if env is None else env
    if env.get(_MULTIHOST_ENV[0]) and \
            int(env.get(_MULTIHOST_ENV[1], "1") or 1) > 1:
        raise SystemExit(
            f"multi-host environment ({', '.join(_MULTIHOST_ENV)}) is "
            "not supported by the PyTorch engine yet; serve one host")


def _adapter_args(args):
    """--adapter forms -> (merge_dir | None, {name: dir}).

    A single bare directory keeps the merge-at-load behavior (one
    adapter at full base speed); any name=dir entry switches to
    multi-LoRA serving slots."""
    entries = args.adapter or []
    named = {}
    bare = []
    for e in entries:
        if "=" in e:
            name, _, path = e.partition("=")
            named[name] = path
        else:
            bare.append(e)
    if bare and (named or len(bare) > 1):
        raise SystemExit("--adapter: use name=dir form when serving "
                         "multiple adapters")
    return (bare[0] if bare else None), named


def prefill_urls(args):
    """The PD prefill pool: --prefill-peer first, then each
    --prefill-url."""
    return (([args.prefill_peer] if args.prefill_peer else [])
            + list(args.prefill_url or []))


def _load_cfg(model_dir: str, dtype):
    from ..models.config import ModelConfig, tiny_test
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = ModelConfig.from_hf_config(json.load(f))
    else:
        cfg = tiny_test()
    return cfg.replace(dtype=dtype)


def load_params_cfg(args, device):
    """(params, cfg) on `device`: the safetensors checkpoint in
    --model-dir, or random weights from --seed for its config.json. A
    head_dim the CUDA kernels do not take exits before any weight is
    read (MLA models launch none of them: `check_model_head_dim`)."""
    from ..models import checkpoint
    from ..models.params import init_params, param_count
    from ..ops.flash import check_model_head_dim

    def refuse_head_dim(cfg):
        try:
            check_model_head_dim(cfg, device)
        except NotImplementedError as e:
            raise SystemExit(f"--model-dir {args.model_dir}: {e}")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    t0 = time.monotonic()
    if args.random_weights:
        cfg = _load_cfg(args.model_dir, dtype)
        refuse_head_dim(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = init_params(cfg, gen, device)
        log.info("initialized random weights: %.2fM params on %s in "
                 "%.1fs", param_count(params) / 1e6, device,
                 time.monotonic() - t0)
        return params, cfg
    try:
        cfg = checkpoint.load_config(args.model_dir)
        refuse_head_dim(cfg)
        params, cfg = checkpoint.load_params(args.model_dir, cfg=cfg,
                                             dtype=dtype, device=device)
    except (checkpoint.SafetensorsError, NotImplementedError,
            FileNotFoundError) as e:
        raise SystemExit(f"--model-dir {args.model_dir}: {e}")
    log.info("loaded checkpoint from %s: %.2fM params on %s in %.1fs",
             args.model_dir, param_count(params) / 1e6, device,
             time.monotonic() - t0)
    merge_dir = _adapter_args(args)[0]
    if merge_dir:
        from ..models.lora import merge_lora
        try:
            merged = merge_lora(params, cfg, merge_dir)
        except (ValueError, OSError, checkpoint.SafetensorsError) as e:
            raise SystemExit(f"--adapter {merge_dir}: {e}")
        log.info("merged %d LoRA deltas from %s", merged, merge_dir)
    return params, cfg


def load_engine(args):
    """The InferenceEngine for `args` on --device: the checkpoint in
    --model-dir, or random weights from --seed."""
    from ..device import resolve_device
    from ..models.quant import quantize_params, quantized_bytes
    from .core import InferenceEngine, PagedKVUnsupported

    device = resolve_device(args.device)
    params, cfg = load_params_cfg(args, device)
    if cfg.is_moe:
        # one device: the ragged grouped-product dispatch, as the
        # reference serves with tp 1 (the dense impl computes every
        # expert for every token)
        cfg = cfg.replace(moe_impl="ragged")
    if args.quantization != "none":
        t0 = time.monotonic()
        # leaf by leaf, dropping each bf16 leaf once quantized
        params = quantize_params(params, mode=args.quantization,
                                 consume=True)
        log.info("quantized weights to %s (weight-only) in %.1fs: %.2f GB "
                 "of weights", args.quantization, time.monotonic() - t0,
                 quantized_bytes(params) / 1e9)
    max_seq = args.max_seq or min(cfg.max_seq_len, 8192)
    _, named_adapters = _adapter_args(args)
    lora_slots = args.lora_slots if args.lora_slots is not None else \
        (max(4, len(named_adapters)) if named_adapters else 0)
    try:
        engine = InferenceEngine(
            params, cfg, max_slots=args.max_slots, max_seq=max_seq,
            prefix_cache_bytes=args.prefix_cache_mb << 20,
            prefix_host_bytes=args.prefix_cache_host_mb << 20,
            kv_block=args.kv_block, kv_blocks=args.kv_blocks,
            kv_dtype=args.kv_dtype if args.kv_block else None,
            device=device, seed=args.seed, lora_slots=lora_slots,
            lora_rank=args.lora_rank)
    except PagedKVUnsupported as e:
        # the paged guards (model family, the CUDA kernel's coverage):
        # exit with the engine's reason instead of serving another cache
        raise SystemExit(f"--kv-block {args.kv_block}: {e}")
    from ..models.checkpoint import SafetensorsError
    for name, path in named_adapters.items():
        try:
            engine.register_adapter(name, path)
        except (ValueError, OSError, SafetensorsError) as e:
            raise SystemExit(f"--adapter {name}={path}: {e}")
        log.info("registered LoRA adapter %r from %s", name, path)
    return engine


def load_embedder(args):
    """The EmbeddingEngine for `args` on --device: the checkpoint in
    --model-dir (a bare --adapter dir merged), or random weights."""
    from ..device import resolve_device
    from .embed import EmbeddingEngine
    device = resolve_device(args.device)
    params, cfg = load_params_cfg(args, device)
    return EmbeddingEngine(params, cfg, max_seq=args.max_seq,
                           device=device)


class _NullScheduler:
    """A scheduler that drives nothing: a node without a decode loop
    (an embeddings deployment is stateless)."""

    healthy = True
    status = "ok"
    reject = "this deployment serves embeddings only"

    def __init__(self):
        from ..telemetry import Registry
        from ..telemetry.flight import FlightRecorder
        self.stats: dict = {}
        self.registry = Registry()
        self.flight = FlightRecorder()

    def start(self):
        pass

    def stop(self):
        pass

    def submit(self, req):
        raise RuntimeError(self.reject)

    def begin_drain(self):
        pass

    def drain_idle(self):
        return True  # nothing in flight to wait for


class _PrefillNodeScheduler(_NullScheduler):
    """PD prefill nodes have no decode loop; completions are rejected
    and the work arrives through /pd/prefill instead."""

    reject = ("this node serves PD prefill only (route completions to "
              "the decode pool)")

    def __init__(self, engine):
        super().__init__()
        self.engine = engine


class DrainController:
    """SIGTERM/SIGINT choreography: the FIRST signal begins a graceful
    drain — /ready flips 503, new admissions are rejected 503 +
    Retry-After, in-flight and queued requests get up to `grace`
    seconds to finish; a SECOND signal forces immediate shutdown."""

    def __init__(self, server, scheduler, grace: float = 30.0,
                 journal=None, poll_interval: float = 0.02):
        self.server = server
        self.scheduler = scheduler
        self.grace = grace
        self.journal = journal
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
                        "flight; evicting with finish_reason=shutdown%s",
                        dur, " (journaled for resume)"
                        if self.journal is not None else "")
        self.drained = drained
        return drained


# cuBLAS without a workspace: with one, cuBLAS splits a product's
# reduction (split-K) by its row count, so an input's embedding would
# depend on what shares its bucket's batch; without one it does not
# (chip_smoke phase 31). cuBLAS reads the variable once, at the
# process's first product, so it is set before CUDA is touched
EMBED_CUBLAS_WORKSPACE = ":0:0"


def check_embed_workspace(device) -> None:
    """Refuse `--task embed` on a card unless CUBLAS_WORKSPACE_CONFIG
    is EMBED_CUBLAS_WORKSPACE (`main` sets it; an in-process caller sets
    it before the process's first CUDA product)."""
    from ..device import DEFAULT_DEVICE
    got = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if torch.device(device or DEFAULT_DEVICE).type != "cuda" or \
            got == EMBED_CUBLAS_WORKSPACE:
        return
    when = ("and CUDA is already initialised in this process, so set it "
            "before the process starts" if torch.cuda.is_initialized()
            else "before the process's first CUDA product")
    raise SystemExit(
        f"--task embed needs CUBLAS_WORKSPACE_CONFIG="
        f"{EMBED_CUBLAS_WORKSPACE} (batch-invariant products; it is "
        f"{got!r}): set it {when}, as serve's main does")


def build_server(argv=None):
    """Everything `main` does short of blocking: parse `argv`, check
    the slice, build engine, scheduler and server, and start serving.
    Returns (server, scheduler, engine); the caller stops the server."""
    from ..priority import coerce_priority, parse_weight_spec
    from ..telemetry.flight import FlightRecorder
    from ..telemetry.reqlog import coerce as coerce_reqlog
    from ..telemetry.tracing import SpanLog
    from .journal import RequestJournal
    from .pd import RemotePrefillEngine, make_pd_prefill_handler
    from .scheduler import Scheduler
    from .server import EngineServer
    from .tokenizer import load_tokenizer

    args = build_parser().parse_args(argv)
    check_slice(args)
    if _adapter_args(args)[0] and args.random_weights:
        log.error("--adapter merge requires a real checkpoint "
                  "(incompatible with --random-weights); name=dir "
                  "multi-LoRA slots work with either")
        raise SystemExit(2)
    if args.spec_tokens < 0 or args.steps_per_dispatch < 1:
        raise SystemExit("--spec-tokens must be >= 0 and "
                         "--steps-per-dispatch >= 1")
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
    reqlog = coerce_reqlog(args.request_log)
    span_log = SpanLog(args.span_log, component="engine") \
        if args.span_log else None
    pd_prefill = None
    embedder = None
    if args.task == "embed":
        check_embed_workspace(args.device)
        # stateless: no decode loop, completions are refused
        embedder = load_embedder(args)
        scheduler = _NullScheduler()
    elif args.disaggregation_mode == "prefill":
        engine = load_engine(args)
        pd_prefill = make_pd_prefill_handler(engine)
        scheduler = _PrefillNodeScheduler(engine)
    else:
        engine = load_engine(args)
        if args.disaggregation_mode == "decode":
            # one reqlog for the server's request records and the PD
            # client's peer-failure records, joinable by trace id
            engine = RemotePrefillEngine(
                engine, peer_urls=prefill_urls(args),
                timeout=args.pd_attempt_timeout,
                local_fallback=args.pd_local_fallback,
                request_log=reqlog, span_log=span_log)
            log.info("PD decode node: prefill pool %s%s",
                     prefill_urls(args),
                     " (local fallback)" if args.pd_local_fallback else "")
        elif args.prefix_cache_mb > 0:
            # a replica with a prefix cache is also a prefix DONOR: peers
            # fetch hot prefix KV over the same /pd/prefill path
            pd_prefill = make_pd_prefill_handler(engine)
        journal = None
        if args.journal:
            # admit records on a decode node carry the PD topology, so a
            # resumed process knows these requests re-prefill over the
            # pool on replay
            provenance = ({"mode": "pd-decode", "peers": prefill_urls(args)}
                          if args.disaggregation_mode == "decode" else None)
            journal = RequestJournal(
                args.journal, fsync=args.journal_fsync,
                compact_bytes=args.journal_compact_mb << 20,
                provenance=provenance)
            log.info("request journal at %s (fsync=%s)", journal.path,
                     args.journal_fsync)
        scheduler = Scheduler(engine, overlap=True,
                              journal=journal,
                              spec_tokens=args.spec_tokens,
                              steps_per_dispatch=args.steps_per_dispatch,
                              max_restarts=args.max_restarts,
                              max_queue_wait=args.max_queue_wait,
                              pipeline_depth=args.pipeline_depth,
                              span_log=span_log,
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
                          request_log=reqlog, pd_prefill=pd_prefill,
                          embedder=embedder, structured=embedder is None,
                          debug_endpoints=args.debug_endpoints)
    if embedder is not None:
        log.info("serving embeddings of %s on %s:%d (device=%s buckets=%s)",
                 name, args.host, server.port, embedder.device,
                 embedder.buckets)
        server.start()
        return server, scheduler, embedder
    log.info("serving %s on %s:%d (device=%s slots=%d max_seq=%d "
             "kv_block=%d kv_dtype=%s quantization=%s spec_tokens=%d "
             "steps_per_dispatch=%d prefix_cache_host_mb=%d "
             "disaggregation_mode=%s)", name, args.host, server.port,
             engine.device, engine.max_slots, engine.max_seq,
             engine.kv_block, args.kv_dtype if engine.kv_block else "-",
             args.quantization, args.spec_tokens,
             args.steps_per_dispatch, args.prefix_cache_host_mb,
             args.disaggregation_mode)
    if getattr(scheduler, "journal", None) is not None:
        # restart resume BEFORE serving: unfinished requests of the
        # previous process re-enter the queue ahead of new traffic
        scheduler.resume_from_journal()
    server.start()
    return server, scheduler, engine


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.task == "embed":
        # before anything touches CUDA (`check_embed_workspace`)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                              EMBED_CUBLAS_WORKSPACE)
    server, scheduler, _ = build_server(argv)
    journal = getattr(scheduler, "journal", None)
    ctl = DrainController(server, scheduler, grace=args.drain_grace,
                          journal=journal)
    try:
        ctl.install()
        ctl.wait()
    finally:
        # stop() evicts leftovers with finish_reason=shutdown, which
        # flushes their progress WITHOUT tombstones: the replacement
        # process resumes them
        server.stop()
        if journal is not None:
            journal.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
