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
`--tp N` serves the model tensor-parallel over N ranks, one process
each (`engine/sharded.py`, `parallel/`): the leader (rank 0, this
process) serves HTTP and runs the scheduler, and publishes its op stream
to the followers, which replay it (`engine/multihost.py`). Without the
LWS environment the leader starts the N-1 followers itself, on this
host, with its own command line. Under the LWS multi-host contract
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, and
torchrun's LOCAL_RANK for a rank's index on its host) every process is
one rank, tp defaults to the number of processes, the coordinator
address is the group's torch.distributed rendezvous and
`--control-port` (default 5858) the leader's op channel. Rank r serves
on `cuda:<local rank>`, or every local rank on the card `--device
cuda:i` names, or on the CPU, and makes that card its current device.
The collectives run on gloo on the CPU and on NCCL on cards, unless
`--tp-backend` names one: single-host `--tp N --device cuda:i` puts
every rank on one card, which NCCL refuses, so that leader picks gloo
and hands it to its followers; ranks that share a card under the LWS
environment pass `--tp-backend gloo` themselves.
Under tp > 1 the reference's refusals stand, in its words: named
adapters (`--lora-slots`), paged KV, int8 KV and the host prefix tier;
a model whose parameters the sharding rules do not all name exits
naming the parameter; `--task embed` is refused with `--tp` > 1 and
under the multi-host environment.
Performance attribution, on by default as in the reference: every
engine carries a program cost ledger (`--ledger-mode`, default auto:
FLOPs counted at each program's first dispatch on a card, the analytic
model on the CPU; each tp rank keeps its own), served by `GET
/debug/programs` with `--debug-endpoints`; `--profile-dir DIR` enables
`POST /debug/profile?seconds=N` (torch.profiler traces into DIR).
`build_server(argv)` does everything `main` does except block, so a
caller (chip_smoke.py, the tests) drives the same code in process; a
tp group's followers are child processes of that caller, stopped with
the server.

Flags of the reference outside this slice are not defined here
(argparse then names them as unrecognized); values this port does not
serve are refused with a message naming the flag: nothing is silently
ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import torch

log = logging.getLogger("ome.engine.serve")


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
    p.add_argument("--profile-dir", default=None,
                   help="enable POST /debug/profile?seconds=N: on-demand "
                        "torch.profiler traces of the card into this "
                        "directory (no-op off the card; off when unset)")
    p.add_argument("--span-log", default=None, metavar="PATH",
                   help="span-timeline JSONL path (merged into a Perfetto "
                        "timeline by python -m "
                        "ome_tpu_torch.telemetry.export)")
    p.add_argument("--debug-endpoints", action="store_true",
                   help="enable GET /debug/events (flight-recorder ring), "
                        "GET /debug/state (scheduler snapshot) and GET "
                        "/debug/programs (program cost ledger); 403 when "
                        "off")
    p.add_argument("--ledger-mode", default="auto",
                   choices=("auto", "full", "model", "off"),
                   help="program cost ledger: auto = FLOPs counted at "
                        "each program's first dispatch on a card, the "
                        "analytic model elsewhere; full/model force a "
                        "path; off disables capture")
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
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: ranks, one process each "
                        "(default: the LWS group's process count, else "
                        "1)")
    p.add_argument("--control-port", type=int, default=None,
                   help="leader->follower op-replication port for "
                        "multi-host serving (default: engine/multihost "
                        "CONTROL_PORT)")
    p.add_argument("--tp-backend", choices=("nccl", "gloo"), default=None,
                   help="the tp group's collectives backend (default: "
                        "gloo on the CPU and for single-host --tp N "
                        "ranks sharing the card --device cuda:i names, "
                        "else NCCL)")
    p.add_argument("--rank-stats", default=None, metavar="DIR",
                   help="a follower rank writes its counters (ops "
                        "replayed, collectives, kernel launches, peak "
                        "device memory; the device time of the decode "
                        "ops it replays while DIR/window exists) to "
                        "DIR/rank<r>.json when it stops")
    return p


# flags that configure generation, at their defaults: an embeddings
# deployment refuses any other value by name (the reference ignores
# them there)
_GENERATION_ONLY = {"journal": None, "disaggregation_mode": "none",
                    "kv_block": 0, "quantization": "none",
                    "spec_tokens": 0, "steps_per_dispatch": 1,
                    "prefix_cache_host_mb": 0, "lora_slots": None,
                    "tp": 1}


def check_slice(args) -> None:
    """Exit with a message naming the flag that asks for something
    outside this slice of the port."""
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
    if args.tp < 1:
        raise SystemExit(f"--tp {args.tp}: must be >= 1")


def lora_slot_count(args) -> int:
    """--lora-slots, or its default: max(4, named adapters) when any
    are named, else 0."""
    _, named = _adapter_args(args)
    if args.lora_slots is not None:
        return args.lora_slots
    return max(4, len(named)) if named else 0


def check_tp(args) -> None:
    """The reference's refusals under tp > 1, in its words
    (`sharded.tp_refusal`)."""
    from .sharded import tp_refusal
    why = tp_refusal(args.tp, lora_slot_count(args),
                     args.kv_block or args.kv_blocks,
                     args.kv_dtype == "int8", args.prefix_cache_host_mb)
    if why:
        raise SystemExit(why)


def check_group(args, dist) -> None:
    """What a multi-host environment `dist` (multihost.DistContext)
    asks of the flags: tp defaults to its process count (the reference
    spans every chip of the group), and a process is one rank."""
    if dist is None:
        return
    if args.task == "embed":
        # embeddings are stateless single-host programs; a multi-host
        # embed group would leave followers waiting on a control
        # channel the embed leader never opens
        raise SystemExit("--task embed does not support multi-host "
                         "serving (unset JAX_COORDINATOR_ADDRESS or use "
                         "one process)")
    if args.tp <= 1:
        args.tp = dist.num_processes
        log.info("multi-host: tp=%d over %d processes", args.tp,
                 dist.num_processes)
    if args.tp != dist.num_processes:
        raise SystemExit(
            f"--tp {args.tp}: the group has {dist.num_processes} "
            "processes (JAX_NUM_PROCESSES), one tensor-parallel rank each")


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


def check_tp_model(args) -> None:
    """Exit naming --tp when the model's heads do not split over it
    (the reference's divisibility checks), from config.json alone."""
    from ..models import checkpoint
    from .sharded import check_divisible
    try:
        cfg = _load_cfg(args.model_dir, torch.float32) \
            if args.random_weights else checkpoint.load_config(
                args.model_dir)
        check_divisible(cfg, args.tp)
    except ValueError as e:
        raise SystemExit(f"--tp {args.tp}: {e}")
    except (checkpoint.SafetensorsError, FileNotFoundError) as e:
        raise SystemExit(f"--model-dir {args.model_dir}: {e}")


def load_params_cfg(args, device, shard=None):
    """(params, cfg) on `device`: the safetensors checkpoint in
    --model-dir, or random weights from --seed for its config.json. A
    head_dim the CUDA kernels do not take exits before any weight is
    read (MLA models launch none of them: `check_model_head_dim`).
    `shard` = (rank, tp): a tensor-parallel rank's slices only, drawn
    or read slab by slab (`init_params`, `checkpoint.load_params`); a
    parameter the sharding rules do not name exits naming it, and so
    does a tp the model's heads do not divide."""
    from ..models import checkpoint
    from ..models.params import init_params, param_count
    from ..ops.flash import check_model_head_dim
    from ..parallel.sharding import UnshardableLeaf

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
        try:
            params = init_params(cfg, gen, device, shard=shard)
        except (UnshardableLeaf, ValueError) as e:
            if shard is None:
                raise
            raise SystemExit(f"--tp {args.tp}: {e}")
        log.info("initialized random weights: %.2fM params on %s in "
                 "%.1fs%s", param_count(params) / 1e6, device,
                 time.monotonic() - t0,
                 f" (rank {shard[0]} of tp {shard[1]})" if shard else "")
        return params, cfg
    try:
        cfg = checkpoint.load_config(args.model_dir)
        refuse_head_dim(cfg)
        params, cfg = checkpoint.load_params(args.model_dir, cfg=cfg,
                                             dtype=dtype, device=device,
                                             shard=shard)
    except UnshardableLeaf as e:
        raise SystemExit(f"--tp {args.tp}: {e}")
    except (checkpoint.SafetensorsError, NotImplementedError,
            FileNotFoundError, ValueError) as e:
        raise SystemExit(f"--model-dir {args.model_dir}: {e}")
    log.info("loaded checkpoint from %s: %.2fM params on %s in %.1fs",
             args.model_dir, param_count(params) / 1e6, device,
             time.monotonic() - t0)
    merge_dir = _adapter_args(args)[0]
    if merge_dir:
        from ..models.lora import merge_lora
        try:
            merged = merge_lora(params, cfg, merge_dir, shard=shard)
        except (ValueError, OSError, checkpoint.SafetensorsError) as e:
            raise SystemExit(f"--adapter {merge_dir}: {e}")
        log.info("merged %d LoRA deltas from %s", merged, merge_dir)
    return params, cfg


def load_engine(args, rank=None):
    """The engine for `args`: the checkpoint in --model-dir, or random
    weights from --seed. One device: an InferenceEngine on --device.
    `rank` = (mesh.RankInfo, comm.Group) of a tp group: this rank's
    ShardedInferenceEngine on its own device, over its slices."""
    from ..device import resolve_device
    from ..models.quant import quantize_params, quantized_bytes
    from ..parallel import comm
    from ..parallel.sharding import split_contraction
    from ..perf.ledger import ProgramLedger
    from .core import InferenceEngine, PagedKVUnsupported

    info, group = rank if rank is not None else (None, None)
    device = info.device if info is not None else \
        resolve_device(args.device)
    shard = (info.rank, info.tp) if info is not None else None
    params, cfg = load_params_cfg(args, device, shard=shard)
    if cfg.is_moe and shard is None:
        # one device: the ragged grouped-product dispatch, as the
        # reference serves with tp 1 (the dense impl computes every
        # expert for every token); tp > 1 keeps the dense impl
        cfg = cfg.replace(moe_impl="ragged")
    if args.quantization != "none":
        t0 = time.monotonic()
        # leaf by leaf, dropping each bf16 leaf once quantized; a rank
        # takes the scales of a split contraction over the group
        with comm.use(group):
            params = quantize_params(
                params, mode=args.quantization, consume=True,
                split_contraction=split_contraction() if shard else (),
                amax_all=comm.amax)
        log.info("quantized weights to %s (weight-only) in %.1fs: %.2f GB "
                 "of weights", args.quantization, time.monotonic() - t0,
                 quantized_bytes(params) / 1e9)
    max_seq = args.max_seq or min(cfg.max_seq_len, 8192)
    _, named_adapters = _adapter_args(args)
    lora_slots = lora_slot_count(args)
    # the engine's program cost ledger (one per rank under tp)
    ledger = ProgramLedger(mode=args.ledger_mode)
    if info is not None:
        from .sharded import ShardedInferenceEngine
        engine = ShardedInferenceEngine(
            params, cfg, tp=info.tp, group=group,
            max_slots=args.max_slots, max_seq=max_seq,
            prefix_cache_bytes=args.prefix_cache_mb << 20,
            device=device, seed=args.seed, ledger=ledger)
        log.info("rank %d/%d: %d of %d query heads, %d of %d KV heads on "
                 "%s", info.rank, info.tp, engine.cfg.num_heads,
                 cfg.num_heads, engine.cfg.kv_cache_heads,
                 cfg.kv_cache_heads, device)
        return engine
    try:
        engine = InferenceEngine(
            params, cfg, max_slots=args.max_slots, max_seq=max_seq,
            prefix_cache_bytes=args.prefix_cache_mb << 20,
            prefix_host_bytes=args.prefix_cache_host_mb << 20,
            kv_block=args.kv_block, kv_blocks=args.kv_blocks,
            kv_dtype=args.kv_dtype if args.kv_block else None,
            device=device, seed=args.seed, lora_slots=lora_slots,
            lora_rank=args.lora_rank, ledger=ledger)
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


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _loopback(dist) -> None:
    """gloo picks its network interface from the host name; a group
    whose rendezvous is on this host talks over the loopback device."""
    if dist.coordinator_host in ("127.0.0.1", "localhost"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")


class TPGroup:
    """A serving tp group's leader-side handles: its DistContext, its
    rank and comm.Group, the follower processes this leader started
    (single-host `--tp N`), and the op publisher. `close` ends the group
    in order: the stop op, the followers' exit, the collectives."""

    def __init__(self, dist, control_port: int, procs=()):
        self.dist = dist
        self.control_port = control_port
        self.procs = list(procs)
        self.info = None
        self.group = None
        self.publisher = None

    def join(self, device, backend=None) -> None:
        _loopback(self.dist)
        try:
            self.info, self.group = self.dist.join(device, backend)
        except RuntimeError as e:
            raise SystemExit(f"--device {device}: {e}")

    def close(self, timeout: float = 60.0) -> None:
        if self.publisher is not None:
            self.publisher.close()
            self.publisher = None
        for p in self.procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                log.error("follower pid %d did not stop; killing it", p.pid)
                p.kill()
                p.wait()
        if self.procs:
            log.info("followers exited: %s",
                     [p.returncode for p in self.procs])
        if self.group is not None:
            self.group.close()
            self.group = None


def _start_group(args, argv, dist):
    """The leader's TPGroup: under the LWS environment (`dist`), this
    process's place in it; for `--tp N` without it, a group on this
    host whose N-1 followers this process starts now, each `python -m
    ome_tpu_torch.engine.serve` with the same arguments under the
    environment contract. None for tp 1."""
    from . import multihost
    named_card = torch.device(args.device or "cuda").index is not None
    if dist is not None:
        if named_card and args.tp_backend is None:
            log.warning("--device %s under the LWS environment: the "
                        "collectives run on NCCL (a card of this pod's "
                        "own); ranks that share this card need "
                        "--tp-backend gloo", args.device)
        return TPGroup(dist, args.control_port or multihost.CONTROL_PORT)
    if args.tp <= 1:
        return None
    if named_card and args.tp_backend is None:
        # every rank of this host on the one named card: NCCL refuses
        # two ranks on one device
        args.tp_backend = "gloo"
    coordinator = f"127.0.0.1:{_free_port()}"
    control = args.control_port or _free_port()
    dist = multihost.DistContext(coordinator=coordinator,
                                 num_processes=args.tp, process_id=0)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    argv = list(sys.argv[1:] if argv is None else argv)
    procs = []
    for r in range(1, args.tp):
        env = dict(os.environ)
        env.update({multihost.JAX_COORDINATOR_ENV: coordinator,
                    multihost.JAX_NUM_PROCESSES_ENV: str(args.tp),
                    multihost.JAX_PROCESS_ID_ENV: str(r),
                    multihost.LOCAL_RANK_ENV: str(r),
                    "PYTHONPATH": os.pathsep.join(
                        [root] + [x for x in [env.get("PYTHONPATH")]
                                  if x])})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ome_tpu_torch.engine.serve", *argv,
             "--control-port", str(control)]
            + (["--tp-backend", args.tp_backend] if args.tp_backend
               else []), env=env))
    log.info("tp=%d on this host: started follower ranks 1-%d (pids %s), "
             "rendezvous %s, op channel port %d", args.tp, args.tp - 1,
             [p.pid for p in procs], coordinator, control)
    return TPGroup(dist, control, procs)


def serve_follower(args, dist) -> int:
    """A follower rank (JAX_PROCESS_ID > 0): join the group, load this
    rank's engine, then replay the leader's op stream until it stops (0)
    or drops (1). Followers never serve HTTP."""
    from . import multihost
    check_slice(args)
    check_group(args, dist)
    check_tp(args)
    check_tp_model(args)
    grp = TPGroup(dist, args.control_port or multihost.CONTROL_PORT)
    grp.join(args.device, args.tp_backend)
    try:
        with torch.no_grad():
            engine = load_engine(args, rank=(grp.info, grp.group))
        stats = multihost.RankStats(args.rank_stats, grp.info.rank,
                                    grp.group, grp.info.device) \
            if args.rank_stats else None
        sub = multihost.OpSubscriber(dist.coordinator_host,
                                     grp.control_port)
        log.info("follower %d/%d replaying leader ops", dist.process_id,
                 dist.num_processes)
        try:
            return multihost.follower_loop(
                engine, sub,
                pd_export=(args.disaggregation_mode == "prefill"),
                stats=stats)
        finally:
            sub.close()
            if stats is not None:
                log.info("rank stats written to %s", stats.write())
    finally:
        grp.close()


def build_server(argv=None):
    """Everything `main` does short of blocking: parse `argv`, check
    the slice, build engine, scheduler and server, and start serving.
    Returns (server, scheduler, engine); the caller stops the server.
    With tp > 1 this process is the group's leader (rank 0); the group
    ends with the server (`server.on_stop`)."""
    from ..priority import coerce_priority, parse_weight_spec
    from .multihost import init_from_env

    args = build_parser().parse_args(argv)
    check_slice(args)
    dist = init_from_env()
    if dist is not None and not dist.is_leader:
        raise SystemExit(
            f"JAX_PROCESS_ID {dist.process_id}: a follower rank serves no "
            "HTTP; `python -m ome_tpu_torch.engine.serve` replays the "
            "leader's ops there (serve_follower)")
    check_group(args, dist)
    check_tp(args)
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
    if args.task == "embed":
        check_embed_workspace(args.device)
    if args.tp > 1:
        # before any rank starts: heads the tp does not divide
        check_tp_model(args)
    grp = _start_group(args, argv, dist)
    try:
        return _build(args, grp, class_weights, class_wait_caps)
    except BaseException:
        if grp is not None:
            for p in grp.procs:
                p.kill()
            grp.procs = []
            grp.close()
        raise


def _build(args, grp, class_weights, class_wait_caps):
    """build_server's body once the group (or None) is set up."""
    from ..telemetry.flight import FlightRecorder
    from ..telemetry.reqlog import coerce as coerce_reqlog
    from ..telemetry.tracing import SpanLog
    from .journal import RequestJournal
    from .multihost import OpPublisher, ReplicatedEngine
    from .pd import RemotePrefillEngine, make_pd_prefill_handler
    from .scheduler import Scheduler
    from .server import EngineServer
    from .tokenizer import load_tokenizer

    reqlog = coerce_reqlog(args.request_log)
    span_log = SpanLog(args.span_log, component="engine") \
        if args.span_log else None
    pd_prefill = None
    embedder = None

    def engine_of_group():
        # one device, or this rank of the group (the op publisher
        # opens once every follower has loaded and connected)
        if grp is None:
            return load_engine(args)
        grp.join(args.device, args.tp_backend)
        with torch.no_grad():
            eng = load_engine(args, rank=(grp.info, grp.group))
        grp.publisher = OpPublisher(grp.dist.num_processes - 1,
                                    port=grp.control_port)
        return eng

    def replicated(eng):
        # a group's leader publishes every op before it runs it
        return eng if grp is None else ReplicatedEngine(eng, grp.publisher)

    if args.task == "embed":
        # stateless: no decode loop, completions are refused
        embedder = load_embedder(args)
        scheduler = _NullScheduler()
    elif args.disaggregation_mode == "prefill":
        # a group's /pd/prefill runs on every rank through the same op
        # replication; the followers join the KV's gather
        engine = replicated(engine_of_group())
        pd_prefill = make_pd_prefill_handler(engine)
        scheduler = _PrefillNodeScheduler(engine)
    else:
        engine = engine_of_group()
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
        if grp is not None:
            # the scheduler publishes ops from ONE thread in execution
            # order (followers replay strictly sequentially)
            engine = replicated(engine)
        elif args.prefix_cache_mb > 0 and \
                args.disaggregation_mode == "none":
            # a replica with a prefix cache is also a prefix DONOR: peers
            # fetch hot prefix KV over the same /pd/prefill path (one
            # device only, as the reference's donor is single-host)
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
        scheduler = Scheduler(engine, overlap=grp is None,
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
    # measured weight-fetch throughput from the published fetch
    # manifest, advertised on /ready for the router's cold-start
    # Retry-After math; 0.0 for a tree the weight plane did not publish
    from ..modelagent import weightplane
    server = EngineServer(scheduler, tokenizer=load_tokenizer(
                              args.model_dir),
                          model_name=name,
                          fetch_bps=weightplane.published_fetch_bps(
                              args.model_dir),
                          host=args.host, port=args.port,
                          request_log=reqlog, pd_prefill=pd_prefill,
                          embedder=embedder, structured=embedder is None,
                          profile_dir=args.profile_dir,
                          debug_endpoints=args.debug_endpoints)
    if grp is not None:
        # a follower that drops its control channel fails the group: the
        # leader turns unhealthy at once (its /health answers 503)
        def lost(why, scheduler=scheduler):
            log.error("tp group lost a rank (%s); marking unhealthy", why)
            scheduler.healthy = False
        grp.publisher.on_lost = lost
        if grp.publisher.lost is not None:
            lost(grp.publisher.lost)
        server.on_stop.append(grp.close)
    if embedder is not None:
        log.info("serving embeddings of %s on %s:%d (device=%s buckets=%s)",
                 name, args.host, server.port, embedder.device,
                 embedder.buckets)
        server.start()
        return server, scheduler, embedder
    log.info("serving %s on %s:%d (device=%s slots=%d max_seq=%d "
             "kv_block=%d kv_dtype=%s quantization=%s spec_tokens=%d "
             "steps_per_dispatch=%d prefix_cache_host_mb=%d "
             "disaggregation_mode=%s tp=%d)", name, args.host, server.port,
             engine.device, engine.max_slots, engine.max_seq,
             engine.kv_block, args.kv_dtype if engine.kv_block else "-",
             args.quantization, args.spec_tokens,
             args.steps_per_dispatch, args.prefix_cache_host_mb,
             args.disaggregation_mode, args.tp)
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
    from .multihost import init_from_env
    dist = init_from_env()
    if dist is not None and not dist.is_leader:
        # followers never serve HTTP: they join the group, then replay
        # the leader's op stream
        return serve_follower(args, dist)
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
