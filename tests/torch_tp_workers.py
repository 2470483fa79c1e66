"""Rank processes of the port's tensor-parallel CPU tests.

Each function runs in a process of its own (`run_group`: spawned with
multiprocessing, one per rank, a gloo group over the loopback device)
and returns a picklable result; the test compares the ranks' results
with the JAX package's, which it computes itself. Nothing here imports
JAX: the trees arrive as numpy arrays.
"""

import os
import socket

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, size, port, fn, args, q):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    torch.set_num_threads(1)
    from ome_tpu_torch.parallel import comm
    group = comm.Group.init(f"127.0.0.1:{port}", rank, size, "gloo",
                            timeout=120)
    try:
        q.put((rank, "ok", fn(group, *args)))
    except BaseException:  # noqa: BLE001 — the test shows the traceback
        import traceback
        q.put((rank, "error", traceback.format_exc()))
    finally:
        group.close()


def run_group(fn, *args, size: int = 2, timeout: float = 240.0):
    """[rank 0's result, rank 1's, ...] of `fn(group, *args)` run in
    `size` spawned rank processes."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, size, port, fn, args, q))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        got = dict((r, (status, res)) for r, status, res in
                   (q.get(timeout=timeout) for _ in procs))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in range(size):
        status, res = got[r]
        assert status == "ok", f"rank {r}:\n{res}"
    return [got[r][1] for r in range(size)]


def greedy(engine, prompts, steps, sampling=None):
    """Streams of `prompts` through prefill/insert and `steps - 1`
    decode steps of the engine API (greedy unless `sampling`, a
    (temperature, top_k, top_p) of per-slot arrays)."""
    B = engine.max_slots
    if sampling is None:
        sampling = (np.zeros(B, np.float32), np.zeros(B, np.int32),
                    np.ones(B, np.float32))
    state = engine.new_state()
    out = []
    for slot, ids in enumerate(prompts):
        tok, kv, n, bucket = engine.prefill(ids, float(sampling[0][slot]),
                                            int(sampling[1][slot]),
                                            float(sampling[2][slot]))
        state = engine.insert(state, kv, slot, n, tok, bucket)
        out.append([int(tok)])
    for _ in range(steps - 1):
        state, toks = engine.decode(state, *sampling)
        for slot, t in enumerate(np.asarray(toks)[:len(prompts)]):
            out[slot].append(int(t))
    return out


def rank_params(group, tree):
    """This rank's slices of the whole numpy tree, on the CPU."""
    from ome_tpu_torch.models.params import from_jax_params
    from ome_tpu_torch.parallel.sharding import shard_params
    return shard_params(from_jax_params(tree, "cpu"), group.rank,
                        group.size)


def engine_streams(group, tree, cfg, prompts, steps, engine_kw,
                   sampling=None):
    """This rank's greedy (or sampled) streams through a tp
    ShardedInferenceEngine over its slices of the whole numpy tree."""
    from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
    eng = ShardedInferenceEngine(rank_params(group, tree), cfg,
                                 tp=group.size, group=group, device="cpu",
                                 **engine_kw)
    return {"streams": greedy(eng, prompts, steps, sampling),
            "kv_shape": tuple(eng.new_state().k.shape),
            "collectives": group.calls}


def forward_logits(group, tree, cfg, tokens):
    """This rank's logits of a whole-sequence forward over its slices."""
    import torch

    from ome_tpu_torch.engine.sharded import local_config
    from ome_tpu_torch.models import llama
    from ome_tpu_torch.parallel import comm
    part = rank_params(group, tree)
    with comm.use(group), torch.no_grad():
        logits, _ = llama.forward(part, local_config(cfg, group.size),
                                  torch.from_numpy(tokens))
    return logits.numpy()


def quantized_slices(group, cfg, mode):
    """Whether this rank's slices quantized with the scales' max over
    the group (`split_contraction`) equal its slices of the whole tree
    quantized: {leaf: equal}."""
    import torch

    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.models.quant import QTensor, quantize_params
    from ome_tpu_torch.parallel import comm
    from ome_tpu_torch.parallel.sharding import (shard_params,
                                                 split_contraction)
    gen = torch.Generator()
    gen.manual_seed(9)
    whole = init_params(cfg, gen, "cpu")
    ref = shard_params(quantize_params(whole, mode=mode), group.rank,
                       group.size)
    with comm.use(group):
        got = quantize_params(shard_params(whole, group.rank, group.size),
                              mode=mode,
                              split_contraction=split_contraction(),
                              amax_all=comm.amax)
    out = {}
    for k, v in ref["layers"].items():
        g = got["layers"][k]
        if isinstance(v, QTensor):
            out[k] = bool(torch.equal(g.q.view(torch.uint8)
                                      if g.q.dtype == torch.float8_e4m3fn
                                      else g.q,
                                      v.q.view(torch.uint8)
                                      if v.q.dtype == torch.float8_e4m3fn
                                      else v.q)
                          and torch.equal(g.s, v.s))
    return out


def int4_streams(group, cfg, seed, prompts, steps, engine_kw):
    """This rank's greedy streams over its int4 slices (drawn whole from
    `seed`, sliced, then quantized as serve's load does: the split
    contractions' scales over the group), and the packed leaves'
    (K/2, N) of every int4 product `_proj` sent through `int4_matmul`
    (B4's wrapper; its plain version on the CPU)."""
    import torch

    from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
    from ome_tpu_torch.models import llama
    from ome_tpu_torch.models.params import init_params
    from ome_tpu_torch.models.quant import quantize_params
    from ome_tpu_torch.parallel import comm
    from ome_tpu_torch.parallel.sharding import (shard_params,
                                                 split_contraction)
    gen = torch.Generator()
    gen.manual_seed(seed)
    part = shard_params(init_params(cfg, gen, "cpu"), group.rank,
                        group.size)
    with comm.use(group):
        part = quantize_params(part, mode="int4",
                               split_contraction=split_contraction(),
                               amax_all=comm.amax)
    shapes = set()
    kernel = llama.int4_matmul

    def counted(x, w, dtype):
        shapes.add(tuple(w.q.shape[-2:]))
        return kernel(x, w, dtype)
    llama.int4_matmul = counted
    try:
        eng = ShardedInferenceEngine(part, cfg, tp=group.size, group=group,
                                     device="cpu", **engine_kw)
        streams = greedy(eng, prompts, steps)
    finally:
        llama.int4_matmul = kernel
    return {"streams": streams, "int4_shapes": sorted(shapes)}


def run_spec(engine) -> list:
    """tests/multihost_driver.py's `run_spec` over the port's Scheduler:
    speculative verify (a repetitive prompt, so the n-gram drafter
    drafts) x multi-token chunks x one-step pipelining, greedy."""
    from ome_tpu_torch.engine.scheduler import Request, Scheduler
    from ome_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    sched = Scheduler(engine, spec_tokens=2, steps_per_dispatch=2,
                      pipeline_depth=1)
    assert sched.spec_tokens == 2 and sched.steps_per_dispatch == 2
    reqs = [
        Request(prompt_ids=tok.encode("ababababab"),
                max_new_tokens=12, temperature=0.0, stop_ids=[]),
        Request(prompt_ids=tok.encode("xyzxyzxyz"),
                max_new_tokens=10, temperature=0.0, stop_ids=[]),
    ]
    for r in reqs:
        sched.submit(r)
    for _ in range(400):
        if all(r.done.is_set() for r in reqs):
            break
        sched.step()
    assert all(r.done.is_set() for r in reqs)
    return [list(r.output_ids) for r in reqs]


class TokenLog:
    """A rank's engine, recording the tokens every op sampled, in op
    order (a follower's must equal its leader's)."""

    def __init__(self, engine):
        self.engine = engine
        self.log = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def prefill(self, *a, **kw):
        out = self.engine.prefill(*a, **kw)
        self.log.append(int(out[0]))
        return out

    def decode(self, *a, **kw):
        state, toks = self.engine.decode(*a, **kw)
        self.log.append(np.asarray(toks).tolist())
        return state, toks

    def decode_multi(self, *a, **kw):
        state, toks, adv = self.engine.decode_multi(*a, **kw)
        self.log.append([np.asarray(toks).tolist(),
                         np.asarray(adv).tolist()])
        return state, toks, adv

    def verify(self, *a, **kw):
        state, out, acc = self.engine.verify(*a, **kw)
        self.log.append([np.asarray(out).tolist(),
                         np.asarray(acc).tolist()])
        return state, out, acc


def replicated(group, tree, cfg, ctrl_port):
    """A leader (rank 0) and its followers over the control channel:
    the leader drives multihost_driver's `run_script`, `run_spec` and
    sampled steps (temperature 0.8, top-k 20, top-p 0.9) through a
    ReplicatedEngine and returns their streams and its token log; a
    follower returns follower_loop's exit code and its token log."""
    from ome_tpu_torch.engine import multihost
    from ome_tpu_torch.engine.sharded import ShardedInferenceEngine
    eng = TokenLog(ShardedInferenceEngine(
        rank_params(group, tree), cfg, tp=group.size, group=group,
        max_slots=2, max_seq=64, prefill_buckets=[16], device="cpu"))
    if group.rank == 0:
        from tests.multihost_driver import run_script
        pub = multihost.OpPublisher(group.size - 1, port=ctrl_port,
                                    host="127.0.0.1")
        reng = multihost.ReplicatedEngine(eng, pub)
        out = {"script": run_script(reng), "spec": run_spec(reng),
               "sampled": greedy(reng, [[3, 1, 4, 1, 5], [9, 2, 6]], 8,
                                 (np.full(2, 0.8, np.float32),
                                  np.full(2, 20, np.int32),
                                  np.full(2, 0.9, np.float32)))}
        pub.close()
        return {**out, "log": eng.log}
    sub = multihost.OpSubscriber("127.0.0.1", ctrl_port)
    try:
        return {"rc": multihost.follower_loop(eng, sub), "log": eng.log}
    finally:
        sub.close()


def bf16_last_logits(group, tree, cfg, tokens):
    """This rank's last-row logits (as float32) of a whole-sequence
    forward over its slices of the whole numpy tree cast to bfloat16,
    with `cfg` in bfloat16."""
    import torch

    from ome_tpu_torch.engine.sharded import local_config
    from ome_tpu_torch.models import llama
    from ome_tpu_torch.models.params import from_jax_params
    from ome_tpu_torch.parallel import comm
    from ome_tpu_torch.parallel.sharding import shard_params

    def bf16(t):
        return {k: bf16(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(torch.bfloat16)
    part = shard_params(bf16(from_jax_params(tree, "cpu")), group.rank,
                        group.size)
    with comm.use(group), torch.no_grad():
        logits, _ = llama.forward(part, local_config(cfg, group.size),
                                  torch.from_numpy(tokens))
    return logits[:, -1].float().numpy()
