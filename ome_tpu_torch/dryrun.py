"""Entry points of the port (counterpart of __graft_entry__.py).

  entry()               -> (fn, example_args): the forward step on the
                           flagship Llama-class model, on one device.
  dryrun_multichip(n)   -> one training step of `tiny_test(moe=True)`
                           over n ranks on `MeshConfig.auto(n)` (dp, pp,
                           tp and the MoE's experts under tp), then the
                           tp-sharded serving engine's prefill -> insert
                           -> decode, then the leader / follower op
                           stream replayed (the LWS multi-host
                           contract); rank 0's three lines are printed,
                           in the reference's words.

The reference compiles over n virtual CPU devices of one process; the
port spawns n rank processes joined in a torch.distributed group (gloo
on the CPU; on the card NCCL when there is a card per rank, gloo for
ranks that share one).

    python -m ome_tpu_torch.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading

import torch

SEQ = 64
NUM_MICROBATCHES = 4


def entry(device="cuda"):
    """The forward step on the flagship model (one device)."""
    from .models import config as cfgs
    from .models import llama
    from .models.params import init_params
    cfg = cfgs.tiny_test().replace(
        vocab_size=2048, hidden_size=512, num_layers=8, num_heads=8,
        num_kv_heads=4, head_dim=64, intermediate_size=1024, max_seq_len=512)
    device = torch.device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    tokens = torch.ones((2, 128), dtype=torch.int32, device=device)

    def fn(params, tokens):
        logits, _ = llama.forward(params, cfg, tokens)
        return logits

    return fn, (params, tokens)


def _rank_device(device: str, rank: int, n: int):
    """(device, backend) of rank `rank` of n: the CPU over gloo; a card
    per rank over NCCL where there are n cards, else every rank on
    cuda:0 over gloo (NCCL refuses two ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    count = torch.cuda.device_count()
    if count >= n:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def _rank(rank: int, n: int, port_q, device: str, q) -> None:
    try:
        q.put((rank, "ok", run_rank(rank, n, port_q, device)))
    except Exception:  # noqa: BLE001 — the parent reports it
        import traceback
        q.put((rank, "error", traceback.format_exc()))


def run_rank(rank: int, n: int, port_q, device: str):
    """One rank of `dryrun_multichip`; returns the lines it prints (rank
    0's are the reference's). Rank 0 binds the group's store on a port
    the kernel picks and hands it to the other ranks through `port_q`;
    the control channel's port travels through the store."""
    import numpy as np

    from .engine import multihost
    from .engine.sharded import ShardedInferenceEngine
    from .models import config as cfgs
    from .models.params import init_params
    from .parallel import comm
    from .parallel.mesh import MeshConfig
    from .train import step as train_step_lib

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dev, backend = _rank_device(device, rank, n)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank == 0:
        store = comm.Group.host_store("127.0.0.1", n, timeout=300)
        for _ in range(n - 1):
            port_q.put(store.port)
        world = comm.Group.init(f"127.0.0.1:{store.port}", rank, n,
                                backend, timeout=300, store=store)
    else:
        world = comm.Group.init(f"127.0.0.1:{port_q.get(timeout=300)}",
                                rank, n, backend, timeout=300)
    lines = []
    try:
        # MoE flagship config, so tp, pp, dp and the experts under tp are
        # all real
        cfg = cfgs.tiny_test(moe=True)
        mesh_cfg = MeshConfig.auto(n, num_layers=cfg.num_layers)
        assert mesh_cfg.size == n, (mesh_cfg, n)
        batch = NUM_MICROBATCHES * 2 * mesh_cfg.dp
        step, init_state = train_step_lib.make_train_step(
            cfg, mesh_cfg, NUM_MICROBATCHES,
            group=world if n > 1 else None, device=dev)
        params, opt_state = init_state(seed=0)
        tokens = torch.zeros((batch, SEQ), dtype=torch.int32)
        targets = torch.zeros((batch, SEQ), dtype=torch.int32)
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        lines.append(f"dryrun_multichip(n={n}): mesh=(dp={mesh_cfg.dp}, "
                     f"pp={mesh_cfg.pp}, tp={mesh_cfg.tp}) "
                     f"loss={float(loss):.4f}")
        del params, opt_state, step

        # serving: the tp-sharded engine (weights Megatron-split, KV cache
        # split on the heads) runs prefill -> insert -> decode
        serve_cfg = cfgs.tiny_test()
        tp = max(d for d in range(1, serve_cfg.num_kv_heads + 1)
                 if serve_cfg.num_kv_heads % d == 0 and d <= n)
        if rank >= tp:
            return lines
        group = world if tp == n else (
            train_step_lib._subgroup(world, "serve", rank, tp)
            if tp > 1 else None)

        def engine():
            gen = torch.Generator(device=dev).manual_seed(0)
            part = init_params(serve_cfg, gen, dev, shard=(rank, tp))
            return ShardedInferenceEngine(part, serve_cfg, tp=tp,
                                          group=group, rank=rank,
                                          max_slots=2, max_seq=32,
                                          device=dev)
        sampling = (np.zeros(2, np.float32), np.zeros(2, np.int32),
                    np.ones(2, np.float32))
        eng = engine()
        state = eng.new_state()
        tok, kv, true_len, bucket = eng.prefill([1, 2, 3, 4, 5])
        state = eng.insert(state, kv, 0, true_len, tok, bucket)
        state, toks = eng.decode(state, *sampling)
        lines.append(f"dryrun_multichip serving: tp={tp} sharded decode ok "
                     f"(token={int(np.asarray(toks)[0])})")

        # multi-host op replication (engine/multihost.py): the leader
        # publishes its prefill / insert / decode stream over the control
        # channel and its followers replay it — the tp group's other
        # ranks, or at tp 1 a follower engine on a thread of this process
        # (the reference's in-process analog)
        if rank > 0:
            ctrl = int(world.store.get("dryrun_ctrl_port"))
            sub = multihost.OpSubscriber("127.0.0.1", port=ctrl)
            rc = multihost.follower_loop(eng, sub)
            sub.close()
            if rc != 0:
                raise RuntimeError(f"follower rank {rank} exited {rc}")
            return lines
        # bound on a port the kernel picks before the followers are told
        # it, so no other process can take it in between
        ctrl_server = socket.create_server(("127.0.0.1", 0))
        ctrl = ctrl_server.getsockname()[1]
        world.store.set("dryrun_ctrl_port", str(ctrl))
        follower_rc = []
        thread = None
        if tp == 1:
            follower = engine()

            def run_follower():
                sub = multihost.OpSubscriber("127.0.0.1", port=ctrl)
                follower_rc.append(multihost.follower_loop(follower, sub))
                sub.close()
            thread = threading.Thread(target=run_follower, daemon=True)
            thread.start()
        pub = multihost.OpPublisher(max(tp - 1, 1), server=ctrl_server)
        leader = multihost.ReplicatedEngine(eng, pub)
        lstate = leader.new_state()
        ltok, lkv, ltl, lb = leader.prefill([1, 2, 3, 4, 5])
        lstate = leader.insert(lstate, lkv, 0, ltl, ltok, lb)
        lstate, ltoks = leader.decode(lstate, *sampling)
        pub.close()
        if thread is not None:
            thread.join(timeout=60)
            if follower_rc != [0]:
                raise RuntimeError(f"the follower engine exited "
                                   f"{follower_rc or 'not at all'}")
        lines.append(f"dryrun_multichip multihost: leader op stream "
                     f"replayed by follower engine "
                     f"(token={int(np.asarray(ltoks)[0])})")
        return lines
    finally:
        world.close()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> None:
    """One sharded training step and the serving checks over n ranks,
    each a process of its own; prints rank 0's lines."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q, port_q = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank,
                         args=(r, n_devices, port_q, device, q))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    try:
        got = {r: (status, res) for r, status, res in
               (q.get(timeout=timeout) for _ in procs)}
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in range(n_devices):
        status, res = got[r]
        if status != "ok":
            raise RuntimeError(f"dryrun rank {r} failed:\n{res}")
    for line in got[0][1]:
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ome_tpu_torch.dryrun",
        description="one sharded training step and the tp serving checks "
                    "over N rank processes")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks (default: the cards here, else 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n = args.n
    if n is None:
        n = torch.cuda.device_count() if args.device != "cpu" else 1
        n = max(n, 1)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
