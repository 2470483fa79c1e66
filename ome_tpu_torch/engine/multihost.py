"""Multi-host serving: the LWS rendezvous + op replication (port of
ome_tpu/engine/multihost.py).

Honors the LWS contract the operator stamps out
(controllers/reconcilers/multinode.py): every pod in the group gets
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID. The port
runs one process per tensor-parallel rank, so the contract maps onto a
torch.distributed group: process p is global rank p, the coordinator
address is the group's TCP rendezvous (rank 0 hosts the store there),
and tp defaults to the number of processes. `LOCAL_RANK` (torchrun's
name; default 0) is a process's index on its own host, which picks its
card (`parallel/mesh.py`).

  * The collectives of the model (`parallel/comm.py`) need every rank to
    run the SAME ops in the SAME order. Only the leader (rank 0) sees
    HTTP traffic, so the leader REPLICATES its op stream (prefill /
    insert / decode / decode_multi / verify / commit_spec / free_slot /
    mask rows / adapters, with their host arguments) to the followers
    over a TCP control channel, and the followers replay it. Tensors
    never cross the channel: each rank computes its own part, and the
    collectives inside each op join the parts. The wire format is the
    reference's, byte for byte (a 4-byte little-endian length, then a
    JSON object).
  * Worker loss fails FAST: a dropped control socket ends the group (a
    follower exits 1; the leader's publisher notices a follower's EOF
    and `on_lost` marks the leader unhealthy), and the LeaderWorkerSet
    recreates the group.

`serve --tp N` on one host is the same machinery: the leader starts N-1
follower processes of its own command line under this environment.

The reference's `host_value` (a multi-host-safe device fetch) has no
counterpart: every tensor of a rank is its own, and the engine's
TokenHandles read back as they do on one device.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("ome.engine.multihost")

# the LWS contract's variables (ome_tpu/constants.py)
JAX_COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
JAX_NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
JAX_PROCESS_ID_ENV = "JAX_PROCESS_ID"
LOCAL_RANK_ENV = "LOCAL_RANK"

# leader's op-replication channel; distinct from the rendezvous port
CONTROL_PORT = 5858


@dataclasses.dataclass(frozen=True)
class DistContext:
    coordinator: str          # host:port of the group's rendezvous
    num_processes: int
    process_id: int
    local_rank: int = 0       # index among the ranks on this host

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @property
    def coordinator_host(self) -> str:
        return self.coordinator.rsplit(":", 1)[0]

    def join(self, device=None, backend: Optional[str] = None,
             timeout: float = 600.0):
        """Join the group's torch.distributed rendezvous at the
        coordinator address: (RankInfo, comm.Group). `device` is
        serve's --device: the rank takes `cuda:<local rank>`, or the
        named card, or the CPU, and makes its card the process's
        current device (the kernels' launches and cuBLAS go to the
        current device). `backend`: serve's --tp-backend, or None for
        `mesh.choose_backend` (gloo on the CPU, NCCL on cards)."""
        from ..parallel import comm, mesh
        info = mesh.describe(self.num_processes, self.process_id,
                             self.local_rank, device, backend)
        if info.device.type == "cuda":
            torch.cuda.set_device(info.device)
        log.info("rank %d/%d (local %d) on %s, collectives on %s",
                 info.rank, info.tp, info.local_rank, info.device,
                 info.backend)
        group = comm.Group.init(self.coordinator, info.rank, info.tp,
                                info.backend, device=info.device,
                                timeout=timeout)
        return info, group


def init_from_env(env=None) -> Optional[DistContext]:
    """The group this process belongs to, when the operator injected
    the LWS contract; None (single-host mode) when
    JAX_COORDINATOR_ADDRESS is absent or the group has one process.
    Nothing is joined here (`DistContext.join` does it): unlike
    jax.distributed, a torch.distributed group can form after the
    process has touched its device."""
    env = env if env is not None else os.environ
    coord = env.get(JAX_COORDINATOR_ENV)
    if not coord:
        return None
    num = int(env.get(JAX_NUM_PROCESSES_ENV, "1"))
    pid = int(env.get(JAX_PROCESS_ID_ENV, "0"))
    if num <= 1:
        return None
    return DistContext(coordinator=coord, num_processes=num,
                       process_id=pid,
                       local_rank=int(env.get(LOCAL_RANK_ENV, "0") or 0))


# -- control channel -------------------------------------------------------


def _send_msg(sock: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class OpPublisher:
    """Leader side: accepts every follower, then fans ops out in order.

    TCP per-connection ordering + one sender at a time (the
    ReplicatedEngine's op lock) gives all followers the identical op
    sequence. A send failure means a follower died — the caller (the
    scheduler step) propagates. A watcher thread per follower also
    reads its socket (followers never send): EOF means the follower is
    gone, and `on_lost` runs at once (serve marks the leader unhealthy,
    so the LWS group restarts together even while no request is in
    flight)."""

    def __init__(self, n_followers: int, port: int = CONTROL_PORT,
                 host: str = "0.0.0.0", accept_timeout: float = 600.0,
                 on_lost: Optional[Callable[[str], None]] = None,
                 server: Optional[socket.socket] = None):
        # `server`: a listening socket the caller bound already (on port
        # 0, its port told to the followers before they connect), in
        # place of one bound here at host:port
        self._server = server or socket.create_server((host, port))
        self._server.settimeout(accept_timeout)
        self._socks: List[socket.socket] = []
        self.on_lost = on_lost
        self.lost: Optional[str] = None
        self._closing = False
        for _ in range(n_followers):
            conn, addr = self._server.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(conn)
            log.info("follower joined from %s (%d/%d)", addr,
                     len(self._socks), n_followers)
        for i, conn in enumerate(self._socks):
            threading.Thread(target=self._watch, args=(i, conn),
                             name=f"follower-watch-{i}",
                             daemon=True).start()

    def _watch(self, i: int, conn: socket.socket) -> None:
        try:
            while conn.recv(4096):
                pass
        except OSError:
            pass
        if self._closing:
            return
        self.lost = f"follower {i + 1} dropped its control channel"
        log.error("%s; the group must restart", self.lost)
        if self.on_lost is not None:
            self.on_lost(self.lost)

    def send(self, msg: dict) -> None:
        if self.lost is not None:
            raise ConnectionError(self.lost)
        for sock in self._socks:
            _send_msg(sock, msg)

    def close(self) -> None:
        self._closing = True
        try:
            self.send({"op": "stop"})
        except OSError:
            pass
        for s in self._socks:
            s.close()
        self._server.close()


class OpSubscriber:
    """Follower side: connect (with retry — the leader may still be
    loading weights) and stream ops."""

    def __init__(self, host: str, port: int = CONTROL_PORT,
                 connect_timeout: float = 600.0):
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=10)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)

    def recv(self) -> Optional[dict]:
        return _recv_msg(self._sock)

    def close(self) -> None:
        self._sock.close()


# -- leader / follower engine drivers --------------------------------------


class ReplicatedEngine:
    """Wraps an engine so every device-touching op is published to the
    followers before the leader runs it. Drop-in for the Scheduler: the
    same prefill/insert/decode surface.

    All ops publish AND execute under one lock: the scheduler thread
    drives prefill/insert/decode, but adapter registration arrives on
    an HTTP handler thread — without the lock, two sendall()s could
    interleave framed bytes, or the leader could run an op's
    collectives at a different op-stream position than its followers
    (a rank waiting forever in a collective no other rank joins)."""

    # multi-token decode IS in the replicated op vocabulary:
    # decode_multi / verify / commit_spec publish before executing, so
    # every plan kind the scheduler can build replays identically
    supports_multi_step = True
    # the scheduler must not fetch prefix KV from a peer replica: the
    # followers could not follow a fetch only the leader made
    replicated = True

    def __init__(self, engine, publisher: OpPublisher):
        self._engine = engine
        self._pub = publisher
        self._oplock = threading.Lock()
        self._wire_cache: dict = {}
        self.supports_multi_step = bool(
            callable(getattr(engine, "decode_multi", None))
            and getattr(engine, "supports_multi_step", True))

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _host(self, x, dtype) -> list:
        """A sampling/plan argument as a host list for the op: a host
        array as it is, a device tensor of the scheduler's cache read
        back once per tensor object (the scheduler re-uploads its
        sampling params and stop table only on a slot change), not every
        step."""
        if not isinstance(x, torch.Tensor):
            return np.asarray(x, dtype).tolist()
        hit = self._wire_cache.get(id(x))
        if hit is None or hit[0] is not x:
            if len(self._wire_cache) > 16:
                self._wire_cache.clear()
            hit = self._wire_cache[id(x)] = (
                x, np.asarray(x.cpu().numpy(), dtype).tolist())
        return hit[1]

    def new_state(self):
        return self._engine.new_state()

    def prefill(self, prompt_ids, temperature: float = 0.0,
                top_k: int = 0, top_p: float = 1.0, first_mask=None,
                adapter=None, deadline=None, trace=None, priority=None):
        from .structured import pack_mask
        kw = {}
        if first_mask is not None:
            kw["first_mask"] = first_mask
        if adapter is not None:
            kw["adapter"] = adapter
        with self._oplock:
            blob_fn = getattr(self._engine, "prefill_blob", None)
            if blob_fn is not None:
                # PD decode group: the leader fetches the KV wire blob
                # ONCE and ships the bytes to followers — a follower
                # re-fetching could draw a different sampled token on
                # the prefill node. deadline/trace/priority stay
                # leader-side, forwarded only when set
                for key, val in (("deadline", deadline), ("trace", trace),
                                 ("priority", priority)):
                    if val is not None:
                        kw[key] = val
                blob = blob_fn(prompt_ids, temperature, top_k, top_p,
                               **kw)
                self._pub.send({"op": "prefill_blob",
                                "blob": base64.b64encode(blob).decode()})
                from .pd import deserialize_kv
                token, k, v, true_len, bucket = deserialize_kv(blob)
                return token, (k, v), true_len, bucket
            self._pub.send({"op": "prefill",
                            "ids": list(map(int, prompt_ids)),
                            "temperature": float(temperature),
                            "top_k": int(top_k), "top_p": float(top_p),
                            "first_mask": pack_mask(first_mask),
                            "adapter": adapter})
            return self._engine.prefill(prompt_ids, temperature, top_k,
                                        top_p, **kw)

    def insert(self, state, kv, slot: int, true_len: int, token: int,
               bucket: int, adapter=None):
        with self._oplock:
            self._pub.send({"op": "insert", "slot": int(slot),
                            "true_len": int(true_len),
                            "token": int(token),
                            "bucket": int(bucket), "adapter": adapter})
            kw = {} if adapter is None else {"adapter": adapter}
            return self._engine.insert(state, kv, slot, true_len,
                                       token, bucket, **kw)

    def register_adapter(self, name: str, adapter_dir: str) -> int:
        """Replicated hot adapter load: the staged dir must exist on
        every host. Local call FIRST: if it raises (bad dir, no free
        slot), no op is published and followers stay consistent."""
        with self._oplock:
            idx = self._engine.register_adapter(name, adapter_dir)
            self._pub.send({"op": "register_adapter", "name": name,
                            "path": adapter_dir})
            return idx

    def unregister_adapter(self, name: str) -> None:
        with self._oplock:
            # local first: an in-flight-adapter refusal must not reach
            # followers — their slot refs clear via the free_slot op
            self._engine.unregister_adapter(name)
            self._pub.send({"op": "unregister_adapter", "name": name})

    def free_slot(self, slot: int) -> None:
        """Replicated slot release (adapter refs + paged KV blocks)."""
        with self._oplock:
            self._pub.send({"op": "free_slot", "slot": int(slot)})
            self._engine.free_slot(slot)

    def set_mask_row(self, row: int, bits) -> None:
        """Replicated grammar mask-table upload: followers install the
        IDENTICAL row before any plan references its index (op-stream
        order)."""
        from .structured import pack_mask
        with self._oplock:
            self._pub.send({"op": "set_mask_row", "row": int(row),
                            "bits": pack_mask(np.asarray(bits, bool))})
            self._engine.set_mask_row(row, bits)

    def decode(self, state, temperature, top_k, top_p, mask=None,
               mask_idx=None):
        from .structured import pack_mask
        midx = None if mask_idx is None \
            else np.asarray(mask_idx, np.int32).tolist()
        with self._oplock:
            self._pub.send({"op": "decode",
                            "mask_idx": midx,
                            "temperature": self._host(temperature,
                                                      np.float32),
                            "top_k": self._host(top_k, np.int32),
                            "top_p": self._host(top_p, np.float32),
                            # the leader's host-built mask ships in the
                            # op so followers run the identical masked
                            # step
                            "mask": pack_mask(mask)})
            if mask_idx is not None:
                return self._engine.decode(state, temperature, top_k,
                                           top_p, mask_idx=mask_idx)
            if mask is not None:
                return self._engine.decode(state, temperature, top_k,
                                           top_p, mask=mask)
            return self._engine.decode(state, temperature, top_k, top_p)

    def decode_multi(self, state, temperature, top_k, top_p,
                     steps: int, budget, stop_ids,
                     lookahead_rows=None, mask=None, mask_idx=None):
        """Replicated multi-token chunk: the whole StepPlan payload
        ships in the op, so followers run the IDENTICAL K-step loop."""
        from .structured import pack_mask
        midx = None if mask_idx is None \
            else np.asarray(mask_idx, np.int32).tolist()
        with self._oplock:
            self._pub.send({"op": "decode_multi",
                            "steps": int(steps),
                            "mask_idx": midx,
                            "temperature": self._host(temperature,
                                                      np.float32),
                            "top_k": self._host(top_k, np.int32),
                            "top_p": self._host(top_p, np.float32),
                            "budget": self._host(budget, np.int32),
                            "stop_ids": self._host(stop_ids, np.int32),
                            "lookahead_rows": None
                            if lookahead_rows is None
                            else int(lookahead_rows),
                            "mask": pack_mask(mask)})
            kw = {}
            if lookahead_rows is not None:
                kw["lookahead_rows"] = lookahead_rows
            if mask_idx is not None:
                kw["mask_idx"] = mask_idx
            elif mask is not None:
                kw["mask"] = mask
            return self._engine.decode_multi(
                state, temperature, top_k, top_p, steps=steps,
                budget=budget, stop_ids=stop_ids, **kw)

    def verify(self, state, drafts, draft_len, temperature, top_k,
               top_p, lookahead_rows=None, mask=None, mask_idx=None):
        """Replicated spec-verify: the leader's host-built drafts ship
        in the op — followers never run the drafter."""
        from .structured import pack_mask
        midx = None if mask_idx is None \
            else np.asarray(mask_idx, np.int32).tolist()
        with self._oplock:
            self._pub.send({"op": "verify",
                            "mask_idx": midx,
                            "drafts": self._host(drafts, np.int32),
                            "draft_len": self._host(draft_len, np.int32),
                            "temperature": self._host(temperature,
                                                      np.float32),
                            "top_k": self._host(top_k, np.int32),
                            "top_p": self._host(top_p, np.float32),
                            "lookahead_rows": None
                            if lookahead_rows is None
                            else int(lookahead_rows),
                            "mask": pack_mask(mask)})
            kw = {}
            if lookahead_rows is not None:
                kw["lookahead_rows"] = lookahead_rows
            if mask_idx is not None:
                kw["mask_idx"] = mask_idx
            elif mask is not None:
                kw["mask"] = mask
            return self._engine.verify(
                state, drafts, draft_len, temperature, top_k, top_p,
                **kw)

    def commit_spec(self, slot: int, advance: int,
                    reserve: int = 0) -> None:
        """Replicated spec/chunk commit (host bookkeeping that followers
        must replay to keep their allocators in step)."""
        with self._oplock:
            self._pub.send({"op": "commit_spec", "slot": int(slot),
                            "advance": int(advance),
                            "reserve": int(reserve)})
            self._engine.commit_spec(slot, advance, reserve=reserve)


def _unknown_adapter(e: Exception) -> bool:
    from .core import UnknownAdapterError
    return isinstance(e, UnknownAdapterError)


class RankStats:
    """A follower's counters for a measurement harness (serve's
    `--rank-stats DIR`), written to DIR/rank<r>.json when it stops: the
    ops it replayed by kind with their host seconds (each op ends in a
    device synchronize), its collectives' calls and seconds, its kernel
    launches and its peak device memory; and, for the decode ops it
    replays while the file DIR/window exists, their wall seconds, their
    collectives' seconds and their summed device time from one
    torch.profiler session over them. A follower has no HTTP surface,
    so a harness reads these instead."""

    def __init__(self, out_dir: str, rank: int, group, device):
        self.out_dir = out_dir
        self.rank = rank
        self.group = group
        self.device = torch.device(device)
        self.ops: dict = {}
        self.window = {"decode_ops": 0, "wall_s": 0.0, "comm_s": 0.0,
                       "device_ms": None}
        self._prof = None
        self._t0 = 0.0
        self._c0 = 0.0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, op: str) -> None:
        in_window = op == "decode" and os.path.exists(
            os.path.join(self.out_dir, "window"))
        if in_window and self._prof is None and \
                self.device.type == "cuda":
            # the process's one profiler session (telemetry/profiler.py)
            from ..telemetry.profiler import session
            self._session = session()
            self._prof = self._session.__enter__()
        elif not in_window and op == "decode":
            self._end_window()
        self._in = in_window
        self._t0 = time.perf_counter()
        self._c0 = self.group.seconds if self.group is not None else 0.0

    def after(self, op: str) -> None:
        self._sync()
        dt = time.perf_counter() - self._t0
        n, sec = self.ops.get(op, (0, 0.0))
        self.ops[op] = (n + 1, sec + dt)
        if self._in:
            self.window["decode_ops"] += 1
            self.window["wall_s"] += dt
            if self.group is not None:
                self.window["comm_s"] += self.group.seconds - self._c0

    def _end_window(self) -> None:
        if self._prof is None:
            return
        self._session.__exit__(None, None, None)
        busy = 0.0
        for ev in self._prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            busy += us
        self.window["device_ms"] = busy / 1e3
        self._prof = None

    def write(self) -> str:
        from ..ops.flash import LAUNCHES
        self._end_window()
        doc = {"rank": self.rank, "ops": self.ops, "window": self.window,
               "launches": dict(LAUNCHES),
               "collectives": None if self.group is None else
               {"calls": self.group.calls, "seconds": self.group.seconds,
                "backend": self.group.backend},
               "peak_bytes": torch.cuda.max_memory_allocated(self.device)
               if self.device.type == "cuda" else None}
        path = os.path.join(self.out_dir, f"rank{self.rank}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def follower_loop(engine, sub: OpSubscriber, pd_export: bool = False,
                  stats: Optional[RankStats] = None) -> int:
    """Replay the leader's op stream against the local engine.

    Every value the replay needs beyond the op headers (prefill KV,
    sampled tokens) is computed locally: the same ops on every rank,
    whose collectives join the ranks' parts, give every rank its part
    of the same result, so insert() consumes the follower's OWN last
    prefill output. Structured-output masks arrive IN the ops.
    `pd_export`: this is a PD prefill-pool follower — after each
    prefill replay, join the leader's gather (`engine.gather_kv`) that
    exports the KV to the wire. `stats` counts the replayed ops.
    Returns an exit code: 0 on orderly stop, 1 on a dropped leader.
    """
    from .structured import unpack_mask
    state = engine.new_state()
    last_prefill: Optional[Tuple] = None
    while True:
        msg = sub.recv()
        if msg is None:
            log.error("control channel dropped; exiting for group "
                      "restart")
            return 1
        op = msg["op"]
        if op == "stop":
            return 0
        if stats is not None:
            stats.before(op)
        try:
            if op == "prefill":
                fm = unpack_mask(msg.get("first_mask"))
                kwargs = {} if fm is None else {"first_mask": fm}
                if msg.get("adapter") is not None:
                    kwargs["adapter"] = msg["adapter"]
                try:
                    last_prefill = engine.prefill(
                        msg["ids"], msg["temperature"], msg["top_k"],
                        msg["top_p"], **kwargs)
                except Exception as e:
                    if not _unknown_adapter(e):
                        raise
                    # the leader hit the IDENTICAL per-request error before
                    # any device op ran on either side (it publishes, then
                    # executes) — skip in lockstep instead of dying
                    last_prefill = None
                    continue
                if pd_export:
                    _, (k, v), _, _ = last_prefill
                    engine.gather_kv(k)
                    engine.gather_kv(v)
            elif op == "prefill_blob":
                # PD decode group: the leader shipped the prefill pool's
                # KV bytes; deserialize locally — no fetch, no compute
                from .pd import deserialize_kv
                token, k, v, true_len, bucket = deserialize_kv(
                    base64.b64decode(msg["blob"]))
                last_prefill = (token, (k, v), true_len, bucket)
            elif op == "insert":
                if last_prefill is None:
                    continue  # its prefill failed in lockstep (adapter)
                tok, kv, _true_len, _bucket = last_prefill
                ikw = {} if msg.get("adapter") is None \
                    else {"adapter": msg["adapter"]}
                try:
                    state = engine.insert(state, kv, msg["slot"],
                                          msg["true_len"], tok,
                                          msg["bucket"], **ikw)
                except Exception as e:
                    if not _unknown_adapter(e):
                        raise
            elif op == "register_adapter":
                engine.register_adapter(msg["name"], msg["path"])
            elif op == "unregister_adapter":
                try:
                    engine.unregister_adapter(msg["name"])
                except ValueError:
                    # the leader only publishes after ITS unload succeeded;
                    # a local refusal means this follower's adapter refs
                    # drifted — clear ONLY the refused adapter's slot refs
                    # (not the KV blocks: active sequences own those), then
                    # follow the leader rather than kill the group
                    log.warning("unregister %r refused locally; clearing "
                                "its stale adapter refs to follow the "
                                "leader", msg["name"])
                    idx = engine.adapter_id(msg["name"])
                    refs = engine._slot_adapters
                    refs[refs == idx] = 0
                    engine.unregister_adapter(msg["name"])
            elif op == "free_slot":
                engine.free_slot(msg["slot"])
            elif op == "set_mask_row":
                engine.set_mask_row(msg["row"], unpack_mask(msg["bits"]))
            elif op == "decode":
                mask = unpack_mask(msg.get("mask"))
                kwargs = {} if mask is None else {"mask": mask}
                if msg.get("mask_idx") is not None:
                    kwargs = {"mask_idx": np.asarray(msg["mask_idx"],
                                                     np.int32)}
                state, _ = engine.decode(
                    state,
                    np.asarray(msg["temperature"], np.float32),
                    np.asarray(msg["top_k"], np.int32),
                    np.asarray(msg["top_p"], np.float32), **kwargs)
            elif op == "decode_multi":
                kwargs = {}
                if msg.get("lookahead_rows") is not None:
                    kwargs["lookahead_rows"] = msg["lookahead_rows"]
                mask = unpack_mask(msg.get("mask"))
                if msg.get("mask_idx") is not None:
                    kwargs["mask_idx"] = np.asarray(msg["mask_idx"],
                                                    np.int32)
                elif mask is not None:
                    kwargs["mask"] = mask
                state, _, _ = engine.decode_multi(
                    state,
                    np.asarray(msg["temperature"], np.float32),
                    np.asarray(msg["top_k"], np.int32),
                    np.asarray(msg["top_p"], np.float32),
                    steps=msg["steps"],
                    budget=np.asarray(msg["budget"], np.int32),
                    stop_ids=np.asarray(msg["stop_ids"], np.int32),
                    **kwargs)
            elif op == "verify":
                kwargs = {}
                if msg.get("lookahead_rows") is not None:
                    kwargs["lookahead_rows"] = msg["lookahead_rows"]
                mask = unpack_mask(msg.get("mask"))
                if msg.get("mask_idx") is not None:
                    kwargs["mask_idx"] = np.asarray(msg["mask_idx"],
                                                    np.int32)
                elif mask is not None:
                    kwargs["mask"] = mask
                state, _, _ = engine.verify(
                    state,
                    np.asarray(msg["drafts"], np.int32),
                    np.asarray(msg["draft_len"], np.int32),
                    np.asarray(msg["temperature"], np.float32),
                    np.asarray(msg["top_k"], np.int32),
                    np.asarray(msg["top_p"], np.float32), **kwargs)
            elif op == "commit_spec":
                engine.commit_spec(msg["slot"], msg["advance"],
                                   reserve=msg["reserve"])
            else:
                log.error("unknown op %r from leader", op)
                return 1
        finally:
            if stats is not None:
                stats.after(op)
