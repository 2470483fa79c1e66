"""The tp group's collectives, written where GSPMD inserts them in the
reference.

The reference shards the weights over a mesh and lets XLA insert the
collectives; the port runs one process per rank and calls them itself:

  * `reduce_sum`: the sum of the ranks' partial outputs, where the
    reference's psums fall (after the attention output projection, the
    MLP's and the experts' down projections);
  * `embed_lookup`: a vocab-sharded embedding lookup (each rank looks up
    the tokens in its rows and zeros elsewhere, then a sum);
  * `gather_last`: the vocab-sharded logits (or any tensor split along
    its last dim) made whole on every rank;
  * `broadcast`: rank 0's tensor on every rank (the sampled ids);
  * `amax`: the element-wise max over ranks (quantization scales of a
    weight whose contraction dim is split);
  * `copy_to_tp`: the identity, whose gradient is summed over the ranks
    (Megatron's f): it stands at the input of every column-parallel
    product (q/k/v, gate/up, the experts under tp, the vocab-sharded
    head) and on a replicated weight that only the rank's own heads use,
    so that the ranks' partial gradients of a replicated tensor add up.

Training differentiates through them: `reduce_sum`'s gradient passes
through unchanged (each rank's loss is the whole loss), so
`embed_lookup` and `gather_last`, written over it, differentiate too.
With grad off, or outside a group, each is the function serving runs.

Every one is an `all_reduce` or a `broadcast` of torch.distributed (a
gather is an all_reduce over a zero-filled buffer), the two collectives
gloo takes on CUDA tensors, so that gloo (ranks sharing a card, the CPU)
and NCCL (a card per rank) run one code path.

The group is this thread's context (`use`), not a process global: an
engine wraps each of its ops in `use(its group)`, so a tp=1 engine in
the same process runs none of this. Outside a group every function is
the identity, and tp=1 calls nothing.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import time
from contextvars import ContextVar
from typing import Optional

import torch

log = logging.getLogger("ome.parallel.comm")


class Group:
    """One process's membership of a tp group: its rank, the group's
    size and the torch.distributed process group the collectives run
    on. `seconds` and `calls` count the time spent in collectives (the
    host clock: a gloo collective on CUDA tensors is synchronous)."""

    def __init__(self, rank: int, size: int, pg=None,
                 backend: str = "gloo"):
        self.rank = rank
        self.size = size
        self.pg = pg
        self.backend = backend
        self.calls = 0
        self.seconds = 0.0
        self.store = None

    @classmethod
    def init(cls, address: str, rank: int, size: int, backend: str,
             device: Optional[torch.device] = None,
             timeout: float = 600.0, store=None) -> "Group":
        """Join the group's rendezvous at `address` (host:port; rank 0
        hosts the store there), its world size and rank given explicitly
        (nothing is read from the environment). The process group is
        one of its own, not torch.distributed's default: a process can
        lead one group after another, or several at once (a test's PD
        pair of tp groups). `store` is a store rank 0 already hosts
        (`host_store`), in place of one bound at `address`."""
        import torch.distributed as dist
        host, port = address.rsplit(":", 1)
        td = datetime.timedelta(seconds=timeout)
        if store is None:
            store = dist.TCPStore(host, int(port), size, rank == 0, td)
        if backend == "nccl":
            pg = dist.ProcessGroupNCCL(store, rank, size,
                                       dist.ProcessGroupNCCL.Options())
        else:
            pg = dist.ProcessGroupGloo(store, rank, size, td)
        log.info("joined the tp group at %s as rank %d/%d (backend %s)",
                 address, rank, size, backend)
        group = cls(rank, size, pg, backend)
        group.store = store
        return group

    @staticmethod
    def host_store(host: str, size: int, timeout: float = 600.0):
        """Rank 0's store on a port the kernel picks as it binds
        (`.port`), for a caller that hands the port to the other ranks:
        no other process can take the port between its choice and the
        bind. The store does not wait for the other ranks here."""
        import torch.distributed as dist
        return dist.TCPStore(host, 0, size, True,
                             datetime.timedelta(seconds=timeout),
                             wait_for_workers=False)

    def close(self) -> None:
        """Leave the group."""
        if self.pg is None:
            return
        shutdown = getattr(self.pg, "shutdown", None)
        if self.backend == "nccl" and shutdown is not None:
            shutdown()
        self.pg = None
        self.store = None

    def _timed(self, fn):
        t0 = time.perf_counter()
        fn()
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`x` reduced over the ranks, in place (x must be contiguous)."""
        import torch.distributed as dist
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.SUM if op == "sum" \
            else dist.ReduceOp.MAX
        self._timed(lambda: self.pg.allreduce([x], opts).wait())
        return x

    def send(self, x: torch.Tensor, dst: int) -> None:
        """`x` to rank `dst` of this group (a pipeline stage's
        activation or its gradient). gloo moves host memory: a CUDA
        tensor goes through a host copy."""
        t = x.detach().contiguous()
        if self.backend == "gloo" and t.is_cuda:
            t = t.cpu()
        self._timed(lambda: self.pg.send([t], dst, 0).wait())

    def recv(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank `src`'s `send` into `x` (contiguous), in place."""
        t = x.cpu() if self.backend == "gloo" and x.is_cuda else x
        self._timed(lambda: self.pg.recv([t], src, 0).wait())
        if t is not x:
            x.copy_(t)
        return x

    def sendrecv(self, x: torch.Tensor, dst: int, out: torch.Tensor,
                 src: int) -> torch.Tensor:
        """`x` to rank `dst` and rank `src`'s into `out`, both posted
        before either is waited on (a ring where every rank sends and
        receives at once)."""
        t = x.detach().contiguous()
        o = out
        if self.backend == "gloo" and t.is_cuda:
            t, o = t.cpu(), out.cpu()

        def both():
            r = self.pg.recv([o], src, 1)
            s = self.pg.send([t], dst, 1)
            s.wait()
            r.wait()
        self._timed(both)
        if o is not out:
            out.copy_(o)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` on every rank, in place."""
        import torch.distributed as dist
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        self._timed(lambda: self.pg.broadcast([x], opts).wait())
        return x


_group: ContextVar[Optional[Group]] = ContextVar("ome_tp_group",
                                                 default=None)


@contextlib.contextmanager
def use(group: Optional[Group]):
    """Run the block's model code under `group` (None or a group of one:
    no collectives)."""
    token = _group.set(group if group is not None and group.size > 1
                       else None)
    try:
        yield
    finally:
        _group.reset(token)


def current() -> Optional[Group]:
    """The group the calling thread's model code runs under, or None."""
    return _group.get()


def rank_and_size():
    """(rank, size) of the current group; (0, 1) outside one."""
    g = _group.get()
    return (0, 1) if g is None else (g.rank, g.size)


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToTp(torch.autograd.Function):
    """The identity; its gradient is summed over the ranks."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_reduce(grad.contiguous().clone()), None


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's partial `x` (the reference's psum).
    Outside autograd it reduces `x` in place."""
    g = _group.get()
    if g is None:
        return x
    if _tracked(x):
        return _ReduceSum.apply(x, g)
    return g.all_reduce(x.contiguous())


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """`x` itself; under autograd in a group, its gradient is the sum of
    the ranks' gradients (the input of a column-parallel product)."""
    g = _group.get()
    if g is None or not _tracked(x):
        return x
    return _CopyToTp.apply(x, g)


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `x` on every rank."""
    g = _group.get()
    if g is None:
        return x
    return g.broadcast(x.contiguous(), src)


def amax(x: torch.Tensor) -> torch.Tensor:
    """The element-wise max of `x` over the ranks."""
    g = _group.get()
    if g is None:
        return x
    return g.all_reduce(x.contiguous(), op="max")


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """A tensor split along its last dim over the ranks (rank r holds
    columns [r n, (r + 1) n)), whole on every rank: an all_reduce over a
    zero-filled buffer, exact (each element is one rank's value plus
    zeros)."""
    g = _group.get()
    if g is None:
        return x
    n = x.shape[-1]
    return reduce_sum(torch.nn.functional.pad(
        x, (g.rank * n, (g.size - 1 - g.rank) * n)))


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`gather_last` along dim `dim` (a KV plane's heads)."""
    g = _group.get()
    if g is None:
        return x
    return gather_last(x.movedim(dim, -1)).movedim(-1, dim).contiguous()


def embed_lookup(rows_of, tokens: torch.Tensor, local_rows: int,
                 dtype) -> torch.Tensor:
    """A vocab-sharded embedding lookup: `rows_of(ids)` looks up local
    rows (this rank holds vocab ids [r n, (r + 1) n), n = local_rows);
    tokens outside them give zeros, and the sum over ranks gives each
    token its one rank's row, exactly."""
    g = _group.get()
    if g is None:
        return rows_of(tokens)
    lo = g.rank * local_rows
    t = tokens.long()
    mine = (t >= lo) & (t < lo + local_rows)
    x = rows_of(torch.where(mine, t - lo, torch.zeros_like(t)))
    x = torch.where(mine[..., None], x.to(dtype),
                    torch.zeros((), dtype=dtype, device=x.device))
    return reduce_sum(x)


def local_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's `n` leading-dim rows of a replicated tensor that is
    indexed by sharded heads (command-r-plus's per-head q/k norms); `t`
    itself when it has n rows already or no group is active."""
    g = _group.get()
    if g is None or t.shape[0] == n:
        return t
    return copy_to_tp(t).narrow(0, g.rank * n, n)
