"""The training step (port of ome_tpu/train/step.py).

The reference jits one step over a (dp, pp, tp) `jax.sharding.Mesh`:
the pipeline forward (parallel/pipeline.py), the cross-entropy loss and
optax's AdamW, with GSPMD inserting the gradient psum over dp and the
tp/pp collectives from the sharding annotations. The port runs one
process per rank on torch.distributed (gloo on the CPU, NCCL across
cards) and writes those collectives where GSPMD puts them:

  * dp: the global batch [B, S] is split by rows over dp; each rank's
    loss is its rows' NLL sum over the global batch's positions, so
    that the losses add up to the global mean; every gradient is summed
    over the dp ranks (the mean over dp of the per-rank means).
  * tp: the Megatron split of the serving path (`parallel/sharding.py`,
    `engine/sharded.py::local_config`), with the differentiable
    collectives of `parallel/comm.py` (`copy_to_tp` at the input of each
    column-parallel product, `reduce_sum` after each row-parallel one).
  * pp: each rank holds only its stage's layers and runs GPipe's
    schedule with the neighbouring stages over send/recv
    (`pipeline.StageSchedule`); with a tied head the embedding's
    gradients of the first and last stages are summed over those two
    ranks. With no group, one process runs the whole GPipe schedule
    over stage-stacked params (`pipeline.pipeline_loss_fn`), as the
    reference does with `mesh=None`.
  * AdamW (`make_optimizer`): b1 0.9, b2 0.95, eps 1e-8, decoupled
    weight decay on every leaf, its moments in the param dtype, as
    optax keeps them; elementwise, so each rank updates its own slices.

Global rank r of an n = dp pp tp group sits at (d, p, t) with
r = (d pp + p) tp + t, the reference's `build_mesh` order. A rank's
`params` and `opt_state` are its slices; `TrainStep.whole` gathers the
whole unstacked trees (for `train/checkpoint.py`), and `init_state`
slices whole trees onto the current layout, so a state saved under one
(dp, pp, tp) resumes under another.

Refused by name: weight-quantized leaves (training takes float
weights) and LoRA adapter stacks. Entry points run on the card unless
the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional, Tuple

import torch

from ..engine.sharded import local_config
from ..models.config import ModelConfig
from ..models.params import init_params
from ..models.quant import QTensor
from ..parallel import comm, pipeline, sharding
from ..parallel.mesh import MeshConfig

Params = Dict[str, Any]


# -- AdamW --------------------------------------------------------------------


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) on trees of tensors:
    state {"count", "mu", "nu"} with the moments in each leaf's dtype;
    `update` changes params and state in place."""

    def __init__(self, lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = _map(lambda p: torch.zeros_like(p, requires_grad=False),
                     params)
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": zeros, "nu": _map(torch.zeros_like, zeros)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> None:
        state["count"] += 1
        n = int(state["count"])
        bc1 = 1.0 - self.b1 ** n
        bc2 = 1.0 - self.b2 ** n
        for path, p in _leaves(params):
            g = _get(grads, path)
            mu, nu = _get(state["mu"], path), _get(state["nu"], path)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-self.lr * u)


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, b1=0.9, b2=0.95, weight_decay=weight_decay)


# -- trees ----------------------------------------------------------------------


def _leaves(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _get(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def check_trainable(params: Params) -> None:
    """Training takes float weights: a quantized leaf or a LoRA adapter
    stack is refused by name."""
    for path, leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            raise NotImplementedError(
                f"training takes float weights; {path} is quantized "
                f"(int{leaf.bits}): train the float model and quantize "
                "at load")
        if "_lora_" in path.rsplit(".", 1)[-1]:
            raise NotImplementedError(
                f"training takes the base model's leaves; {path} is a LoRA "
                "adapter stack (merge or drop the adapters first)")


# -- the rank layout --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this process sits in a (dp, pp, tp) group."""

    mesh: MeshConfig
    rank: int = 0

    @property
    def coords(self) -> Tuple[int, int, int]:
        m = self.mesh
        t = self.rank % m.tp
        p = (self.rank // m.tp) % m.pp
        return self.rank // (m.tp * m.pp), p, t

    def global_rank(self, d: int, p: int, t: int) -> int:
        return (d * self.mesh.pp + p) * self.mesh.tp + t


@dataclasses.dataclass
class Groups:
    """This rank's groups: the world, its tp group (the model's
    collectives), its dp group (gradient sums), its pp group (the stage
    links, rank = stage) and, with a tied head under pp, the pair of its
    first and last stages. None where the group would be this rank
    alone."""

    world: Optional[comm.Group] = None
    tp: Optional[comm.Group] = None
    dp: Optional[comm.Group] = None
    pp: Optional[comm.Group] = None
    tie: Optional[comm.Group] = None

    @classmethod
    def build(cls, world: Optional[comm.Group], layout: Layout,
              tied: bool) -> "Groups":
        """The subgroups of `world` (a `comm.Group` of every rank, made
        by `comm.Group.init`), each its own process group over a prefix
        of the world's store; every rank builds the same ones in the same
        order."""
        if world is None or world.size == 1:
            return cls(world=None)
        m = layout.mesh
        d, p, t = layout.coords
        g = layout.global_rank

        def sub(name, ranks):
            if len(ranks) == 1:
                return None
            return _subgroup(world, f"{name}:{','.join(map(str, ranks))}",
                             ranks.index(layout.rank), len(ranks))
        groups = cls(world=world)
        groups.tp = sub("tp", [g(d, p, i) for i in range(m.tp)])
        groups.dp = sub("dp", [g(i, p, t) for i in range(m.dp)])
        groups.pp = sub("pp", [g(d, i, t) for i in range(m.pp)])
        if tied and m.pp > 1 and p in (0, m.pp - 1):
            groups.tie = sub("tie", [g(d, 0, t), g(d, m.pp - 1, t)])
        return groups


def _subgroup(world: comm.Group, name: str, rank: int,
              size: int) -> comm.Group:
    import torch.distributed as dist
    store = dist.PrefixStore(name, world.store)
    if world.backend == "nccl":
        pg = dist.ProcessGroupNCCL(store, rank, size,
                                   dist.ProcessGroupNCCL.Options())
    else:
        pg = dist.ProcessGroupGloo(store, rank, size,
                                   datetime.timedelta(seconds=600))
    return comm.Group(rank, size, pg, world.backend)


# -- the step ------------------------------------------------------------------------


class TrainStep:
    """`make_train_step`'s step: `step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss)`, params and state updated in
    place; tokens and targets the whole global batch [B, S] (every rank
    passes the same), B divisible by dp x num_microbatches. `loss` is
    the global batch's mean NLL (fp32, on every rank)."""

    def __init__(self, cfg: ModelConfig, mesh_cfg: MeshConfig,
                 num_microbatches: int, lr: float = 3e-4,
                 group: Optional[comm.Group] = None, device="cuda"):
        if group is None and (mesh_cfg.dp > 1 or mesh_cfg.tp > 1):
            raise ValueError(
                f"mesh {mesh_cfg} needs a group of {mesh_cfg.size} ranks; "
                "one process runs dp = tp = 1 (any pp)")
        if group is not None and group.size != mesh_cfg.size:
            raise ValueError(f"mesh {mesh_cfg} needs {mesh_cfg.size} ranks, "
                             f"the group has {group.size}")
        pipeline.check_pipeline(cfg, mesh_cfg.pp)
        if cfg.num_layers % mesh_cfg.pp:
            raise ValueError(f"pp={mesh_cfg.pp} must divide "
                             f"{cfg.num_layers} layers")
        self.cfg = cfg
        self.mesh = mesh_cfg
        self.M = num_microbatches
        self.opt = make_optimizer(lr)
        self.device = torch.device(device)
        self.layout = Layout(mesh_cfg, group.rank if group else 0)
        self.groups = Groups.build(group, self.layout,
                                   cfg.tie_word_embeddings)
        self.local_cfg = local_config(cfg, mesh_cfg.tp)
        self.shapes: Dict[str, Tuple[tuple, torch.dtype]] = {}
        d, p, t = self.layout.coords
        self.stage = pipeline.StageSchedule(self.local_cfg, p, mesh_cfg.pp,
                                            self.groups.pp)

    # the single-process GPipe over stage-stacked params
    @property
    def stacked(self) -> bool:
        return self.groups.world is None and self.mesh.pp > 1

    # -- slicing ----------------------------------------------------------

    def _top_names(self, names):
        """The top-level leaves this rank's stage holds."""
        _, p, _ = self.layout.coords
        first, last = p == 0, p == self.mesh.pp - 1
        tied = "lm_head" not in names
        keep = []
        for n in names:
            if n == "embed" and (first or (tied and last)):
                keep.append(n)
            elif n != "embed" and last:
                keep.append(n)
        return keep

    def _local(self, whole: Params) -> Params:
        """This rank's slices of a whole unstacked tree, on the device."""
        m = self.mesh
        d, p, t = self.layout.coords
        if self.stacked:
            tree = sharding.stack_to_stages(whole, m.pp)
        else:
            L = self.cfg.num_layers // m.pp
            tree = {n: whole[n] for n in self._top_names(
                [k for k in whole if k != "layers"])}
            tree["layers"] = {k: v[p * L:(p + 1) * L]
                              for k, v in whole["layers"].items()}
            if m.tp > 1:
                tree = sharding.shard_params(tree, t, m.tp)
        own = m.size == 1 and not self.stacked

        def leaf(x):
            x = x.detach().to(self.device)
            if not own:
                x = x.clone(memory_format=torch.contiguous_format)
            return x
        return _map(leaf, tree)

    def init_state(self, params: Optional[Params] = None,
                   opt_state: Optional[Dict[str, Any]] = None,
                   seed: int = 0) -> Tuple[Params, Dict[str, Any]]:
        """(params, opt_state) of this rank from whole unstacked trees:
        `params` (None: the port's random init from `seed`, the same on
        every rank) and `opt_state` (None: a fresh AdamW state). With one
        rank and no pp the tensors of `params` are taken, not copied."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        check_trainable(params)
        for k in params:
            if k not in ("embed", "layers", "final_norm", "final_norm_bias",
                         "lm_head", "lm_head_bias"):
                raise NotImplementedError(
                    f"the training step runs one uniform layer stack; "
                    f"{k} is not taken")
        self.shapes = {path: (tuple(x.shape), x.dtype)
                       for path, x in _leaves(params)}
        local = _map(lambda x: x.requires_grad_(), self._local(params))
        if opt_state is None:
            state = self.opt.init(local)
        else:
            state = {"count": opt_state["count"].detach().to(
                         torch.int32).cpu().clone(),
                     "mu": self._local(opt_state["mu"]),
                     "nu": self._local(opt_state["nu"])}
        return local, state

    def whole(self, params: Params, opt_state: Dict[str, Any]
              ) -> Tuple[Params, Dict[str, Any]]:
        """The whole unstacked (params, opt_state) on every rank, from
        each rank's slices (a sum over the world of zero-filled trees:
        each leaf part comes from the one rank of dp 0 that holds it)."""
        return (self._gather(params),
                {"count": opt_state["count"].clone(),
                 "mu": self._gather(opt_state["mu"]),
                 "nu": self._gather(opt_state["nu"])})

    @torch.no_grad()
    def _gather(self, local: Params) -> Params:
        if self.stacked:
            return _map(lambda x: x.detach().clone(),
                        sharding.unstack_stages(local))
        m = self.mesh
        d, p, t = self.layout.coords
        L = self.cfg.num_layers // m.pp
        world = self.groups.world
        out: Params = {}
        for path, (shape, dtype) in self.shapes.items():
            buf = torch.zeros(shape, dtype=dtype, device=self.device)
            block, _, name = path.rpartition(".")
            mine = None
            try:
                mine = _get(local, path)
            except KeyError:
                pass
            owner = d == 0 and mine is not None and not (
                path == "embed" and p != 0)
            spec = sharding.leaf_spec(block or None, name) \
                if m.tp > 1 and owner else ()
            dim = sharding.tp_dim(spec) if spec else None
            if dim is None and t != 0:
                owner = False  # replicated over tp: tp rank 0's copy
            if owner:
                part = buf
                if block:
                    part = part.narrow(0, p * L, L)
                if dim is not None:
                    n = part.shape[dim] // m.tp
                    part = part.narrow(dim, t * n, n)
                part.copy_(mine.detach())
            if world is not None:
                world.all_reduce(buf)
            node = out
            if block:
                node = out.setdefault(block, {})
            node[name] = buf
        return out

    # -- one step -----------------------------------------------------------

    def __call__(self, params: Params, opt_state: Dict[str, Any],
                 tokens, targets):
        loss, grads = self.loss_and_grads(params, tokens, targets)
        self.opt.update(params, grads, opt_state)
        return params, opt_state, loss

    def loss_and_grads(self, params: Params, tokens, targets
                       ) -> Tuple[torch.Tensor, Params]:
        """The step before AdamW's update: the global batch's mean NLL
        (fp32, on every rank) and this rank's gradients of it, a tree
        like `params` (summed over dp and, with a tied head under pp,
        over the first and last stages). The params' .grad is left
        None."""
        m, g = self.mesh, self.groups
        d, p, t = self.layout.coords
        tokens = torch.as_tensor(tokens).to(self.device)
        targets = torch.as_tensor(targets).to(self.device)
        B, S = tokens.shape
        if B % (m.dp * self.M):
            raise ValueError(f"batch {B} must divide over dp={m.dp} x "
                             f"{self.M} microbatches")
        rows = slice(d * (B // m.dp), (d + 1) * (B // m.dp))
        tok_mbs = tokens[rows].chunk(self.M)
        tgt_mbs = targets[rows].chunk(self.M)
        for _, x in _leaves(params):
            x.grad = None
        with comm.use(g.tp):
            if self.stacked:
                loss = pipeline.pipeline_loss_fn(params, self.local_cfg,
                                                 tokens, targets, m.pp,
                                                 self.M)
                loss.backward()
                total = loss.detach()
            else:
                total = self.stage.run(params, list(tok_mbs), list(tgt_mbs),
                                       B * S)
        grads = _map(lambda x: x.grad if x.grad is not None
                     else torch.zeros_like(x), params)
        for _, x in _leaves(params):
            x.grad = None
        if g.tie is not None:
            g.tie.all_reduce(grads["embed"])
        if g.dp is not None:
            for _, x in _leaves(grads):
                g.dp.all_reduce(x)
        loss = total.float().reshape(())
        if g.world is not None:
            # each dp shard's loss, once: from its last stage's tp rank 0
            if not (self.stage.last and t == 0):
                loss = torch.zeros_like(loss)
            loss = g.world.all_reduce(loss.contiguous().clone())
        return loss, grads


def make_train_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                    num_microbatches: int, lr: float = 3e-4,
                    group: Optional[comm.Group] = None, device="cuda"):
    """Returns (train_step, init_state) over the (dp, pp, tp) group
    `group` (a `comm.Group` of mesh_cfg.size ranks; None: this process
    alone, dp = tp = 1)."""
    step = TrainStep(cfg, mesh_cfg, num_microbatches, lr, group, device)
    return step, step.init_state
