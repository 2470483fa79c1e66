"""Rank processes of the port's training CPU tests.

Each function runs in a rank process of a gloo group
(`torch_tp_workers.run_group`) and returns a picklable result that the
test compares with the JAX package's, which it computes itself. Nothing
here imports JAX: the trees arrive and leave as numpy arrays.
"""

import numpy as np


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def train_losses(group, cfg, mesh, whole, tokens, targets, steps,
                 num_microbatches, lr):
    """The losses of `steps` train steps over `mesh` (a (dp, pp, tp)
    tuple) from the whole numpy tree, and the whole updated params."""
    from ome_tpu_torch.models.params import from_jax_params
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import step as ts
    step, init_state = ts.make_train_step(
        cfg, MeshConfig(*mesh), num_microbatches, lr=lr, group=group,
        device="cpu")
    params, opt = init_state(from_jax_params(whole, "cpu"))
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
    wp, _ = step.whole(params, opt)
    return {"losses": losses,
            "params": _tree_np(wp) if group.rank == 0 else None}


def stage_logits_and_grads(group, cfg, whole, tokens, num_microbatches):
    """pp = 2 stage per rank: this rank's stage of the whole numpy tree
    runs `StageSchedule` on the mean NLL of targets = tokens; returns the
    last stage's loss and each rank's parameter gradients (whole-tree
    paths), and rank 1's logits of a forward alone."""
    import torch

    from ome_tpu_torch.models.params import from_jax_params
    from ome_tpu_torch.parallel import pipeline
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import step as ts
    step = ts.TrainStep(cfg, MeshConfig(pp=2), num_microbatches,
                        group=group, device="cpu")
    params, _ = step.init_state(from_jax_params(whole, "cpu"))
    tok = torch.from_numpy(tokens)
    total = step.stage.run(params, list(tok.chunk(num_microbatches)),
                           list(tok.chunk(num_microbatches)), tok.numel())
    grads = {path: x.grad.numpy() for path, x in ts._leaves(params)}
    # a forward alone: stage 0 sends its activations, stage 1 makes logits
    with torch.no_grad():
        B, S = tok.shape
        pos = pipeline.positions_of(B, S, "cpu")
        freqs = pipeline.llama.rope_frequencies(cfg, "cpu")
        if group.rank == 0:
            h = pipeline.stage_forward(params["layers"], cfg,
                                       pipeline.embed(params, cfg, tok),
                                       freqs, pos)
            step.groups.pp.send(h, 1)
            logits = None
        else:
            x = torch.empty(B, S, cfg.hidden_size, dtype=cfg.dtype)
            step.groups.pp.recv(x, 0)
            h = pipeline.stage_forward(params["layers"], cfg, x, freqs, pos)
            logits = pipeline.head_logits(params, cfg, h).numpy()
    return {"loss": float(total), "grads": grads, "logits": logits,
            "stage_layers": int(params["layers"]["wq"].shape[0])}


def ep_moe(group, cfg, lp, x):
    """This rank's output of the expert-parallel MoE over its E/ep
    experts of one layer (`lp`, whole numpy leaves)."""
    import torch

    from ome_tpu_torch.parallel.moe import moe_mlp_ragged_ep
    n = group.size
    E = cfg.num_experts
    part = {}
    for k, v in lp.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("we_gate", "we_up", "we_down"):
            t = t[group.rank * E // n:(group.rank + 1) * E // n].clone()
        part[k] = t
    return moe_mlp_ragged_ep(torch.from_numpy(x), part, cfg,
                             group).numpy()


def ring(group, q, k, v, softcap):
    """This rank's rows of ring attention over its S/n shard."""
    import torch

    from ome_tpu_torch.parallel.ring_attention import ring_attention
    n, r = group.size, group.rank
    sl = q.shape[1] // n

    def shard(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[:, r * sl:(r + 1) * sl]))
    out = ring_attention(shard(q), shard(k), shard(v), group,
                         logit_softcap=softcap)
    return out.numpy()


def train_save_continue(group, cfg, mesh, whole, tokens, targets, directory,
                        save_after):
    """Train `save_after` steps over `mesh`, save the whole state (rank
    0 writes), then one more step: its loss."""
    from ome_tpu_torch.models.params import from_jax_params
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import checkpoint
    from ome_tpu_torch.train import step as ts
    step, init_state = ts.make_train_step(cfg, MeshConfig(*mesh), 2,
                                          group=group, device="cpu")
    params, opt = init_state(from_jax_params(whole, "cpu"))
    for _ in range(save_after):
        params, opt, _ = step(params, opt, tokens, targets)
    wp, wo = step.whole(params, opt)
    if group is None or group.rank == 0:
        checkpoint.save_train_state(directory, save_after, wp, wo)
    if group is not None:
        group.all_reduce(__import__("torch").zeros(1))  # saved: go on
    params, opt, loss = step(params, opt, tokens, targets)
    return float(loss)


def restore_step(group, cfg, mesh, directory, tokens, targets):
    """Restore the latest state onto `mesh` and take one step: (the
    restored step, its loss)."""
    from ome_tpu_torch.parallel.mesh import MeshConfig
    from ome_tpu_torch.train import checkpoint
    from ome_tpu_torch.train import step as ts
    step, init_state = ts.make_train_step(cfg, MeshConfig(*mesh), 2,
                                          group=group, device="cpu")
    n, wp, wo = checkpoint.restore_train_state(directory, None, None)
    params, opt = init_state(wp, wo)
    params, opt, loss = step(params, opt, tokens, targets)
    return n, float(loss)
