"""Training checkpoint and resume (port of ome_tpu/train/checkpoint.py).

The reference saves params, optimizer state and the step counter
through orbax's CheckpointManager: a directory per step, bounded
retention, the latest step looked up, sharding-aware restore onto the
current mesh. The port keeps that contract with `torch.save`: step n is
`<directory>/<n>/state.pt` holding the whole unstacked trees
(`TrainStep.whole` gathers them from every rank's slices; one rank
saves), written under a temporary name and renamed, so a step directory
exists only once whole. Restoring returns whole trees, cast to the
dtype and device of the `*_like` trees; `TrainStep.init_state` then
slices them onto the current (dp, pp, tp), so a state saved under one
layout resumes under another.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

log = logging.getLogger("ome.train.ckpt")

_FILE = "state.pt"


def _steps(directory: str):
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(directory, n, _FILE)))


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def save_train_state(directory: str, step: int, params: Dict[str, Any],
                     opt_state: Any, keep: int = 3) -> None:
    """Save one training-step snapshot; prunes to `keep` newest."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save({"params": _cpu(params), "opt_state": _cpu(opt_state)},
               os.path.join(tmp, _FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(old)))
    log.info("saved training state at step %d to %s", step, directory)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _like(saved, like, path: str = ""):
    if like is None:
        return saved
    if isinstance(like, dict):
        return {k: _like(saved[k], v, f"{path}{k}.") for k, v in like.items()}
    if tuple(saved.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path[:-1] or '?'} is "
                         f"{tuple(saved.shape)}, the target "
                         f"{tuple(like.shape)}")
    return saved.to(dtype=like.dtype, device=like.device)


def restore_train_state(directory: str, params_like: Dict[str, Any],
                        opt_state_like: Any,
                        step: Optional[int] = None,
                        ) -> Tuple[int, Dict[str, Any], Any]:
    """Restore (step, params, opt_state): whole unstacked trees.

    `*_like` are whole trees (the structure, dtype and device targets;
    None keeps what was saved). Slice the result onto the current layout
    with `TrainStep.init_state(params, opt_state)`."""
    if not os.path.isdir(directory):
        # read path: never create the directory as a side effect
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    state = torch.load(os.path.join(directory, str(int(step)), _FILE),
                       map_location="cpu", weights_only=True)
    log.info("restored training state from step %d", step)
    return (step, _like(state["params"], params_like),
            _like(state["opt_state"], opt_state_like))
