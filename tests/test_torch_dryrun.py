"""The port's entry points (ome_tpu_torch/dryrun.py) on the CPU:
`dryrun_multichip(4)` spawns 4 rank processes, runs one training step
of `tiny_test(moe=True)` on `MeshConfig.auto(4)`, the tp-sharded
serving engine and the leader / follower op stream, and prints the
reference's three lines (__graft_entry__.py); `entry()` gives the
forward step on the flagship shape; the module runs as a script."""

import re
import subprocess
import sys

import numpy as np
import torch

from ome_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from ome_tpu_torch import dryrun
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.parallel.mesh import MeshConfig


def test_dryrun_multichip_4_prints_the_reference_lines(capsys):
    dryrun.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    m = MeshConfig.auto(4, num_layers=tiny_test(moe=True).num_layers)
    ref = JaxMeshConfig.auto(4, num_layers=4)
    assert (m.dp, m.pp, m.tp) == (ref.dp, ref.pp, ref.tp)
    assert len(out) == 3, out
    head = (f"dryrun_multichip(n=4): mesh=(dp={m.dp}, pp={m.pp}, "
            f"tp={m.tp}) loss=")
    assert out[0].startswith(head), out[0]
    loss = float(out[0][len(head):])
    assert np.isfinite(loss) and loss > 0
    assert re.fullmatch(r"dryrun_multichip serving: tp=4 sharded decode ok "
                        r"\(token=\d+\)", out[1]), out[1]
    assert re.fullmatch(r"dryrun_multichip multihost: leader op stream "
                        r"replayed by follower engine \(token=\d+\)",
                        out[2]), out[2]
    # the follower replays the leader's stream: the same first token
    assert out[1].split("token=")[1] == out[2].split("token=")[1]


def test_entry_forward_on_the_cpu():
    fn, (params, tokens) = dryrun.entry(device="cpu")
    with torch.no_grad():
        logits = fn(params, tokens)
    assert logits.shape == (2, 128, 2048)
    assert torch.isfinite(logits).all()


def test_module_runs_one_rank_as_a_script():
    r = subprocess.run([sys.executable, "-m", "ome_tpu_torch.dryrun", "1",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("dryrun_multichip(n=1): mesh=(dp=1, pp=1, "
                               "tp=1) loss="), lines
    assert len(lines) == 3
