"""Training checkpoint and resume in the port (ome_tpu_torch/train/
checkpoint.py), as tests/test_train_checkpoint.py holds the reference's:

* save mid-run, restore and resume: the next loss equals the
  uninterrupted run's bit for bit (one process);
* restore onto another layout — saved under dp 4, resumed under tp 2
  (gloo groups of 4 and 2 rank processes), and saved under pp 2,
  resumed under pp 1 — gives the next loss of the original layout
  within 5e-4 relative (the reference's tolerance: the same state, other
  reduction orders);
* `keep` retention, `latest_step` (None without a directory), no
  directory created by a read, and the reference's two
  FileNotFoundErrors in its words."""

import os

import numpy as np
import pytest
import torch

from ome_tpu.train import checkpoint as jckpt
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import init_params
from ome_tpu_torch.train import checkpoint
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers


def _cfg():
    return tiny_test().replace(dtype=torch.float32, num_layers=4)


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    whole_np = workers._tree_np(whole)
    tokens = np.ones((8, 16), np.int32)
    return cfg, whole_np, tokens, tokens.copy()


def test_save_restore_resume_identical(setup, tmp_path):
    torch.set_num_threads(1)
    cfg, whole, tokens, targets = setup
    d = str(tmp_path / "ckpt")
    loss_next = workers.train_save_continue(None, cfg, (1, 1, 1), whole,
                                            tokens, targets, d, 2)
    assert checkpoint.latest_step(d) == 2
    step, loss_resumed = workers.restore_step(None, cfg, (1, 1, 1), d,
                                              tokens, targets)
    assert step == 2
    assert loss_resumed == loss_next  # bit for bit


@pytest.mark.parametrize("saved,resumed", [((4, 1, 1), (1, 1, 2)),
                                           ((1, 2, 1), (1, 1, 1))],
                         ids=["dp4-to-tp2", "pp2-to-pp1"])
def test_restore_onto_another_layout(setup, tmp_path, saved, resumed):
    cfg, whole, tokens, targets = setup
    d = str(tmp_path / "c")

    def run(fn, mesh, *args):
        n = int(np.prod(mesh))
        if n == 1:
            torch.set_num_threads(1)
            return fn(None, cfg, mesh, *args)
        return tp_workers.run_group(fn, cfg, mesh, *args, size=n)[0]
    loss_a = run(workers.train_save_continue, saved, whole, tokens,
                 targets, d, 1)
    step, loss_b = run(workers.restore_step, resumed, d, tokens, targets)
    assert step == 1
    np.testing.assert_allclose(loss_b, loss_a, rtol=5e-4)


def test_retention_and_latest_step(tmp_path):
    d = str(tmp_path / "r")
    assert checkpoint.latest_step(d) is None
    assert not os.path.exists(d)
    p = {"w": torch.arange(6.0).reshape(2, 3)}
    o = {"count": torch.tensor(0, dtype=torch.int32), "mu": p, "nu": p}
    for s in (1, 2, 3, 4, 5):
        checkpoint.save_train_state(d, s, p, o, keep=3)
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    assert checkpoint.latest_step(d) == 5
    n, got, opt = checkpoint.restore_train_state(
        d, {"w": torch.zeros(2, 3, dtype=torch.float64)}, None, step=4)
    assert n == 4 and got["w"].dtype == torch.float64
    assert torch.equal(got["w"], p["w"].double())
    assert torch.equal(opt["mu"]["w"], p["w"])


def test_reads_create_nothing_and_raise_in_the_reference_words(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError) as got:
        checkpoint.restore_train_state(missing, {}, {})
    with pytest.raises(FileNotFoundError) as want:
        jckpt.restore_train_state(missing, {}, {})
    assert str(got.value) == str(want.value)
    assert not os.path.exists(missing)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError) as got:
        checkpoint.restore_train_state(empty, {}, {})
    with pytest.raises(FileNotFoundError) as want:
        jckpt.restore_train_state(empty, {}, {})
    assert str(got.value) == str(want.value)
    assert os.listdir(empty) == []
