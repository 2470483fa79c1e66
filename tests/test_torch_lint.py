"""scripts/check_torch_hot_path_sync.py: the port's decode loop reads no
device value on the host outside the drain sinks.

The port itself has no finding. Fixture packages (an engine/scheduler.py
with a `Scheduler.step`, and an engine/core.py for the engine's ops)
show what is found: a sync in `step`, in a helper it calls, in an engine
op reached through `self.engine.decode(...)` or in the model reached
through `self.model(...)`; and what is not: the same call inside
`_drain_inflight`, or in a function the step never reaches.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "check_torch_hot_path_sync.py"

SCHEDULER = """
import torch

class Scheduler:
    def step(self):
        {step}
        self._helper()
        self.engine.decode(None)
        self._drain_inflight()

    def _helper(self):
        {helper}

    def _drain_inflight(self):
        return self.toks.tolist()

    def unreached(self):
        return self.toks.item()
"""
CORE = """
class InferenceEngine:
    def decode(self, state):
        {decode}
        return self.model(state)
"""
LLAMA = """
class Llama:
    def forward(self, x):
        {forward}
        return x
"""


def _run(*args):
    return subprocess.run([sys.executable, str(SCRIPT), *map(str, args)],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)


def _package(tmp_path, step="pass", helper="pass", decode="pass",
             forward="pass"):
    pkg = tmp_path / "pkg"
    for rel, text in (("engine/scheduler.py",
                       SCHEDULER.format(step=step, helper=helper)),
                      ("engine/core.py", CORE.format(decode=decode)),
                      ("models/llama.py", LLAMA.format(forward=forward))):
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return pkg


def test_port_has_no_finding():
    r = _run()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout


@pytest.mark.parametrize("where, call, label", [
    ("step", "self.last.item()", ".item()"),
    ("helper", "torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("decode", "state.lengths.cpu()", ".cpu()"),
    ("forward", "x.tolist()", ".tolist()"),
])
def test_sync_on_the_step_path_is_found(tmp_path, where, call, label):
    r = _run(_package(tmp_path, **{where: call}))
    assert r.returncode == 1, r.stdout + r.stderr
    (line,) = [ln for ln in r.stdout.splitlines()
               if ln.startswith("VIOLATION")]
    assert label in line
    assert "1 violation(s)" in r.stdout


def test_drain_sinks_and_unreached_code_are_quiet(tmp_path):
    r = _run(_package(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 violation(s)" in r.stdout
