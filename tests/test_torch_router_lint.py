"""omelint's concurrency rules over the port's router package.

`scripts/omelint.py --root ome_tpu_torch/router` with the rules the
reference's router answers to (blocking-in-async, lock-discipline,
thread-shared-state) finds nothing beyond what `lint-baseline.json`
records for the same reference code (`ome_tpu/router/`), finding for
finding with the package name set aside. A copy of the port's router
with a `time.sleep` planted in the asyncio relay shows the rules see
that root: the planted call is found.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "omelint.py"
RULES = ("blocking-in-async", "lock-discipline", "thread-shared-state")


def _lint(root):
    args = [sys.executable, str(SCRIPT), "--root", str(root),
            "--no-baseline"]
    for r in RULES:
        args += ["--rule", r]
    proc = subprocess.run(args, capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode in (0, 1), proc.stdout + proc.stderr
    found = [ln[len("VIOLATION: "):] for ln in proc.stdout.splitlines()
             if ln.startswith("VIOLATION: ")]
    summary = proc.stdout.strip().splitlines()[-1]
    return found, summary


def _baselined_for_reference_router():
    data = json.loads((REPO / "lint-baseline.json").read_text())
    return [f for f in data["findings"]
            if f["path"].startswith("ome_tpu/router/")
            and f["rule"] in RULES]


def test_port_router_finds_nothing_beyond_the_reference_baseline():
    found, summary = _lint(REPO / "ome_tpu_torch" / "router")
    allowed = _baselined_for_reference_router()
    normalized = [f.replace("ome_tpu_torch/", "ome_tpu/") for f in found]
    extra = [f for f in normalized
             if not any(a["message"] in f and a["rule"] in f
                        for a in allowed)]
    assert not extra, "\n".join(found)
    assert "5 files" in summary or "4 files" in summary, summary


def test_a_planted_blocking_call_is_found(tmp_path):
    root = tmp_path / "router"
    shutil.copytree(REPO / "ome_tpu_torch" / "router", root)
    src = root / "aserver.py"
    text = src.read_text()
    anchor = "        q: asyncio.Queue = asyncio.Queue(maxsize=self.stream_buffer)\n"
    assert anchor in text
    src.write_text(text.replace(anchor, anchor.replace(
        "q: asyncio.Queue", "time.sleep(0.01)\n        q: asyncio.Queue"
    ), 1))
    found, _ = _lint(root)
    assert any("blocking-in-async" in f and "sleep" in f for f in found), \
        found


@pytest.mark.parametrize("rel", ["server.py", "aserver.py", "gossip.py"])
def test_no_inline_suppressions_in_the_port_router(rel):
    # the port's router earns its clean result without disabling a rule
    text = (REPO / "ome_tpu_torch" / "router" / rel).read_text()
    for rule in RULES:
        assert f"omelint: disable={rule}" not in text
