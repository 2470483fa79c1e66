"""The PyTorch port stands alone: no JAX, no ome_tpu, no build at import.

Every module of `ome_tpu_torch/` and `chip_smoke.py` is parsed and its
imports checked: nothing of `jax`, `jaxlib` or `ome_tpu` (the package
`ome_tpu_torch` itself is of course allowed), and `chip_smoke.py`
imports no `transformers` and no `cryptography`, which the card's
machine lacks. Importing the port — the kernel module included — must
neither build a kernel nor pull in JAX, and importing the weight plane,
storage, the config parser or the agent loads no torch.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ome_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "ome_tpu"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_files_found():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    for must in ("ome_tpu_torch/ops/flash.py", "ome_tpu_torch/ops/paged.py",
                 "ome_tpu_torch/ops/int4_matmul.py",
                 "ome_tpu_torch/models/quant.py",
                 "ome_tpu_torch/models/lora.py",
                 "ome_tpu_torch/models/mla.py",
                 "ome_tpu_torch/engine/core.py",
                 "ome_tpu_torch/engine/embed.py",
                 "ome_tpu_torch/engine/serve.py",
                 "ome_tpu_torch/engine/sharded.py",
                 "ome_tpu_torch/engine/multihost.py",
                 "ome_tpu_torch/parallel/mesh.py",
                 "ome_tpu_torch/parallel/sharding.py",
                 "ome_tpu_torch/parallel/comm.py",
                 "ome_tpu_torch/perf/__init__.py",
                 "ome_tpu_torch/perf/ledger.py",
                 "ome_tpu_torch/perf/hbm.py",
                 "ome_tpu_torch/telemetry/profiler.py",
                 "ome_tpu_torch/telemetry/export.py",
                 "ome_tpu_torch/router/__init__.py",
                 "ome_tpu_torch/router/__main__.py",
                 "ome_tpu_torch/router/server.py",
                 "ome_tpu_torch/router/aserver.py",
                 "ome_tpu_torch/router/gossip.py",
                 "ome_tpu_torch/slo/__init__.py",
                 "ome_tpu_torch/slo/spec.py",
                 "ome_tpu_torch/slo/engine.py",
                 "ome_tpu_torch/slo/rollup.py",
                 "ome_tpu_torch/autoscale/__init__.py",
                 "ome_tpu_torch/autoscale/scrape.py",
                 "ome_tpu_torch/autoscale/policy.py",
                 "ome_tpu_torch/autoscale/trace.py",
                 "ome_tpu_torch/autoscale/replay.py",
                 "ome_tpu_torch/autoscale/pool.py",
                 "ome_tpu_torch/autoscale/controller.py",
                 "ome_tpu_torch/autoscale/fleet.py",
                 "ome_tpu_torch/chaos.py",
                 "ome_tpu_torch/core/__init__.py",
                 "ome_tpu_torch/core/errors.py",
                 "ome_tpu_torch/core/serde.py",
                 "ome_tpu_torch/core/meta.py",
                 "ome_tpu_torch/core/client.py",
                 "ome_tpu_torch/core/k8s.py",
                 "ome_tpu_torch/core/kubeclient.py",
                 "ome_tpu_torch/cmd/__init__.py",
                 "ome_tpu_torch/cmd/manager.py",
                 "ome_tpu_torch/apis/__init__.py",
                 "ome_tpu_torch/apis/v1/__init__.py",
                 "ome_tpu_torch/apis/v1/model.py",
                 "ome_tpu_torch/storage/__init__.py",
                 "ome_tpu_torch/storage/uri.py",
                 "ome_tpu_torch/storage/base.py",
                 "ome_tpu_torch/storage/providers.py",
                 "ome_tpu_torch/storage/signing.py",
                 "ome_tpu_torch/storage/extra_providers.py",
                 "ome_tpu_torch/storage/hub.py",
                 "ome_tpu_torch/storage/xet.py",
                 "ome_tpu_torch/hfconfig/__init__.py",
                 "ome_tpu_torch/hfconfig/parser.py",
                 "ome_tpu_torch/modelagent/__init__.py",
                 "ome_tpu_torch/modelagent/metrics.py",
                 "ome_tpu_torch/modelagent/weightplane.py",
                 "ome_tpu_torch/agent/__init__.py",
                 "ome_tpu_torch/agent/__main__.py",
                 "ome_tpu_torch/agent/cli.py",
                 "ome_tpu_torch/agent/metadata.py",
                 "ome_tpu_torch/agent/replica.py",
                 "ome_tpu_torch/agent/serving_agent.py",
                 "ome_tpu_torch/agent/enigma.py",
                 "ome_tpu_torch/agent/cloudkms.py", "chip_smoke.py"):
        assert must in names


def test_checker_tells_the_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import ome_tpu_torch.ops\nfrom ome_tpu_torch import x\n"
                   "import ome_tpu.engine\nfrom jax import numpy\n")
    roots = [r for r, _ in _imported_roots(src)]
    assert [r for r in roots if r in FORBIDDEN] == ["ome_tpu", "jax"]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_chip_smoke_imports_no_transformers():
    # the card's machine has no transformers: the script types configs in
    bad = [(root, line) for root, line in _imported_roots(
        REPO / "chip_smoke.py") if root == "transformers"]
    assert not bad, f"chip_smoke.py imports {bad}"


def test_chip_smoke_imports_no_cryptography():
    # nor cryptography, enigma's backend: the script leaves enigma alone
    bad = [(root, line) for root, line in _imported_roots(
        REPO / "chip_smoke.py") if root == "cryptography"]
    assert not bad, f"chip_smoke.py imports {bad}"


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_importing_the_port_builds_nothing_and_loads_no_jax():
    code = (
        "import os, sys\n"
        "from ome_tpu_torch.ops import _build\n"
        "before = sorted(os.listdir(_build.BUILD_DIR)) "
        "if os.path.isdir(_build.BUILD_DIR) else []\n"
        "import ome_tpu_torch.ops.flash, ome_tpu_torch.ops.attention\n"
        "import ome_tpu_torch.ops.paged, ome_tpu_torch.models.llama\n"
        "import ome_tpu_torch.ops.int4_matmul, ome_tpu_torch.models.quant\n"
        "import ome_tpu_torch.engine.serve, ome_tpu_torch.engine.server\n"
        "import ome_tpu_torch.engine.scheduler, ome_tpu_torch.engine.core\n"
        "import ome_tpu_torch.router.server, ome_tpu_torch.router.aserver\n"
        "import ome_tpu_torch.router.gossip, ome_tpu_torch.slo.rollup\n"
        "import ome_tpu_torch.autoscale.scrape, ome_tpu_torch.core.kubeclient\n"
        "import ome_tpu_torch.cmd.manager\n"
        "after = sorted(os.listdir(_build.BUILD_DIR)) "
        "if os.path.isdir(_build.BUILD_DIR) else []\n"
        "assert before == after, (before, after)\n"
        "assert not _build._loaded and not _build.build_logs\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ome_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_weight_plane_and_agent_import_no_torch():
    """The weight plane and the agent run in init containers and
    sidecars: importing them loads neither torch nor JAX nor ome_tpu
    (nor enigma's cryptography, whose exports resolve lazily)."""
    code = (
        "import sys\n"
        "import ome_tpu_torch.storage, ome_tpu_torch.hfconfig\n"
        "import ome_tpu_torch.modelagent.weightplane, ome_tpu_torch.agent\n"
        "import ome_tpu_torch.agent.cli, ome_tpu_torch.agent.serving_agent\n"
        "import ome_tpu_torch.agent.replica, ome_tpu_torch.agent.metadata\n"
        "import ome_tpu_torch.apis.v1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'cryptography') or (m.startswith("
        "'ome_tpu') and not m.startswith('ome_tpu_torch'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chaos_harness_loads_nothing_of_the_reference_at_run_time():
    """The AST check above cannot see a module loaded by file path (the
    reference's harness loads scripts/check_fault_points.py, which
    imports ome_tpu.lint): run the port's preflight, build a runner and
    the closed loop's pieces, and look at what is loaded."""
    code = (
        "import sys, tempfile, pathlib\n"
        "from ome_tpu_torch import chaos\n"
        "from ome_tpu_torch.autoscale import controller, fleet, pool, "
        "replay\n"
        "chaos.preflight_fault_points(['engine_step.raise@2', "
        "'pd_fetch|http://x:1.raise@1 pd_insert.raise@3'])\n"
        "base = pathlib.Path(tempfile.mkdtemp())\n"
        "topo = chaos.Topology(prefill=0, decode=0, unified=1, "
        "kv_block=32)\n"
        "chaos.ChaosRunner(topo, base / 'c', device='cpu').close()\n"
        "try:\n"
        "    chaos.ChaosRunner(topo, base / 'g', device='cuda')\n"
        "except chaos.ChaosError:\n"
        "    pass\n"
        "fleet.ModelFleet(None, base / 'f', 1, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') or (m.startswith('ome_tpu') and "
        "not m.startswith('ome_tpu_torch'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs a host "
                    "without one")
    proc = _run("import runpy, sys; sys.argv = ['chip_smoke.py']; "
                "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
