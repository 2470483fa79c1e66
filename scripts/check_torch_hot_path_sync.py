#!/usr/bin/env python3
"""Static decode-loop sync lint for the PyTorch port.

The torch counterpart of scripts/check_decode_sync.py, on the same
omelint call graph (ome_tpu/lint, used as it is): every function the
port's ``Scheduler.step`` reaches, outside the sanctioned drain sinks
(``_drain_inflight`` / ``_drain_spec`` / ``_drain_multi``, which read
tokens only after the next step was dispatched, and the grammar
compiler's host-only entry points), must not call a host-blocking
device read: ``.item()``, ``.cpu()``, ``.tolist()`` or
``torch.cuda.synchronize()``.

The graph resolves calls syntactically, and the scheduler reaches its
engine through ``self.engine.<op>(...)`` and the engine its model
through ``self.model(...)``, which name no class; each such call is
linked to ``InferenceEngine.<op>`` in engine/core.py, or to
``Llama.forward`` / ``Llama.<op>`` in models/llama.py (and so to what
they call), until nothing new is reached.

A finding that is sanctioned is listed in SANCTIONED by
(file, function, call) with its one-line reason. Exit 1 on any other
finding, 0 otherwise.

Usage: python scripts/check_torch_hot_path_sync.py [package dir]
"""

from __future__ import annotations

import ast
import pathlib
import sys
from typing import List, Set, Tuple

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ome_tpu.lint.callgraph import body_walk                  # noqa: E402
from ome_tpu.lint.context import Context                      # noqa: E402
from ome_tpu.lint.core import Project                         # noqa: E402
from ome_tpu.lint.plugins.hot_path_sync import ALLOWED        # noqa: E402

ROOT = "engine/scheduler.py::Scheduler.step"
# self.<attribute> -> the class its calls are linked to
RECEIVERS = {"engine": "engine/core.py::InferenceEngine",
             "model": "models/llama.py::Llama"}
SYNC_METHODS = frozenset(("item", "cpu", "tolist"))

# (file suffix, function qualname, call label) -> why it may sync
SANCTIONED = {
    ("models/llama.py", "_embed_scaled", ".item()"):
        "rounds a Python float through a CPU scalar of the model dtype; "
        "no device tensor is read",
}


def sync_label(call: ast.Call) -> str:
    """Non-empty label when `call` is a host-blocking device read."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return ""
    if func.attr in SYNC_METHODS:
        return f".{func.attr}()"
    if func.attr == "synchronize" and isinstance(func.value, ast.Attribute) \
            and func.value.attr == "cuda" \
            and isinstance(func.value.value, ast.Name) \
            and func.value.value.id == "torch":
        return "torch.cuda.synchronize()"
    return ""


def _linked_calls(fn: ast.AST) -> Set[str]:
    """Specs of the methods `fn`'s own `self.engine.X(...)`,
    `self.model(...)` and `self.model.X(...)` calls run."""
    out = set()
    for sub in body_walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        func, meth = sub.func, "forward"
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Attribute):
            func, meth = func.value, func.attr
        if isinstance(func, ast.Attribute) and func.attr in RECEIVERS \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self":
            out.add(f"{RECEIVERS[func.attr]}.{meth}")
    return out


def reach(project: Project) -> Set[str]:
    """Nodes `Scheduler.step` reaches, through the engine's ops and the
    model's forwards too."""
    graph = Context(project).graph
    roots = set(graph.resolve_spec(ROOT))
    while True:
        nodes = graph.reachable(sorted(roots), stop=set(ALLOWED))
        more = set()
        for node in nodes:
            rel, qual = node.split("::", 1)
            fn = project.file(rel).defs.get(qual)
            if fn is None or isinstance(fn, ast.ClassDef):
                continue
            for spec in _linked_calls(fn):
                more.update(graph.resolve_spec(spec))
        if more <= roots:
            return nodes
        roots |= more


def findings(root: pathlib.Path) -> List[Tuple[str, int, str, str]]:
    """(file, line, function, call) of each unsanctioned sync."""
    project = Project(root, repo=root.parent)
    out = []
    for node in sorted(reach(project)):
        rel, qual = node.split("::", 1)
        fn = project.file(rel).defs.get(qual)
        if fn is None or isinstance(fn, ast.ClassDef):
            continue
        for sub in body_walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            label = sync_label(sub)
            if label and not any(rel.endswith(f) and qual == q and label == c
                                 for f, q, c in SANCTIONED):
                out.append((rel, sub.lineno, qual, label))
    return sorted(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = pathlib.Path(argv[0]) if argv else REPO / "ome_tpu_torch"
    if not (root / "engine" / "scheduler.py").exists():
        print(f"check_torch_hot_path_sync: no engine/scheduler.py under "
              f"{root}", file=sys.stderr)
        return 2
    found = findings(root)
    for rel, line, qual, label in found:
        print(f"VIOLATION: {rel}:{line}: {label} in step-path function "
              f"{qual!r} forces a device->host sync between decode "
              "dispatches; read tokens in _drain_inflight (after the next "
              "dispatch) instead")
    print(f"check_torch_hot_path_sync: {root.name}, {len(found)} "
          "violation(s)")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
