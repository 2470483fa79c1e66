"""Program cost ledger: what each engine program moves and computes.

Port of ome_tpu/perf/ledger.py. The reference asks XLA, ahead of time,
what each compiled program costs (`cost_analysis`, `memory_analysis`).
PyTorch has no compiler to ask, so the port's "full" mode measures by
running: the first dispatch of each program key runs under
`FlopCounter`, which counts as `torch.utils.flop_counter.FlopCounterMode`
does, and the entry records

  * `flops` — COUNTED: the products the counter sees (matmuls,
    attention's plain products on the CPU) plus each hand-written CUDA
    kernel's own FLOPs, which its wrapper reports (`ops/flash.py`
    `count_kernel_flops`: a ctypes launch is invisible to the counter),
    with the formula chip_smoke's kernel bounds use;
  * `argument_bytes` / `output_bytes` — COUNTED: bytes of the tensors
    the dispatch was given (weights, cache, inputs) and returned;
  * `bytes` — MODELLED: the engine's analytic byte model (weights read
    `weight_passes` times plus the KV rows addressed), because nothing
    in torch measures the bytes a program accesses;
  * `temp_bytes` — None: reading it would mean resetting the caching
    allocator's peak, which the HBM accountant (perf/hbm.py) reads;

flagged `source: "counted"`. In "model" mode (and whenever counting
fails, with one warning) the entry keeps the analytic numbers,
`source: "model"`. A modelled number is never labelled measured.

Where the reference captures BEFORE the dispatch (it lowers the
program ahead of time), the port's capture WRAPS it: `capture` runs
the dispatch and returns its result, counting only on the first
dispatch of a key; later dispatches of that key bump `dispatches`.

Expected ms is the roofline max of the memory and compute terms
against the device table below, which chip_smoke's kernel bounds read
too. Surfaces: GET /debug/programs (guarded by --debug-endpoints),
`ome_engine_program_flops` / `ome_engine_program_bytes` gauges, attrs
on `engine.decode_chunk` spans, and the POST /debug/profile response.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Per-device HBM bandwidth (GB/s) and bf16 dense peak (TFLOP/s). The
# TPU rows are the reference's; the H100 row is NVIDIA's data sheet for
# the SXM part (3.35 TB/s HBM3, 989 TFLOP/s dense bf16), which
# chip_smoke's kernel bounds read from here. An unknown CUDA card falls
# back to the H100 row, as the reference falls back to v5e.
DEVICE_HBM_GBPS = {"v5 lite": 819.0, "v5e": 819.0, "v5p": 2765.0,
                   "v6e": 1640.0, "v4": 1228.0, "h100": 3350.0,
                   "cpu": 50.0}
DEVICE_PEAK_TFLOPS = {"v5 lite": 197.0, "v5e": 197.0, "v5p": 459.0,
                      "v6e": 918.0, "v4": 275.0, "h100": 989.0,
                      "cpu": 0.2}
# the row an unknown CUDA card reads
CUDA_FALLBACK = "h100"

LEDGER_MODES = ("auto", "full", "model", "off")

log = logging.getLogger("ome.perf.ledger")


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


# shape and layout queries, which FlopCounterMode leaves to the tensor
# (those this torch has: the list grew across versions)
_QUERY_OPS = ("aten.sym_is_contiguous.default", "aten.is_contiguous.default",
              "aten.is_contiguous.memory_format",
              "aten.is_strides_like_format.default",
              "aten.is_non_overlapping_and_dense.default",
              "aten.size.default", "aten.sym_size.default",
              "aten.stride.default", "aten.sym_stride.default",
              "aten.storage_offset.default",
              "aten.sym_storage_offset.default", "aten.numel.default",
              "aten.sym_numel.default", "aten.dim.default",
              "prim.layout.default")


@functools.lru_cache(maxsize=1)
def _query_ops() -> frozenset:
    out = set()
    for name in _QUERY_OPS:
        ns, packet, overload = name.split(".")
        op = getattr(getattr(getattr(torch.ops, ns), packet, None),
                     overload, None)
        if op is not None:
            out.add(op)
    return frozenset(out)


class FlopCounter(TorchDispatchMode):
    """FLOPs of the aten ops dispatched inside it, counted as
    `torch.utils.flop_counter.FlopCounterMode` counts them: an op is
    first decomposed where it has a decomposition, then run, and its
    packet's formula in `flop_registry` (the same formulas) adds its
    count. Unlike FlopCounterMode, its `__torch_dispatch__` is not
    wrapped in dynamo's disable (see below), so its first use imports
    no `torch._dynamo`, which took seconds of every new engine process
    on the card. The port never compiles, so the wrapper guards
    nothing here."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if func in _query_ops():
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


# TorchDispatchMode wraps every subclass's __torch_dispatch__ in
# torch._disable_dynamo (where this torch does), whose first call
# imports torch._dynamo; the function it wraps is kept as __wrapped__
FlopCounter.__torch_dispatch__ = getattr(
    FlopCounter.__torch_dispatch__, "__wrapped__",
    FlopCounter.__torch_dispatch__)


def device_spec(device=None) -> Dict[str, object]:
    """{kind, platform, hbm_gbps, peak_tflops} for `device` (default:
    the first card, else the CPU). The kind is the card's name as
    `torch.cuda.get_device_name` gives it, lowercased (e.g. "nvidia
    h100 80gb hbm3"); rows match by substring, an unknown card reads
    the H100 row."""
    dev = _default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        kind, platform = torch.cuda.get_device_name(dev).lower(), "gpu"
    else:
        kind, platform = "cpu", "cpu"

    def _lookup(table):
        for key, val in table.items():
            if key in kind:
                return val
        return table["cpu" if platform == "cpu" else CUDA_FALLBACK]

    return {"kind": kind, "platform": platform,
            "hbm_gbps": _lookup(DEVICE_HBM_GBPS),
            "peak_tflops": _lookup(DEVICE_PEAK_TFLOPS)}


def roofline_ms(flops: float, bytes_moved: float, hbm_gbps: float,
                peak_tflops: float) -> float:
    """Expected program ms at the roofline: the slower of streaming
    `bytes_moved` at spec bandwidth and computing `flops` at peak."""
    mem_s = bytes_moved / max(hbm_gbps * 1e9, 1e-9)
    compute_s = flops / max(peak_tflops * 1e12, 1e-9)
    return max(mem_s, compute_s) * 1000.0


def tensor_bytes(tree, seen=None) -> int:
    """Bytes of the distinct tensors in `tree` (nested tuples, lists,
    dicts, dataclasses, modules' parameters and buffers)."""
    seen = set() if seen is None else seen
    if isinstance(tree, torch.Tensor):
        key = (tree.data_ptr(), tree.numel(), tree.dtype)
        if key in seen:
            return 0
        seen.add(key)
        return tree.numel() * tree.element_size()
    if isinstance(tree, torch.nn.Module):
        return sum(tensor_bytes(t, seen) for t in
                   list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, dict):
        return sum(tensor_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v, seen) for v in tree)
    fields = getattr(tree, "__dataclass_fields__", None)
    if fields is not None:
        return sum(tensor_bytes(getattr(tree, f), seen) for f in fields)
    return 0


class ProgramLedger:
    """One entry per engine program key (name + static description),
    created at its first dispatch; repeats only bump the dispatch
    count.

    mode: "auto" = counted ("full") on a CUDA device, the analytic
    model elsewhere (a CPU run's counts would describe the CPU plain
    versions, not the card serving runs on); "full"/"model" force a
    path (tests force "full" on tiny CPU models); "off" records
    nothing. `device` is the engine's (the engine sets it when it is
    None): it picks the auto mode and the device table's row.
    """

    def __init__(self, mode: str = "auto", device=None):
        if mode not in LEDGER_MODES:
            raise ValueError(
                f"ledger mode {mode!r} not in {LEDGER_MODES}")
        self.mode = mode
        self.flight = None
        self.device = None if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        # the last dispatch of each thread: the scheduler thread reads
        # its decode's entry while the admission thread prefills
        self._last = threading.local()
        self._g_flops = None
        self._g_bytes = None
        self._spec: Optional[dict] = None
        self._warned = False

    # -- wiring --------------------------------------------------------

    def bind(self, registry, flight=None) -> None:
        """Attach the serving registry (and optionally the flight
        ring) after construction — the scheduler owns both and the
        engine is built first. Entries captured before the bind are
        exported retroactively."""
        # program label values are program keys — bounded by the
        # engine's buckets and step plans
        self._g_flops = registry.gauge(
            "ome_engine_program_flops",
            "FLOPs per dispatch of each engine program, counted as "
            "FlopCounterMode counts plus the CUDA kernels' own counts (or "
            "the analytic model off the card)", labelnames=("program",))
        self._g_bytes = registry.gauge(
            "ome_engine_program_bytes",
            "HBM bytes moved per dispatch of each engine program, from "
            "the analytic byte model (weights + KV rows addressed)",
            labelnames=("program",))
        if flight is not None:
            self.flight = flight
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            self._export(e)

    def device_spec(self) -> Dict[str, object]:
        if self._spec is None:
            self._spec = device_spec(self.device)
        return self._spec

    # -- capture -------------------------------------------------------

    def prepare(self) -> None:
        """Pay the counter's one-time set-up now, when the engine is
        built, and not inside a request's first dispatch (the formulas'
        import, and the first products on the device). Does nothing
        unless the ledger counts."""
        if self._resolved_mode() != "full":
            return
        try:
            x = torch.ones(2, 2, device=self.device or _default_device())
            with FlopCounter():
                x @ x
        except Exception as e:  # noqa: BLE001 - observability only
            self._warn_once("prepare", "(set-up)", e)

    def _resolved_mode(self) -> str:
        if self.mode != "auto":
            return self.mode
        dev = self.device or _default_device()
        return "full" if dev.type == "cuda" else "model"

    def capture(self, name: str, static_desc: str, fn, args,
                model: Dict[str, float]):
        """Run the dispatch of program `name` (static arguments
        described by `static_desc`, e.g. "n=8") as `fn()` and return
        its result. `args` are
        the tensors the dispatch reads (weights, cache, inputs), whose
        bytes a counted entry records; `model` is the engine's
        analytic {flops, bytes} estimate. The first dispatch of a key
        creates its entry — counted in "full" mode — and later ones
        bump its dispatch count; `last_dispatch()` gives the entry. An
        error of the dispatch itself propagates; the ledger's own
        failures never do."""
        if self.mode == "off":
            return fn()
        key = f"{name}[{static_desc}]" if static_desc else name
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry["dispatches"] += 1
                self._last.entry = entry
        if entry is not None:
            return fn()
        try:
            entry = self._new_entry(key, name, static_desc, model)
            full = self._resolved_mode() == "full"
        except Exception:  # noqa: BLE001 - observability only
            log.debug("ledger entry failed for %s", key, exc_info=True)
            return fn()
        out = self._counted(entry, fn, args) if full else fn()
        try:
            self._record(key, entry)
        except Exception:  # noqa: BLE001 - observability only
            log.debug("ledger record failed for %s", key, exc_info=True)
        return out

    def _record(self, key: str, entry: dict) -> None:
        spec = self.device_spec()
        entry["expected_ms"] = roofline_ms(
            entry["flops"], entry["bytes"], spec["hbm_gbps"],
            spec["peak_tflops"])
        with self._lock:
            entry = self._entries.setdefault(key, entry)
            entry["dispatches"] += 1
            self._last.entry = entry
        self._export(entry)
        if self.flight is not None:
            self.flight.record(
                "program_captured", program=key,
                source=entry["source"],
                expected_ms=entry["expected_ms"],
                bytes=entry["bytes"], flops=entry["flops"])

    def _new_entry(self, key, name, static_desc, model) -> dict:
        return {
            "program": key,
            "name": name,
            "static": static_desc,
            "source": "model",
            "flops": float(model.get("flops", 0.0)),
            "bytes": float(model.get("bytes", 0.0)),
            "argument_bytes": None,
            "output_bytes": None,
            "temp_bytes": None,
            "device": self.device_spec()["kind"],
            "dispatches": 0,
            "captured_unix": time.time(),
        }

    def _counted(self, entry, run, args):
        """Run the first dispatch under FlopCounter and the kernel
        FLOP sink; any failure to count leaves the analytic numbers in
        place (never break a dispatch over observability)."""
        from ..ops.flash import count_kernel_flops
        stack = contextlib.ExitStack()
        try:
            counter = stack.enter_context(FlopCounter())
            sink = stack.enter_context(count_kernel_flops())
        except Exception as e:  # noqa: BLE001 - observability only
            stack.close()
            self._warn_once("count", entry["program"], e)
            return run()
        with stack:
            out = run()
        try:
            flops = counter.flops + sum(int(c()) for c in sink)
            entry["flops"] = float(flops)
            entry["argument_bytes"] = tensor_bytes(args)
            entry["output_bytes"] = tensor_bytes(out)
            entry["source"] = "counted"
        except Exception as e:  # noqa: BLE001 - observability only
            self._warn_once("count", entry["program"], e)
        return out

    def _warn_once(self, stage, program, exc) -> None:
        if not self._warned:
            self._warned = True
            log.warning("ledger counting (%s) failed for %s: %s "
                        "— keeping the analytic model estimate",
                        stage, program, exc)

    # -- reads ---------------------------------------------------------

    def last_dispatch(self) -> Optional[dict]:
        """The entry of the calling thread's most recent dispatch — the
        scheduler reads its bytes for the online roofline right after
        the engine call returns."""
        return getattr(self._last, "entry", None)

    def snapshot(self) -> List[dict]:
        """Entry copies in first-dispatch order (the /debug/programs
        body)."""
        with self._lock:
            return [dict(e) for e in self._entries.values()]

    def summary(self) -> List[dict]:
        """Compact {program, expected_ms, source} list — rides along
        in the POST /debug/profile response."""
        with self._lock:
            return [{"program": e["program"],
                     "expected_ms": round(e["expected_ms"], 4),
                     "source": e["source"]}
                    for e in self._entries.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _export(self, entry) -> None:
        if self._g_flops is None:
            return
        self._g_flops.labels(program=entry["program"]).set(
            entry["flops"])
        self._g_bytes.labels(program=entry["program"]).set(
            entry["bytes"])
