"""Build and load the port's hand-written CUDA kernels.

Each source under `ops/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into its own shared library with a plain C interface, and
loaded with `ctypes`. Nothing here runs at import time: the first
launch of a kernel (or an explicit `build()`) compiles it into
`ome_tpu_torch/_build/`, keyed by a hash of the source, the shared
headers (`csrc/*.cuh`: `common.cuh`, and `decode_core.cuh` of the two
decode sources) and the flags, so an edited source or header
rebuilds and an unchanged one is loaded as is.
A failed compile raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

# kernel name -> source file under csrc/
SOURCES = {
    "flash_decode": "flash_decode.cu",
    "flash_prefill": "flash_prefill.cu",
    "flash_paged_decode": "flash_paged_decode.cu",
    "int4_matmul": "int4_matmul.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point and its argument types, per kernel
_SIGNATURES = {
    "flash_decode": ("ome_flash_decode",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    "flash_prefill": ("ome_flash_prefill",
                      [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]),
    "flash_paged_decode": ("ome_flash_paged_decode",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                            _I, _P]),
    "int4_matmul": ("ome_int4_matmul",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}
# nvcc's stderr (register and spill report) of builds in this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels are built from source "
                       "at first use")


def _lib_path(name: str) -> str:
    """Library path keyed by the source, every header under csrc/ (a
    source may include any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name]] + headers:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (all by default) that are not built
    yet, one nvcc process per source, all started together. Returns
    the wall seconds spent."""
    names = list(SOURCES if names is None else names)
    t0 = time.monotonic()
    todo = [(n, _lib_path(n)) for n in names
            if not os.path.exists(_lib_path(n))]
    if not todo:
        return time.monotonic() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        out, err = proc.communicate()
        build_logs[name] = (out or "") + (err or "")
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.monotonic() - t0


def kernel(name: str):
    """The ctypes entry point of a kernel, building it on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn
