"""Content-addressed chunk store — the xet-core equivalent.

Re-designs pkg/xet (Rust FFI binding to HuggingFace xet-core,
SURVEY.md §2.7): FastCDC chunking runs in the native C++
library (native/chunker.cc, loaded via ctypes) with a byte-identical
pure-Python fallback, and chunks live in a local content-addressed
store so repeated model downloads (revisions, fine-tunes sharing base
weights) only fetch bytes the node has never seen. The port loads the
same library (`native/libomechunk.so`, a host-side chunker, no device
code) at first use rather than at import.

Port of ome_tpu/storage/xet.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MIN_CHUNK = 16 << 10
AVG_CHUNK = 64 << 10  # power of two (FastCDC normalization)
MAX_CHUNK = 256 << 10

_LIB_PATHS = tuple(p for p in (
    os.path.join(os.environ.get("OME_NATIVE_DIR", ""), "libomechunk.so")
    if os.environ.get("OME_NATIVE_DIR") else None,
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libomechunk.so"),
    "libomechunk.so",
) if p)


def _load_native() -> Optional[ctypes.CDLL]:
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.sep in p else p)
        except OSError:
            continue
        lib.ome_hash64.restype = ctypes.c_uint64
        lib.ome_hash64.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ome_cdc_boundaries.restype = ctypes.c_size_t
        lib.ome_cdc_boundaries.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
        return lib
    return None


_native: Optional[ctypes.CDLL] = None
_native_tried = False


def _lib() -> Optional[ctypes.CDLL]:
    """The native chunker, loaded at first use rather than at import
    (None when no library loads: the Python path below is
    byte-identical)."""
    global _native, _native_tried
    if not _native_tried:
        _native = _load_native()
        _native_tried = True
    return _native


def native_available() -> bool:
    return _lib() is not None


# -- pure-python fallback (same splitmix64 gear table as chunker.cc) -------

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


_GEAR = [_splitmix64(i) for i in range(256)]


def hash64(data: bytes) -> int:
    lib = _lib()
    if lib is not None:
        return lib.ome_hash64(data, len(data))
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & _M64
    return h


def cdc_boundaries(data: bytes, min_size: int = MIN_CHUNK,
                   avg_size: int = AVG_CHUNK,
                   max_size: int = MAX_CHUNK) -> List[int]:
    """Chunk END offsets (ascending, last == len(data))."""
    if not data:
        return []
    lib = _lib()
    if lib is not None:
        cap = max(8, len(data) // min_size + 2)
        out = (ctypes.c_size_t * cap)()
        n = lib.ome_cdc_boundaries(data, len(data), min_size,
                                       avg_size, max_size, out, cap)
        return list(out[:n])
    mask_hard = (avg_size << 2) - 1
    mask_easy = (avg_size >> 2) - 1
    bounds: List[int] = []
    start, n = 0, len(data)
    while start < n:
        limit = min(start + max_size, n)
        avg_at = min(start + avg_size, limit)
        i = min(start + min_size, limit)
        fp = 0
        end = limit
        found = False
        while i < avg_at:
            fp = ((fp << 1) + _GEAR[data[i]]) & _M64
            if not (fp & mask_hard):
                end, found = i + 1, True
                break
            i += 1
        if not found:
            while i < limit:
                fp = ((fp << 1) + _GEAR[data[i]]) & _M64
                if not (fp & mask_easy):
                    end = i + 1
                    break
                i += 1
        bounds.append(end)
        start = end
    return bounds


# -- chunk store -----------------------------------------------------------

Manifest = List[Tuple[str, int]]  # [(chunk_hash_hex, length), ...]


def chunk_address(chunk: bytes) -> str:
    """Content address for a chunk. Cryptographic (xet-core uses blake3;
    blake2b is the stdlib equivalent) — a 64-bit rolling hash would
    silently substitute wrong bytes on collision in a long-lived store."""
    return hashlib.blake2b(chunk, digest_size=16).hexdigest()


@dataclass
class DedupStats:
    total_bytes: int = 0
    new_bytes: int = 0
    total_chunks: int = 0
    new_chunks: int = 0

    @property
    def dedup_ratio(self) -> float:
        if self.total_bytes == 0:
            return 0.0
        return 1.0 - self.new_bytes / self.total_bytes


class ChunkStore:
    """Content-addressed chunk directory + file manifests."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)

    def _chunk_path(self, h: str) -> str:
        return os.path.join(self.root, "chunks", h[:2], h)

    def has_chunk(self, h: str) -> bool:
        return os.path.exists(self._chunk_path(h))

    def put_chunk(self, h: str, data: bytes) -> bool:
        p = self._chunk_path(h)
        if os.path.exists(p):
            return False
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)
        return True

    def get_chunk(self, h: str) -> bytes:
        with open(self._chunk_path(h), "rb") as f:
            return f.read()

    # -- file-level API ------------------------------------------------

    def ingest(self, path: str, stats: Optional[DedupStats] = None,
               window: int = 64 << 20) -> Manifest:
        """Chunk a file into the store; returns its manifest.

        Streams in `window`-sized pieces so multi-GB weight shards never
        sit fully in memory. A boundary found inside the window is only
        final when the *next* chunk's full MAX_CHUNK lookahead is also in
        the window (or at EOF) — this makes streamed boundaries byte-
        identical to whole-file chunking, since a chunk's boundary only
        depends on the MAX_CHUNK bytes after its start.
        """
        stats = stats if stats is not None else DedupStats()
        manifest: Manifest = []

        def emit(chunk: bytes):
            h = chunk_address(chunk)
            new = self.put_chunk(h, chunk)
            manifest.append((h, len(chunk)))
            stats.total_bytes += len(chunk)
            stats.total_chunks += 1
            if new:
                stats.new_bytes += len(chunk)
                stats.new_chunks += 1

        with open(path, "rb") as f:
            buf = b""
            eof = False
            while not eof:
                data = f.read(window)
                eof = not data
                buf += data
                if not buf:
                    break
                start = 0
                for end in cdc_boundaries(buf):
                    if not eof and start + MAX_CHUNK > len(buf):
                        break  # incomplete lookahead: defer to next window
                    emit(buf[start:end])
                    start = end
                buf = buf[start:]
        return manifest

    def materialize(self, manifest: Manifest, dst: str) -> None:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        tmp = dst + ".part"
        with open(tmp, "wb") as f:
            for h, _ in manifest:
                f.write(self.get_chunk(h))
        os.replace(tmp, dst)

    def can_materialize(self, manifest: Manifest) -> bool:
        return all(self.has_chunk(h) for h, _ in manifest)

    # -- manifest persistence ------------------------------------------

    def _manifest_path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.root, "manifests", safe + ".json")

    def save_manifest(self, key: str, manifest: Manifest) -> None:
        with open(self._manifest_path(key), "w") as f:
            json.dump(manifest, f)

    def load_manifest(self, key: str) -> Optional[Manifest]:
        p = self._manifest_path(key)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return [tuple(e) for e in json.load(f)]
