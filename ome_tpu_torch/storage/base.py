"""Storage provider interface.

Re-designs pkg/storage/interfaces.go:25-150 (Storage / MultipartCapable
/ BulkStorage): a uniform surface over object stores, the HF hub, PVCs
and local paths, consumed by the model-agent's download workers and the
replica tooling.

Port of ome_tpu/storage/base.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import abc
import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

ProgressFn = Callable[[str, int, int], None]  # (object_name, done, total)


@dataclass
class ObjectInfo:
    name: str
    size: int = 0
    etag: str = ""


class UnsafeObjectName(ValueError):
    """A server-supplied name tried to escape the download root."""


def safe_join(root: str, rel: str) -> str:
    """Join a server-supplied relative name under root, rejecting
    absolute paths and '..' escapes (hfutil/hub/download.go:129-130
    applies the same rule to hub-listed rfilenames). A malicious
    listing must not be able to write outside the model directory of
    the node daemon."""
    if rel.startswith("/"):
        raise UnsafeObjectName(f"absolute object name: {rel!r}")
    if os.name == "nt" and (rel.startswith("\\")
                            or (len(rel) > 1 and rel[1] == ":")):
        # drive-letter / UNC escapes only mean something on Windows;
        # on POSIX 'a:b' and '\\notes' are legal filenames
        raise UnsafeObjectName(f"absolute object name: {rel!r}")
    # compare absolute forms so a relative root like '.' works too
    root_a = os.path.abspath(root)
    p_a = os.path.abspath(os.path.join(root, rel))
    if p_a == root_a or os.path.commonpath([p_a, root_a]) != root_a:
        raise UnsafeObjectName(f"object name escapes target dir: {rel!r}")
    return os.path.normpath(os.path.join(root, rel))


class ShortDownload(IOError):
    """Bytes on disk after a download don't match the expected size."""


def drain_response_to_file(resp, path: str, offset: int,
                           name: str = "", total: int = 0,
                           chunk_size: int = 1 << 20,
                           progress: Optional[ProgressFn] = None) -> int:
    """Shared streaming read loop: copy an HTTP response body to `path`
    (appending at `offset` when resuming a 206), reporting progress.
    Returns bytes now on disk. Used by both the hub client and the
    S3-compat provider so the resume/verify behavior cannot diverge."""
    done = offset
    with open(path, "ab" if offset else "wb") as f:
        while True:
            buf = resp.read(chunk_size)
            if not buf:
                break
            f.write(buf)
            done += len(buf)
            if progress:
                progress(name, done, total or done)
    return done


class Storage(abc.ABC):
    """download/upload move whole object trees; get/put move bytes."""

    @abc.abstractmethod
    def list(self, prefix: str = "") -> List[ObjectInfo]:
        ...

    @abc.abstractmethod
    def get(self, name: str) -> bytes:
        ...

    @abc.abstractmethod
    def put(self, name: str, data: bytes) -> None:
        ...

    @abc.abstractmethod
    def exists(self, name: str) -> bool:
        ...

    def get_to_file(self, name: str, path: str,
                    progress: Optional[ProgressFn] = None,
                    total: int = 0, etag: str = "") -> int:
        """Fetch one object to a local path. The base implementation
        buffers via get(); providers that can stream (HTTP ranged
        reads) override this so multi-GB shards never sit in memory
        (pkg/ociobjectstore streams to disk the same way). `etag`
        lets streaming providers version-validate a resumed partial."""
        data = self.get(name)
        with open(path, "wb") as f:
            f.write(data)
        if progress:
            progress(name, len(data), total or len(data))
        return len(data)

    def download(self, target_dir: str, prefix: str = "",
                 progress: Optional[ProgressFn] = None,
                 workers: int = 4,
                 objects: Optional[List[ObjectInfo]] = None) -> List[str]:
        """Mirror the remote tree under target_dir; resumable by
        default (existing files with matching size are skipped).
        Pass `objects` to reuse an already-fetched listing — avoids a
        second paginated list sweep (and listing skew) per attempt."""
        import concurrent.futures as cf

        objs = self.list(prefix) if objects is None else objects
        os.makedirs(target_dir, exist_ok=True)

        def fetch(o: ObjectInfo) -> str:
            rel = o.name[len(prefix):].lstrip("/") if prefix else o.name
            dst = safe_join(target_dir, rel)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            if os.path.exists(dst) and os.path.getsize(dst) == o.size:
                if progress:
                    progress(o.name, o.size, o.size)
                return dst
            tmp = dst + ".part"
            self.get_to_file(o.name, tmp, progress=progress, total=o.size,
                             etag=o.etag)
            os.replace(tmp, dst)  # tmp-and-move (hub/download.go:274)
            return dst

        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fetch, objs))

    def upload(self, source_dir: str, prefix: str = "",
               workers: int = 4) -> List[str]:
        import concurrent.futures as cf

        paths = []
        for root, _, files in os.walk(source_dir):
            for fn in files:
                paths.append(os.path.join(root, fn))

        def push(p: str) -> str:
            rel = os.path.relpath(p, source_dir)
            name = f"{prefix.rstrip('/')}/{rel}" if prefix else rel
            with open(p, "rb") as f:
                self.put(name, f.read())
            return name

        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(push, paths))


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_tree(target_dir: str, expected: Iterable[ObjectInfo]) -> List[str]:
    """Downloaded-file verification (gopher.go:876 behavior): every
    expected object exists with the expected size; returns failures."""
    bad = []
    for o in expected:
        p = os.path.join(target_dir, o.name)
        if not os.path.exists(p):
            bad.append(f"{o.name}: missing")
        elif o.size and os.path.getsize(p) != o.size:
            bad.append(f"{o.name}: size {os.path.getsize(p)} != {o.size}")
    return bad
