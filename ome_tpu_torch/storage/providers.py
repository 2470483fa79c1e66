"""Storage providers: local/PVC filesystem, S3/GCS-compatible HTTP
object stores.

Re-designs pkg/storage/providers + pkg/ociobjectstore: the filesystem
provider backs local:// and pvc:// (a mounted claim is just a path),
and one HTTP provider speaks the S3-compatible wire protocol (ranged
GET, list-objects-v2) that S3, GCS (XML API) and OCI Object Storage's
S3-compat endpoint all expose — multi-cloud via one code path instead
of three SDKs.

Port of ome_tpu/storage/providers.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import http.client
import os
import shutil
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from .base import (ObjectInfo, ShortDownload, Storage, UnsafeObjectName,
                   drain_response_to_file, safe_join)
from .uri import StorageComponents, StorageType, StorageURIError


class LocalStorage(Storage):
    """local:// and pvc:// (mounted at a root dir)."""

    def __init__(self, root: str):
        self.root = root

    def _p(self, name: str) -> str:
        rel = name.lstrip("/")
        if not rel or os.path.normpath(
                os.path.join(self.root, rel)) == os.path.normpath(self.root):
            return os.path.normpath(self.root)  # the root itself is fine
        try:
            return safe_join(self.root, rel)
        except UnsafeObjectName as e:
            raise StorageURIError(str(e)) from e

    def list(self, prefix: str = "") -> List[ObjectInfo]:
        base = self._p(prefix) if prefix else self.root
        out: List[ObjectInfo] = []
        if os.path.isfile(base):
            rel = os.path.relpath(base, self.root)
            return [ObjectInfo(rel, os.path.getsize(base))]
        for root, _, files in os.walk(base):
            for fn in sorted(files):
                p = os.path.join(root, fn)
                out.append(ObjectInfo(os.path.relpath(p, self.root),
                                      os.path.getsize(p)))
        out.sort(key=lambda o: o.name)
        return out

    def get(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    def put(self, name: str, data: bytes) -> None:
        p = self._p(name)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        tmp = p + ".part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def download(self, target_dir: str, prefix: str = "", progress=None,
                 workers: int = 4, objects=None) -> List[str]:
        # same-filesystem fast path: reflink/copy instead of read+write
        objs = self.list(prefix) if objects is None else objects
        out = []
        for o in objs:
            rel = o.name[len(prefix):].lstrip("/") if prefix else o.name
            dst = safe_join(target_dir, rel)
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            src = self._p(o.name)
            if not (os.path.exists(dst)
                    and os.path.getsize(dst) == o.size):
                shutil.copy2(src, dst)
            if progress:
                progress(o.name, o.size, o.size)
            out.append(dst)
        return out


class S3CompatStorage(Storage):
    """S3-compatible object store over plain HTTP(S).

    Covers s3://, gcs:// (XML API) and oci:// (S3-compat endpoint).
    Auth rides request signing headers supplied by a credentials hook —
    in-cluster deployments use workload identity so unsigned requests
    with an auth proxy sidecar are the norm for this build.
    """

    def __init__(self, endpoint: str, bucket: str,
                 headers: Optional[Dict[str, str]] = None,
                 retries: int = 4, backoff: float = 0.2,
                 signer=None):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.headers = headers or {}
        self.retries = retries
        self.backoff = backoff
        self.signer = signer  # storage/signing.py: SigV4 or GCS bearer

    def _signed(self, url: str, method: str,
                headers: Dict[str, str],
                payload: bytes = b"") -> Dict[str, str]:
        if self.signer is None:
            return headers
        return self.signer.sign(method, url, headers, payload)

    # -- http helpers --------------------------------------------------

    def _url(self, path: str = "", query: str = "") -> str:
        u = f"{self.endpoint}/{self.bucket}"
        if path:
            u += "/" + urllib.parse.quote(path.lstrip("/"))
        if query:
            u += "?" + query
        return u

    def _request(self, url: str, data: Optional[bytes] = None,
                 method: Optional[str] = None,
                 extra: Optional[Dict[str, str]] = None) -> bytes:
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            base = {**self.headers, **(extra or {})}
            req = urllib.request.Request(
                url, data=data, method=method,
                headers=self._signed(url, method or
                                     ("PUT" if data is not None
                                      else "GET"), base, data or b""))
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                if e.code in (429, 500, 502, 503, 504):
                    last = e
                else:
                    raise
            except urllib.error.URLError as e:
                last = e
            time.sleep(self.backoff * (2 ** attempt))
        raise last  # type: ignore[misc]

    # -- Storage -------------------------------------------------------

    def list(self, prefix: str = "") -> List[ObjectInfo]:
        out: List[ObjectInfo] = []
        token = ""
        while True:
            q = "list-type=2"
            if prefix:
                q += "&prefix=" + urllib.parse.quote(prefix)
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token)
            body = self._request(self._url(query=q))
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                key = c.findtext(f"{ns}Key") or ""
                size = int(c.findtext(f"{ns}Size") or 0)
                etag = (c.findtext(f"{ns}ETag") or "").strip('"')
                out.append(ObjectInfo(key, size, etag))
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            if not token:
                break
        return out

    def get(self, name: str) -> bytes:
        return self._request(self._url(name))

    def get_to_file(self, name: str, path: str, progress=None,
                    total: int = 0, etag: str = "",
                    chunk_size: int = 1 << 20) -> int:
        """Stream an object directly to disk with ranged-GET resume:
        a retry continues from the bytes already on disk instead of
        re-buffering the whole object in memory. The final byte count
        is verified against the expected size (`total` from the
        listing, else Content-Length/Content-Range) so a truncated
        body can never be installed as a complete object. When the
        listing supplied an ETag it rides If-Range, so a resume against
        a re-uploaded object gets the full new body (200) instead of
        splicing old-version and new-version bytes."""
        url = self._url(name)
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            offset = os.path.getsize(path) if os.path.exists(path) else 0
            if total and offset == total and not etag:
                return offset  # crashed after the drain: already complete
            extra = {}
            if offset:
                extra["Range"] = f"bytes={offset}-"
                if etag:
                    extra["If-Range"] = f'"{etag}"'
            req = urllib.request.Request(
                url, headers=self._signed(url, "GET",
                                          {**self.headers, **extra}))
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    if offset and resp.getcode() != 206:
                        offset = 0  # server ignored Range: restart clean
                    length = int(resp.headers.get("Content-Length") or 0)
                    # Content-Range total is authoritative on a 206
                    crange = resp.headers.get("Content-Range") or ""
                    cr_total = int(crange.rsplit("/", 1)[-1]) \
                        if "/" in crange and crange.rsplit("/", 1)[-1].isdigit() \
                        else 0
                    full = total or cr_total or offset + length
                    done = drain_response_to_file(
                        resp, path, offset, name=name, total=full,
                        chunk_size=chunk_size, progress=progress)
                if full and done != full:
                    # .part keeps the bytes; next attempt Range-resumes
                    last = ShortDownload(
                        f"{name}: got {done} bytes, expected {full}")
                else:
                    return done
            except urllib.error.HTTPError as e:
                if e.code == 416 and offset:
                    if total and offset == total:
                        # complete .part whose version the If-Range etag
                        # just validated (a changed object returns 200)
                        return offset
                    # stale/oversized partial (e.g. from an older object
                    # version): never trust it — restart clean
                    os.remove(path)
                    last = e
                elif e.code not in (429, 500, 502, 503, 504):
                    raise
                else:
                    last = e
            except (urllib.error.URLError, http.client.HTTPException,
                    OSError) as e:
                # URLError covers connect failures; HTTPException
                # (IncompleteRead) and OSError (reset, timeout) cover
                # mid-body failures — all resume from the .part
                last = e
            time.sleep(self.backoff * (2 ** attempt))
        raise last  # type: ignore[misc]

    def get_range(self, name: str, start: int, end: Optional[int] = None,
                  ) -> bytes:
        rng = f"bytes={start}-" if end is None else f"bytes={start}-{end}"
        return self._request(self._url(name), extra={"Range": rng})

    def put(self, name: str, data: bytes) -> None:
        self._request(self._url(name), data=data, method="PUT")

    def put_file(self, name: str, path: str,
                 part_size: int = 32 << 20, workers: int = 4,
                 multipart_threshold: int = 64 << 20) -> None:
        """Upload a file; large files go through S3 multipart upload
        with parallel ranged part PUTs (the upload-side analog of the
        streaming download: a 100GB shard never sits in memory whole;
        reference: ociobjectstore multipart upload paths)."""
        import concurrent.futures as cf
        size = os.path.getsize(path)
        if size < multipart_threshold:
            with open(path, "rb") as f:
                return self.put(name, f.read())
        init = self._request(self._url(name, query="uploads"),
                             data=b"", method="POST")
        root = ET.fromstring(init)
        ns = root.tag[:root.tag.index("}") + 1] \
            if root.tag.startswith("{") else ""
        upload_id = root.findtext(f"{ns}UploadId") or ""
        if not upload_id:
            raise StorageURIError(f"multipart init failed for {name!r}")

        nparts = (size + part_size - 1) // part_size

        def put_part(idx: int) -> Tuple[int, str]:
            with open(path, "rb") as f:
                f.seek(idx * part_size)
                chunk = f.read(part_size)
            url = self._url(name, query=f"partNumber={idx + 1}"
                            f"&uploadId={urllib.parse.quote(upload_id)}")
            # need the ETag response header: do the request inline
            last: Optional[Exception] = None
            for attempt in range(self.retries):
                req = urllib.request.Request(
                    url, data=chunk, method="PUT",
                    headers=self._signed(url, "PUT", dict(self.headers),
                                         chunk))
                try:
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        return idx + 1, (resp.headers.get("ETag")
                                         or "").strip('"')
                except urllib.error.HTTPError as e:
                    if e.code not in (429, 500, 502, 503, 504):
                        raise  # auth/4xx errors don't heal with retries
                    last = e
                except (urllib.error.URLError, OSError) as e:
                    last = e
                time.sleep(self.backoff * (2 ** attempt))
            raise last  # type: ignore[misc]

        try:
            with cf.ThreadPoolExecutor(max_workers=workers) as ex:
                etags = sorted(ex.map(put_part, range(nparts)))
            body = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber>"
                f"<ETag>\"{etag}\"</ETag></Part>" for n, etag in etags) \
                + "</CompleteMultipartUpload>"
            self._request(
                self._url(name,
                          query=f"uploadId={urllib.parse.quote(upload_id)}"),
                data=body.encode(), method="POST")
        except Exception:
            # abort so incomplete parts don't accrue storage charges
            try:
                self._request(
                    self._url(name, query="uploadId="
                              + urllib.parse.quote(upload_id)),
                    method="DELETE")
            except Exception:
                pass
            raise

    def exists(self, name: str) -> bool:
        try:
            self._request(self._url(name), method="HEAD")
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise


def open_storage(components: StorageComponents,
                 endpoints: Optional[Dict[str, str]] = None,
                 pvc_mount_root: str = "/mnt/pvc") -> Storage:
    """Provider factory (pkg/storage/factory.go:12-30)."""
    endpoints = endpoints or {}
    st = components.type
    if st in (StorageType.LOCAL,):
        return LocalStorage(components.path)
    if st == StorageType.PVC:
        return LocalStorage(os.path.join(pvc_mount_root,
                                         components.pvc_name,
                                         components.path))
    if st in (StorageType.S3, StorageType.GCS, StorageType.OCI):
        default = {
            StorageType.S3: "https://s3.amazonaws.com",
            StorageType.GCS: "https://storage.googleapis.com",
            StorageType.OCI: "https://objectstorage.local",
        }[st]
        from .signing import signer_from_env
        return S3CompatStorage(endpoints.get(st.value, default),
                               components.bucket,
                               signer=signer_from_env(st.value))
    if st == StorageType.AZURE:
        from .extra_providers import AzureBlobStorage
        # az://account/container/prefix (account in namespace, container
        # in bucket — uri.py); components.prefix stays a blob prefix
        return AzureBlobStorage(components.namespace,
                                components.bucket or "$root",
                                endpoint=endpoints.get("az"))
    if st == StorageType.GITHUB:
        from .extra_providers import GitHubStorage
        return GitHubStorage(components.repo_id, components.revision,
                             api_endpoint=endpoints.get("github_api"),
                             raw_endpoint=endpoints.get("github_raw"))
    if st == StorageType.VENDOR:
        from .extra_providers import open_vendor_storage
        return open_vendor_storage(components)
    raise StorageURIError(f"no storage provider for {st.value!r} "
                          f"(hf:// uses the hub client)")
