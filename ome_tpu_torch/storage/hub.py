"""HuggingFace-Hub-compatible download client.

Re-designs pkg/hfutil/hub (download.go:88-274, repo.go): snapshot and
single-file downloads against any hub-wire-compatible endpoint, with
ranged-GET resume of partial files, bounded retries with exponential
backoff + jitter, and tmp-and-move atomicity. The endpoint is
configurable so mirrors and test servers work identically (zero-egress
CI exercises this against a local HTTP server).

Port of ome_tpu/storage/hub.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .base import ObjectInfo, ProgressFn, drain_response_to_file, safe_join

DEFAULT_ENDPOINT = "https://huggingface.co"


class _AuthStrippingRedirectHandler(urllib.request.HTTPRedirectHandler):
    """Drop Authorization when a redirect crosses hosts.

    Hub /resolve URLs redirect to a CDN/S3 presigned URL; forwarding
    the Bearer token there both leaks it and breaks presigned auth
    ('only one auth mechanism allowed'). Go's net/http strips
    sensitive headers on cross-domain redirects — urllib does not, so
    we do it here.
    """

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        new = super().redirect_request(req, fp, code, msg, headers, newurl)
        if new is not None and new.has_header("Authorization"):
            def origin(url):
                u = urllib.parse.urlsplit(url)
                port = u.port or {"http": 80, "https": 443}.get(u.scheme)
                return (u.scheme, u.hostname, port)
            # strip on any origin change INCLUDING scheme downgrade
            # (https→http would put the token on the wire in cleartext)
            if origin(req.full_url) != origin(new.full_url):
                new.remove_header("Authorization")
        return new


_OPENER = urllib.request.build_opener(_AuthStrippingRedirectHandler())


class HubError(Exception):
    pass


@dataclass
class RepoFile:
    rfilename: str
    size: int = 0


@dataclass
class HubClient:
    endpoint: str = DEFAULT_ENDPOINT
    token: Optional[str] = None
    retries: int = 5
    backoff: float = 0.2
    chunk_size: int = 1 << 20
    headers: Dict[str, str] = field(default_factory=dict)

    def _headers(self, extra: Optional[Dict[str, str]] = None,
                 ) -> Dict[str, str]:
        h = dict(self.headers)
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        h.update(extra or {})
        return h

    def _open(self, url: str, extra: Optional[Dict[str, str]] = None):
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            req = urllib.request.Request(url, headers=self._headers(extra))
            try:
                return _OPENER.open(req, timeout=60)
            except urllib.error.HTTPError as e:
                if e.code in (408, 429, 500, 502, 503, 504):
                    last = e
                else:
                    raise HubError(f"{url}: HTTP {e.code}") from e
            except urllib.error.URLError as e:
                last = e
            # exponential backoff with jitter (hub retry behavior)
            time.sleep(self.backoff * (2 ** attempt)
                       * (0.5 + random.random()))
        raise HubError(f"{url}: retries exhausted ({last})")

    # -- repo metadata -------------------------------------------------

    def repo_files(self, repo_id: str, revision: str = "main",
                   ) -> List[RepoFile]:
        url = (f"{self.endpoint}/api/models/"
               f"{urllib.parse.quote(repo_id)}/revision/"
               f"{urllib.parse.quote(revision)}")
        with self._open(url) as resp:
            meta = json.loads(resp.read())
        files = []
        for s in meta.get("siblings", []):
            files.append(RepoFile(rfilename=s.get("rfilename", ""),
                                  size=s.get("size") or 0))
        return files

    def file_url(self, repo_id: str, filename: str,
                 revision: str = "main") -> str:
        return (f"{self.endpoint}/{repo_id}/resolve/"
                f"{urllib.parse.quote(revision)}/"
                f"{urllib.parse.quote(filename, safe='/')}")

    # -- downloads -----------------------------------------------------

    def download_file(self, repo_id: str, filename: str, target_dir: str,
                      revision: str = "main", expected_size: int = 0,
                      progress: Optional[ProgressFn] = None) -> str:
        dst = safe_join(target_dir, filename)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        if os.path.exists(dst) and expected_size \
                and os.path.getsize(dst) == expected_size:
            if progress:
                progress(filename, expected_size, expected_size)
            return dst  # ReuseIfExists fast path

        part = dst + ".part"
        offset = os.path.getsize(part) if os.path.exists(part) else 0
        url = self.file_url(repo_id, filename, revision)
        extra = {"Range": f"bytes={offset}-"} if offset else None
        try:
            resp = self._open(url, extra)
        except HubError:
            if not offset:
                raise
            # server may not honor Range for this object: restart clean
            os.remove(part)
            offset, resp = 0, self._open(url)
        with resp:
            if offset and resp.getcode() != 206:
                offset = 0  # server ignored Range: overwrite from scratch
            total = expected_size or (
                offset + int(resp.headers.get("Content-Length") or 0))
            drain_response_to_file(resp, part, offset, name=filename,
                                   total=total, chunk_size=self.chunk_size,
                                   progress=progress)
        if expected_size and os.path.getsize(part) != expected_size:
            raise HubError(
                f"{filename}: downloaded {os.path.getsize(part)} bytes, "
                f"expected {expected_size}")
        os.replace(part, dst)
        return dst

    def snapshot_download(self, repo_id: str, target_dir: str,
                          revision: str = "main",
                          allow_patterns: Optional[List[str]] = None,
                          ignore_patterns: Optional[List[str]] = None,
                          workers: int = 4,
                          progress: Optional[ProgressFn] = None,
                          ) -> List[str]:
        """Download a full repo tree (hub snapshot semantics)."""
        import concurrent.futures as cf

        files = self.repo_files(repo_id, revision)
        picked = []
        for f in files:
            name = f.rfilename
            if allow_patterns and not any(
                    fnmatch.fnmatch(name, p) for p in allow_patterns):
                continue
            if ignore_patterns and any(
                    fnmatch.fnmatch(name, p) for p in ignore_patterns):
                continue
            picked.append(f)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(
                lambda f: self.download_file(
                    repo_id, f.rfilename, target_dir, revision,
                    expected_size=f.size, progress=progress),
                picked))

    def expected_objects(self, repo_id: str, revision: str = "main",
                         ) -> List[ObjectInfo]:
        return [ObjectInfo(f.rfilename, f.size)
                for f in self.repo_files(repo_id, revision)]
