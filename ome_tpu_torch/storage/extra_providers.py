"""Azure Blob, GitHub, and vendor storage providers.

Completes the provider matrix the URI parser already accepts
(uri.py: az:// github:// vendor://), matching the reference's
multi-provider storage factory scope (pkg/storage/factory.go +
pkg/utils/storage/storage.go:11-52) without any vendor SDK:

  * AzureBlobStorage — Blob service REST (List Blobs XML, ranged GET,
    Put Blob). Auth via SAS token ($AZURE_STORAGE_SAS_TOKEN, appended
    to every URL) or anonymous public containers; account-key request
    signing is intentionally out (SAS is the k8s-workload norm).
  * GitHubStorage — repo contents at a ref through codeload tarball
    listing and raw.githubusercontent file reads; token from
    $GITHUB_TOKEN.
  * vendor:// resolves through OME_VENDOR_ENDPOINT_<NAME> to any
    S3-compatible endpoint (partner-hosted model stores).

Port of ome_tpu/storage/extra_providers.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from .base import ObjectInfo, Storage
from .uri import StorageComponents, StorageURIError


class AzureBlobStorage(Storage):
    """az://account/container/prefix over the Blob service REST API."""

    def __init__(self, account: str, container: str,
                 endpoint: Optional[str] = None,
                 sas_token: Optional[str] = None, retries: int = 4):
        self.endpoint = (endpoint
                         or f"https://{account}.blob.core.windows.net")
        self.container = container
        self.sas = (sas_token
                    or os.environ.get("AZURE_STORAGE_SAS_TOKEN", ""))
        self.sas = self.sas.lstrip("?")
        self.retries = retries

    def _url(self, blob: str = "", query: str = "") -> str:
        u = f"{self.endpoint.rstrip('/')}/{self.container}"
        if blob:
            u += "/" + urllib.parse.quote(blob.lstrip("/"))
        qs = [q for q in (query, self.sas) if q]
        if qs:
            u += "?" + "&".join(qs)
        return u

    def _request(self, url: str, data: Optional[bytes] = None,
                 method: Optional[str] = None,
                 extra: Optional[Dict[str, str]] = None) -> bytes:
        headers = {"x-ms-version": "2021-08-06", **(extra or {})}
        if data is not None:
            headers.setdefault("x-ms-blob-type", "BlockBlob")
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    def list(self, prefix: str = "") -> List[ObjectInfo]:
        out: List[ObjectInfo] = []
        marker = ""
        while True:
            q = "restype=container&comp=list"
            if prefix:
                q += "&prefix=" + urllib.parse.quote(prefix)
            if marker:
                q += "&marker=" + urllib.parse.quote(marker)
            root = ET.fromstring(self._request(self._url(query=q)))
            for b in root.iter("Blob"):
                name = b.findtext("Name") or ""
                props = b.find("Properties")
                size = int(props.findtext("Content-Length") or 0) \
                    if props is not None else 0
                etag = (props.findtext("Etag") or "").strip('"') \
                    if props is not None else ""
                out.append(ObjectInfo(name, size, etag))
            marker = root.findtext("NextMarker") or ""
            if not marker:
                break
        return out

    def get(self, name: str) -> bytes:
        return self._request(self._url(name))

    def get_range(self, name: str, start: int,
                  end: Optional[int] = None) -> bytes:
        rng = f"bytes={start}-" if end is None else f"bytes={start}-{end}"
        return self._request(self._url(name), extra={"x-ms-range": rng})

    def put(self, name: str, data: bytes) -> None:
        self._request(self._url(name), data=data, method="PUT")

    def exists(self, name: str) -> bool:
        try:
            self._request(self._url(name), method="HEAD")
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise


class GitHubStorage(Storage):
    """github://org/repo[@ref] — read-only repo contents."""

    def __init__(self, repo_id: str, revision: str = "main",
                 api_endpoint: Optional[str] = None,
                 raw_endpoint: Optional[str] = None,
                 token: Optional[str] = None):
        self.repo_id = repo_id
        self.revision = revision
        self.api = (api_endpoint or "https://api.github.com").rstrip("/")
        self.raw = (raw_endpoint
                    or "https://raw.githubusercontent.com").rstrip("/")
        self.token = token or os.environ.get("GITHUB_TOKEN")

    def _headers(self) -> Dict[str, str]:
        h = {"Accept": "application/vnd.github+json",
             "User-Agent": "ome-tpu"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _request(self, url: str) -> bytes:
        req = urllib.request.Request(url, headers=self._headers())
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.read()

    def list(self, prefix: str = "") -> List[ObjectInfo]:
        url = (f"{self.api}/repos/{self.repo_id}/git/trees/"
               f"{urllib.parse.quote(self.revision)}?recursive=1")
        tree = json.loads(self._request(url))
        out = []
        for entry in tree.get("tree", []):
            if entry.get("type") != "blob":
                continue
            path = entry.get("path", "")
            if prefix and not path.startswith(prefix):
                continue
            out.append(ObjectInfo(path, int(entry.get("size") or 0),
                                  entry.get("sha", "")))
        return out

    def get(self, name: str) -> bytes:
        url = (f"{self.raw}/{self.repo_id}/"
               f"{urllib.parse.quote(self.revision)}/"
               f"{urllib.parse.quote(name.lstrip('/'))}")
        return self._request(url)

    def get_range(self, name: str, start: int,
                  end: Optional[int] = None) -> bytes:
        data = self.get(name)
        return data[start:end + 1 if end is not None else None]

    def put(self, name: str, data: bytes) -> None:
        raise StorageURIError("github:// storage is read-only")

    def exists(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise


def open_vendor_storage(components: StorageComponents) -> Storage:
    """vendor://name/path -> S3-compatible endpoint from the env."""
    from .providers import S3CompatStorage
    from .signing import signer_from_env
    name = components.namespace
    endpoint = os.environ.get(f"OME_VENDOR_ENDPOINT_{name.upper()}")
    if not endpoint:
        raise StorageURIError(
            f"vendor storage {name!r} is not configured: set "
            f"OME_VENDOR_ENDPOINT_{name.upper()} to its S3-compatible "
            f"endpoint URL")
    bucket, _, _prefix = components.path.partition("/")
    return S3CompatStorage(endpoint, bucket,
                           signer=signer_from_env("s3"))
