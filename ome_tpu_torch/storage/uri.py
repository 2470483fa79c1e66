"""Storage URI parsing.

Re-designs pkg/utils/storage (storage.go:11-52): one parser for every
scheme the control plane accepts — hf:// gcs:// s3:// oci:// az://
github:// pvc:// local:// (and vendor:// for partner-hosted models).

Port of ome_tpu/storage/uri.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class StorageType(str, enum.Enum):
    HUGGINGFACE = "hf"
    GCS = "gcs"
    S3 = "s3"
    OCI = "oci"
    AZURE = "az"
    GITHUB = "github"
    PVC = "pvc"
    LOCAL = "local"
    VENDOR = "vendor"


class StorageURIError(ValueError):
    pass


@dataclass
class StorageComponents:
    type: StorageType = StorageType.LOCAL
    # object stores: bucket + prefix (+ namespace for OCI)
    bucket: str = ""
    prefix: str = ""
    namespace: str = ""
    # hf: org/repo[@revision]
    repo_id: str = ""
    revision: str = "main"
    # pvc: claim name + subpath; local: absolute path
    pvc_name: str = ""
    path: str = ""
    parameters: Dict[str, str] = field(default_factory=dict)

    @property
    def scheme(self) -> str:
        return self.type.value


def parse_storage_uri(uri: str) -> StorageComponents:
    if not uri or "://" not in uri:
        raise StorageURIError(f"invalid storage uri {uri!r}")
    scheme, rest = uri.split("://", 1)
    scheme = scheme.lower()
    try:
        st = StorageType(scheme)
    except ValueError:
        raise StorageURIError(f"unsupported storage scheme {scheme!r} "
                              f"in {uri!r}")

    if st == StorageType.HUGGINGFACE:
        # hf://org/repo[@revision][/subpath]
        repo, _, revision = rest.partition("@")
        sub = ""
        if revision and "/" in revision:
            revision, _, sub = revision.partition("/")
        parts = repo.strip("/").split("/")
        if len(parts) < 2:
            raise StorageURIError(f"hf uri needs org/repo: {uri!r}")
        return StorageComponents(type=st, repo_id="/".join(parts[:2]),
                                 revision=revision or "main",
                                 path=sub or "/".join(parts[2:]))
    if st == StorageType.OCI:
        # oci://n/<namespace>/b/<bucket>/o/<prefix>
        parts = rest.strip("/").split("/")
        if len(parts) >= 5 and parts[0] == "n" and parts[2] == "b":
            namespace, bucket = parts[1], parts[3]
            prefix = "/".join(parts[5:]) if len(parts) > 5 else ""
            return StorageComponents(type=st, namespace=namespace,
                                     bucket=bucket, prefix=prefix)
        if len(parts) >= 2:  # oci://bucket@namespace/prefix
            bucket, _, namespace = parts[0].partition("@")
            if not namespace:
                raise StorageURIError(
                    f"oci uri missing namespace (want "
                    f"oci://bucket@namespace/prefix or "
                    f"oci://n/ns/b/bucket/o/prefix): {uri!r}")
            return StorageComponents(type=st, bucket=bucket,
                                     namespace=namespace,
                                     prefix="/".join(parts[1:]))
        raise StorageURIError(f"invalid oci uri {uri!r}")
    if st in (StorageType.GCS, StorageType.S3):
        parts = rest.strip("/").split("/", 1)
        return StorageComponents(type=st, bucket=parts[0],
                                 prefix=parts[1] if len(parts) > 1 else "")
    if st == StorageType.AZURE:
        # az://account/container/prefix — account rides `namespace` so
        # `bucket`/`prefix` mean the same thing as for s3/gcs (callers
        # pass prefix as the blob-name prefix inside the container)
        parts = rest.strip("/").split("/", 2)
        if len(parts) < 2:
            raise StorageURIError(
                f"az uri needs account/container: {uri!r}")
        return StorageComponents(type=st, namespace=parts[0],
                                 bucket=parts[1],
                                 prefix=parts[2] if len(parts) > 2 else "")
    if st == StorageType.GITHUB:
        # github://org/repo[@ref]
        repo, _, revision = rest.partition("@")
        return StorageComponents(type=st, repo_id=repo.strip("/"),
                                 revision=revision or "main")
    if st == StorageType.PVC:
        # pvc://claim-name/sub/path
        parts = rest.strip("/").split("/", 1)
        return StorageComponents(type=st, pvc_name=parts[0],
                                 path=parts[1] if len(parts) > 1 else "")
    if st == StorageType.VENDOR:
        parts = rest.strip("/").split("/", 1)
        return StorageComponents(type=st, namespace=parts[0],
                                 path=parts[1] if len(parts) > 1 else "")
    # local
    return StorageComponents(type=st, path="/" + rest.lstrip("/"))
