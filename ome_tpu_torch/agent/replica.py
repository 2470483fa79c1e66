"""Replica — model replication between storage backends.

Re-designs internal/ome-agent/replica (replica/replicator/*.go: the
hf→oci, hf→pvc, oci↔oci/pvc, pvc↔pvc matrix): one replicator over the
uniform Storage interface instead of one Go type per (src, dst) pair —
any parseable storage URI can be a source, and any non-hf URI a
destination. Downloads stage through a local dir (the hub client and
object stores already resume + verify) and uploads stream back out.

Port of ome_tpu/agent/replica.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..storage.hub import HubClient
from ..storage.providers import open_storage
from ..storage.uri import StorageComponents, StorageType, parse_storage_uri

log = logging.getLogger("ome.agent.replica")


@dataclass
class ReplicationResult:
    source: str
    target: str
    files: int
    bytes: int


class Replicator:
    def __init__(self, hub: Optional[HubClient] = None,
                 endpoints: Optional[Dict[str, str]] = None,
                 pvc_mount_root: str = "/mnt/pvc", workers: int = 4):
        self.hub = hub or HubClient()
        self.endpoints = endpoints or {}
        self.pvc_mount_root = pvc_mount_root
        self.workers = workers

    # -- staging -------------------------------------------------------

    def _fetch(self, comps: StorageComponents, stage: str) -> List[str]:
        if comps.type == StorageType.HUGGINGFACE:
            return self.hub.snapshot_download(
                comps.repo_id, stage, revision=comps.revision,
                workers=self.workers)
        storage = open_storage(comps, self.endpoints, self.pvc_mount_root)
        return storage.download(stage, comps.prefix, workers=self.workers)

    def _push(self, comps: StorageComponents, stage: str) -> List[str]:
        if comps.type == StorageType.HUGGINGFACE:
            raise ValueError("hf:// is read-only; cannot be a target")
        # local/pvc roots are baked into the provider by open_storage;
        # only object stores carry a non-empty key prefix
        storage = open_storage(comps, self.endpoints, self.pvc_mount_root)
        return storage.upload(stage, comps.prefix)

    # -- public --------------------------------------------------------

    def replicate(self, source_uri: str, target_uri: str,
                  stage_dir: Optional[str] = None) -> ReplicationResult:
        src = parse_storage_uri(source_uri)
        dst = parse_storage_uri(target_uri)
        own_stage = stage_dir is None
        stage = stage_dir or tempfile.mkdtemp(prefix="ome-replica-")
        try:
            files = self._fetch(src, stage)
            total = sum(os.path.getsize(f) for f in files
                        if os.path.isfile(f))
            pushed = self._push(dst, stage)
            log.info("replicated %s -> %s: %d files, %d bytes",
                     source_uri, target_uri, len(pushed), total)
            return ReplicationResult(source=source_uri, target=target_uri,
                                     files=len(pushed), bytes=total)
        finally:
            if own_stage:
                shutil.rmtree(stage, ignore_errors=True)
