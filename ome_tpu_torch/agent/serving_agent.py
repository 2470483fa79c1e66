"""Serving agent — fine-tuned-weight sidecar.

Re-designs internal/ome-agent/serving-agent (serving_agent.go:42-80):
watches a fine-tuned-weight info file (a mounted ConfigMap entry in the
reference, updated when an adapter is attached to the service),
downloads the referenced adapter archive and unpacks it next to the
base weights so the engine can hot-load it. The reference uses fsnotify
on the mount; a poll of (mtime, size) is equivalent for ConfigMap
mounts, which kubelet updates atomically via symlink swap.

Port of ome_tpu/agent/serving_agent.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import zipfile
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..storage.hub import HubClient
from ..storage.providers import open_storage
from ..storage.uri import StorageType, parse_storage_uri

log = logging.getLogger("ome.agent.serving")


@dataclass
class AdapterInfo:
    """Schema of the info file: one JSON object per adapter."""

    name: str
    storage_uri: str
    revision: str = ""

    @classmethod
    def parse_file(cls, path: str) -> Dict[str, "AdapterInfo"]:
        with open(path) as f:
            data = json.load(f)
        entries = data if isinstance(data, list) else [data]
        out = {}
        for e in entries:
            info = cls(name=e["name"], storage_uri=e["storageUri"],
                       revision=e.get("revision", ""))
            out[info.name] = info
        return out


class ServingAgent:
    def __init__(self, info_file: str, adapters_dir: str,
                 hub: Optional[HubClient] = None,
                 endpoints: Optional[Dict[str, str]] = None,
                 poll_interval: float = 2.0,
                 on_change: Optional[Callable[[str], None]] = None,
                 engine_url: Optional[str] = None):
        self.info_file = info_file
        self.adapters_dir = adapters_dir
        self.hub = hub or HubClient()
        self.endpoints = endpoints or {}
        self.poll_interval = poll_interval
        self.on_change = on_change
        # engine hot-load hook: after staging adapter <name> at
        # <adapters_dir>/<name>, POST it to the co-located engine's
        # /v1/adapters (DELETE on unload) so multi-LoRA slots track
        # the FineTunedWeight attachment without a restart
        self.engine_url = engine_url.rstrip("/") if engine_url else None
        self.loaded: Dict[str, AdapterInfo] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one reconciliation pass ---------------------------------------

    def sync(self) -> bool:
        """Reconcile adapters_dir against the info file; True if changed."""
        if not os.path.exists(self.info_file):
            return False
        try:
            want = AdapterInfo.parse_file(self.info_file)
        except (ValueError, KeyError) as e:
            log.warning("bad adapter info file %s: %s", self.info_file, e)
            return False
        changed = False
        for name, info in want.items():
            cur = self.loaded.get(name)
            if cur and (cur.storage_uri, cur.revision) == (
                    info.storage_uri, info.revision):
                continue
            self._load(info)
            self.loaded[name] = info
            changed = True
        for name in list(self.loaded):
            if name not in want:
                self._unload(name)
                changed = True
        return changed

    def _load(self, info: AdapterInfo):
        comps = parse_storage_uri(info.storage_uri)
        target = os.path.join(self.adapters_dir, info.name)
        with tempfile.TemporaryDirectory(prefix="ome-adapter-") as stage:
            if comps.type == StorageType.HUGGINGFACE:
                files = self.hub.snapshot_download(
                    comps.repo_id, stage,
                    revision=comps.revision or info.revision or "main")
            else:
                storage = open_storage(comps, self.endpoints)
                files = storage.download(stage, comps.prefix)
            os.makedirs(target, exist_ok=True)
            troot = os.path.realpath(target)
            for f in files:
                if f.endswith(".zip"):
                    with zipfile.ZipFile(f) as z:  # adapter archives
                        for m in z.namelist():
                            # zip-slip guard: resolve both sides
                            p = os.path.realpath(os.path.join(troot, m))
                            if os.path.commonpath([p, troot]) != troot:
                                raise ValueError(
                                    f"zip entry escapes target: {m!r}")
                        z.extractall(troot)
                else:
                    rel = os.path.relpath(f, stage)
                    dst = os.path.join(target, rel)
                    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
                    # shutil.move: stage (tmpfs) and adapters_dir (PVC)
                    # are usually different filesystems — os.replace
                    # would fail with EXDEV
                    shutil.move(f, dst)
        log.info("adapter %s loaded from %s", info.name, info.storage_uri)
        self._notify_engine("load", info.name, target)
        if self.on_change:
            self.on_change(info.name)

    def _unload(self, name: str):
        shutil.rmtree(os.path.join(self.adapters_dir, name),
                      ignore_errors=True)
        self.loaded.pop(name, None)
        log.info("adapter %s unloaded", name)
        self._notify_engine("unload", name, None)
        if self.on_change:
            self.on_change(name)

    def _notify_engine(self, action: str, name: str,
                       path: Optional[str]):
        if not self.engine_url:
            return
        import urllib.error
        import urllib.request
        try:
            if action == "load":
                req = urllib.request.Request(
                    self.engine_url + "/v1/adapters",
                    data=json.dumps({"name": name,
                                     "path": path}).encode(),
                    headers={"Content-Type": "application/json"})
            else:
                req = urllib.request.Request(
                    self.engine_url + f"/v1/adapters/{name}",
                    method="DELETE")
            with urllib.request.urlopen(req, timeout=60) as resp:
                resp.read()
            log.info("engine %s adapter %s ok", action, name)
        except (urllib.error.URLError, OSError) as e:
            # staging succeeded; the engine can still pick the adapter
            # up on restart — don't fail the sync loop
            log.warning("engine %s adapter %s failed: %s", action,
                        name, e)

    # -- watch loop ----------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run,
                                        name="ome-serving-agent",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self):
        last_sig = object()  # sentinel: never equal on first pass
        while not self._stop.is_set():
            try:
                st = os.stat(self.info_file)
                sig = (st.st_mtime_ns, st.st_size)
            except OSError:
                sig = None
            if sig != last_sig:
                try:
                    self.sync()
                    # only remember the signature on success, so a
                    # transient download failure is retried next poll
                    last_sig = sig
                except Exception:  # noqa: BLE001 — keep watching
                    log.exception("adapter sync failed; will retry")
            self._stop.wait(self.poll_interval)
