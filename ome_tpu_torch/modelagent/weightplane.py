"""Hardened weight plane: resumable, digest-verified, atomically
published model weight fetches (docs/model-fleet.md).

The failure contract, in download order:

  * a fetch only ever writes under ``<target>.staging/``; the serving
    path ``<target>`` appears in one ``os.rename`` after every object
    verified — a reader (an engine booting, the REUSE policy) never
    observes a partial tree at the serving path;
  * every verified object is recorded ``{name, size, sha256}`` in the
    staging manifest, which is fsynced before the next record, so a
    SIGKILL mid-download resumes from verified objects instead of
    restarting — resumed objects are re-hashed against the recorded
    digest, so a truncated or corrupted staged file is re-fetched,
    never trusted;
  * the manifest travels with the published tree with
    ``complete=true`` — that marker (not "directory is non-empty") is
    what ``DownloadPolicy.REUSE`` accepts as an existing download;
  * attempts are separated by jittered exponential backoff.

The manifest also accumulates fetch wall time and byte totals across
attempts; the published ``fetch_bps`` is what a serving engine
advertises on /ready so the router's cold-start Retry-After math uses
measured — not guessed — fetch throughput.

Fault points (docs/failure-semantics.md): ``weight_fetch`` (per
object, key=relative object name), ``weight_verify`` (key=relative
object name), ``model_publish`` (key=model name).

Port of ome_tpu/modelagent/weightplane.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import logging
import os
import shutil
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .. import faults
from ..storage.base import (ObjectInfo, ProgressFn, Storage, safe_join,
                            sha256_file)
from .metrics import METRICS

log = logging.getLogger("ome.modelagent.weightplane")

MANIFEST_NAME = ".ome_fetch_manifest.json"
MANIFEST_SCHEMA = 1

# Retry-After math falls back to this when a tree predates manifests
# (or was published by the HF path with hub-side timing unavailable).
DEFAULT_FETCH_BPS = 256e6


class WeightVerifyError(IOError):
    """A fetched object's size or digest does not match."""


class PublishError(IOError):
    """The staging -> serving rename failed; staging is left intact."""


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    try:
        _fsync_path(path)
    except OSError:
        pass  # some filesystems refuse O_RDONLY fsync on dirs


def staging_dir(target: str) -> str:
    return target.rstrip("/") + ".staging"


@dataclass
class FetchManifest:
    """Per-object verification ledger for one model tree.

    Lives at ``<staging>/.ome_fetch_manifest.json`` during a fetch and
    is published with the tree. ``objects`` maps relative object name
    to ``{"size": int, "sha256": hex}``; a name is only present after
    its bytes were hashed and the staged file fsynced, so every record
    can be trusted across a SIGKILL.
    """

    objects: Dict[str, Dict] = field(default_factory=dict)
    complete: bool = False
    total_bytes: int = 0
    fetch_seconds: float = 0.0
    attempts: int = 0

    @classmethod
    def load(cls, tree: str) -> Optional["FetchManifest"]:
        path = os.path.join(tree, MANIFEST_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return None
        if raw.get("schema_version") != MANIFEST_SCHEMA:
            return None
        return cls(objects=dict(raw.get("objects", {})),
                   complete=bool(raw.get("complete", False)),
                   total_bytes=int(raw.get("total_bytes", 0)),
                   fetch_seconds=float(raw.get("fetch_seconds", 0.0)),
                   attempts=int(raw.get("attempts", 0)))

    def save(self, tree: str):
        """Atomic + durable: tmp file, fsync, rename, fsync dir."""
        path = os.path.join(tree, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"schema_version": MANIFEST_SCHEMA,
                       "complete": self.complete,
                       "total_bytes": self.total_bytes,
                       "fetch_seconds": self.fetch_seconds,
                       "attempts": self.attempts,
                       "objects": self.objects}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(tree)

    def record(self, name: str, size: int, sha256: str):
        self.objects[name] = {"size": size, "sha256": sha256}

    def verified(self, name: str, size: int) -> bool:
        rec = self.objects.get(name)
        return rec is not None and rec.get("size") == size

    def fetch_bps(self) -> float:
        if self.total_bytes and self.fetch_seconds > 0:
            return self.total_bytes / self.fetch_seconds
        return 0.0


def is_published(target: str) -> bool:
    """True only for a tree the weight plane published complete — the
    REUSE completeness check (a non-empty directory is NOT enough:
    that is exactly the partial tree a killed download leaves)."""
    if not os.path.isdir(target):
        return False
    m = FetchManifest.load(target)
    return m is not None and m.complete


def published_manifest(target: str) -> Optional[FetchManifest]:
    m = FetchManifest.load(target)
    return m if m is not None and m.complete else None


def published_fetch_bps(target: str) -> float:
    """Measured fetch throughput of a published tree (0 if unknown)."""
    m = published_manifest(target)
    return m.fetch_bps() if m is not None else 0.0


def backoff_delay(attempt: int, rng, base: float = 0.5,
                  cap: float = 30.0) -> float:
    """Jittered exponential backoff: full jitter over [base/2, d] with
    d = min(cap, base * 2^attempt)."""
    d = min(cap, base * (2.0 ** attempt))
    lo = min(base / 2.0, d)
    return lo + (d - lo) * rng.random()


# Family suffixes + help live in module dicts and declarations go
# through the ``f"ome_modelagent_{key}"`` idiom so the catalog-drift
# lint can statically extract every name against observability.md.
_COUNTER_HELP = {
    "fetch_attempts_total":
        "weight-plane fetch attempts (one per try, not per object)",
    "fetch_retries_total":
        "fetch attempts after the first (backoff-separated)",
    "objects_verified_total":
        "objects fetched, hashed and recorded in the fetch manifest",
    "objects_resumed_total":
        "objects skipped on resume because their staged bytes "
        "matched the manifest digest",
    "verify_failures_total":
        "weight-plane attempts that failed fetching or verifying an "
        "object",
    "fetch_bytes_total":
        "bytes fetched and verified by the weight plane",
    "publishes_total":
        "complete model trees atomically promoted to the serving "
        "path",
}
_GAUGE_HELP = {
    "fetch_throughput_bps":
        "measured fetch throughput of the last completed fetch "
        "(bytes/second, manifest-accumulated)",
}


def declare_families():
    """Register every weight-plane family (idempotent) so /metrics
    exposes them before first use."""
    reg = METRICS.registry
    for _ckey in _COUNTER_HELP:
        reg.counter(f"ome_modelagent_{_ckey}",
                    help=_COUNTER_HELP[_ckey])
    for _gkey in _GAUGE_HELP:
        reg.gauge(f"ome_modelagent_{_gkey}", help=_GAUGE_HELP[_gkey])


def _counter(key: str):
    # METRICS.reset() (tests) swaps registries — resolve the family
    # against the CURRENT registry per call, never cache it.
    return METRICS.registry.counter("ome_modelagent_" + key,
                                    help=_COUNTER_HELP[key])


def _gauge(key: str):
    return METRICS.registry.gauge("ome_modelagent_" + key,
                                  help=_GAUGE_HELP[key])


def _rel_name(o: ObjectInfo, prefix: str) -> str:
    return o.name[len(prefix):].lstrip("/") if prefix else o.name


def fetch_tree(storage: Storage, prefix: str,
               expected: List[ObjectInfo], target: str, *,
               workers: int = 4,
               progress: Optional[ProgressFn] = None,
               clock: Callable[[], float] = time.monotonic) -> Dict:
    """One fetch attempt into ``staging_dir(target)``.

    Objects already recorded in the staging manifest are re-hashed and
    skipped when intact; the rest are fetched in parallel, hashed,
    fsynced, and recorded one at a time (a single writer folds worker
    results into the manifest, so a crash never loses more than the
    in-flight objects). Raises on the first failed object after
    letting already-completed workers be recorded. Does NOT publish.
    """
    staging = staging_dir(target)
    os.makedirs(staging, exist_ok=True)
    manifest = FetchManifest.load(staging) or FetchManifest()
    manifest.attempts += 1
    manifest.complete = False
    _counter("fetch_attempts_total").inc()

    todo: List[ObjectInfo] = []
    resumed = 0
    for o in expected:
        rel = _rel_name(o, prefix)
        dst = safe_join(staging, rel)
        if manifest.verified(rel, o.size) and os.path.exists(dst) \
                and os.path.getsize(dst) == o.size \
                and sha256_file(dst) == manifest.objects[rel]["sha256"]:
            resumed += 1
            if progress:
                progress(o.name, o.size, o.size)
            continue
        todo.append(o)
    if resumed:
        _counter("objects_resumed_total").inc(resumed)

    t0 = clock()

    def fetch_one(o: ObjectInfo):
        rel = _rel_name(o, prefix)
        dst = safe_join(staging, rel)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        faults.fire("weight_fetch", key=rel)
        part = dst + ".part"
        storage.get_to_file(o.name, part, progress=progress,
                            total=o.size, etag=o.etag)
        got = os.path.getsize(part)
        digest = sha256_file(part)
        faults.fire("weight_verify", key=rel,
                    exc=WeightVerifyError)
        if o.size and got != o.size:
            os.unlink(part)  # a ranged resume must not trust it
            raise WeightVerifyError(
                f"{rel}: size {got} != expected {o.size}")
        os.replace(part, dst)
        _fsync_path(dst)
        return rel, got, digest

    fetched = 0
    first_err: Optional[BaseException] = None
    if todo:
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            futs = [ex.submit(fetch_one, o) for o in todo]
            for fut in cf.as_completed(futs):
                try:
                    rel, size, digest = fut.result()
                except BaseException as e:  # noqa: BLE001 — record, then re-raise
                    if first_err is None:
                        first_err = e
                        for other in futs:
                            other.cancel()
                    continue
                manifest.record(rel, size, digest)
                manifest.save(staging)
                fetched += 1
                _counter("objects_verified_total").inc()
                _counter("fetch_bytes_total").inc(size)
    manifest.fetch_seconds += max(0.0, clock() - t0)
    manifest.save(staging)
    if first_err is not None:
        _counter("verify_failures_total").inc()
        raise first_err

    manifest.total_bytes = sum(o.size for o in expected)
    manifest.save(staging)
    bps = manifest.fetch_bps()
    if bps:
        _gauge("fetch_throughput_bps").set(bps)
    return {"fetched": fetched, "resumed": resumed,
            "bytes": manifest.total_bytes,
            "seconds": manifest.fetch_seconds, "bps": bps}


def seal_tree(staging: str, *,
              fetch_seconds: float = 0.0) -> FetchManifest:
    """Build a complete manifest over an already-materialized staging
    tree (the HF hub path downloads via its own resumable client, so
    the weight plane hashes the result rather than the transfer)."""
    manifest = FetchManifest.load(staging) or FetchManifest()
    total = 0
    for root, _, files in os.walk(staging):
        for fn in files:
            if fn == MANIFEST_NAME or fn.endswith(".part") \
                    or fn.endswith(".tmp"):
                continue
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, staging)
            size = os.path.getsize(p)
            faults.fire("weight_verify", key=rel,
                        exc=WeightVerifyError)
            manifest.record(rel, size, sha256_file(p))
            total += size
    manifest.total_bytes = total
    if fetch_seconds:
        manifest.fetch_seconds += fetch_seconds
    manifest.save(staging)
    return manifest


def publish(target: str, *, name: str = "") -> None:
    """Atomically promote ``staging_dir(target)`` to ``target``.

    Marks the staging manifest complete (fsynced), then renames the
    whole tree into place — the only write the serving path ever
    sees. A pre-existing tree at ``target`` (a partial left by code
    that predates the weight plane) is moved aside first and deleted
    only after the rename lands.
    """
    staging = staging_dir(target)
    manifest = FetchManifest.load(staging)
    if manifest is None or not manifest.objects:
        raise PublishError(f"{staging}: no verified manifest to publish")
    faults.fire("model_publish", key=name or os.path.basename(target),
                exc=PublishError)
    manifest.complete = True
    manifest.save(staging)
    trash = target.rstrip("/") + ".trash"
    if os.path.isdir(trash):
        shutil.rmtree(trash, ignore_errors=True)
    if os.path.exists(target):
        os.rename(target, trash)
    try:
        os.rename(staging, target)
    except OSError:
        # roll the old tree back so the serving path is never empty
        if os.path.isdir(trash) and not os.path.exists(target):
            os.rename(trash, target)
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(target)) or ".")
    if os.path.isdir(trash):
        shutil.rmtree(trash, ignore_errors=True)
    _counter("publishes_total").inc()


def fetch_and_publish(storage: Storage, prefix: str,
                      expected: List[ObjectInfo], target: str, *,
                      name: str = "", workers: int = 4,
                      retries: int = 1, rng=None,
                      sleep: Callable[[float], None] = time.sleep,
                      progress: Optional[ProgressFn] = None,
                      clock: Callable[[], float] = time.monotonic
                      ) -> Dict:
    """Fetch + verify + publish with jittered backoff between
    attempts. Returns the last attempt's stats dict with
    ``published=True``."""
    import random
    rng = rng or random.Random()
    last: Optional[Exception] = None
    for attempt in range(max(1, retries)):
        if attempt:
            _counter("fetch_retries_total").inc()
            sleep(backoff_delay(attempt - 1, rng))
        try:
            stats = fetch_tree(storage, prefix, expected, target,
                               workers=workers, progress=progress,
                               clock=clock)
            publish(target, name=name)
            stats["published"] = True
            return stats
        except Exception as e:  # noqa: BLE001 — every attempt may retry
            last = e
            log.warning("fetch attempt %d/%d for %s failed: %s",
                        attempt + 1, max(1, retries), target, e)
    raise last  # type: ignore[misc]


def main(argv=None) -> int:
    """Subprocess entrypoint for the chaos harness: fetch a storage
    URI into a target dir and print one JSON stats line. The harness
    SIGKILLs this process mid-download and asserts the serving path
    never holds a partial tree, then re-runs it to observe resume."""
    from ..storage.providers import open_storage
    from ..storage.uri import parse_storage_uri

    p = argparse.ArgumentParser(
        prog="weightplane",
        description="hardened model weight fetch (chaos/soak entry)")
    p.add_argument("--source", required=True,
                   help="storage uri, e.g. local:///path")
    p.add_argument("--target", required=True)
    p.add_argument("--name", default="model")
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--faults", default="",
                   help="fault spec (faults.py grammar)")
    args = p.parse_args(argv)
    if args.faults:
        faults.install(args.faults)
    comps = parse_storage_uri(args.source)
    storage = open_storage(comps, {})
    expected = storage.list(comps.prefix)
    if not expected:
        print(json.dumps({"error": "no objects"}))
        return 2
    try:
        stats = fetch_and_publish(storage, comps.prefix, expected,
                                  args.target, name=args.name,
                                  workers=args.workers,
                                  retries=args.retries)
    except Exception as e:  # noqa: BLE001 — report, nonzero exit
        print(json.dumps({"error": str(e)[:500], "published": False}))
        return 1
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":  # pragma: no cover — subprocess entry
    sys.exit(main())
