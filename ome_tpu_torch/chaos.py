"""Chaos soak harness: randomized fault schedules, real invariants.

Port of ome_tpu/chaos.py. The same seed gives the same schedule and
workload as the reference's; the children are the port's engines
(`ome_tpu_torch.engine.serve`) and asyncio routers
(`ome_tpu_torch.router.aserver`), started on ``device`` (default
cuda: a child that cannot start there fails the run, nothing falls
back to the CPU). The weight-plane kill episode
(``run_weight_kill_episode``) drives the port's weight-plane CLI.
Left for later, refused by name: ``--schedule`` (which needs the
fleet simulator).

The failure-handling ingredients — deterministic fault injection
(faults.py), scheduler crash recovery, the durable request journal,
graceful drain, drain-aware routing, and the PD prefill pool with
failover — are each tested in isolation. This module composes them:
it stands up a real topology (router + prefill/
decode/unified engine SUBPROCESSES), drives a mixed workload (greedy +
temperature sampling, speculative tokens, paged-KV pressure), injects
a seed-derived schedule of fault points and process-level kills
(SIGKILL mid-decode, SIGTERM drain, prefill-peer death mid-handoff),
and then asserts the system-level invariants that individual tests
cannot:

  1. **No accepted request is lost.** After recovery + journal drain,
     every journaled admit is tombstoned: the client got an answer,
     or the respawned process resumed and finished the request.
  2. **Greedy streams are byte-identical** to a fault-free oracle run
     of the same (prompt, max_tokens) — failover, restart-resume,
     preemption, and speculation may not change emitted bytes. The
     port also holds them by TOKEN IDS: every greedy stream a serving
     child's journal finished (its ``prog`` records, across
     incarnations) must equal the oracle's journaled ids for the same
     prompt ids and budget. The byte-level tokenizer decodes no text
     for ids past the byte range, so at a real vocabulary the text
     check alone would prove little.
  3. **KV block-pool conservation** (the PagedAttention discipline):
     at quiescence, free + slot-owned blocks account for the whole
     pool (`ome_engine_kv_conservation_ok` — the prefix cache holds
     separate device buffers, outside the pool by design). With the
     host-DRAM prefix tier enabled (the default topology passes
     ``--prefix-cache-host-mb``), the same gauge also folds in the
     two-tier accounting check (PrefixCache.tier_conservation: device
     trie + host LRU bytes exact, no double residency, host budget
     respected), and the harness additionally asserts the exported
     ``ome_engine_prefix_host_bytes`` gauge never exceeds the
     configured budget. SIGKILL mid-swap is covered by invariant 2:
     a killed engine respawns with a COLD host tier, so resumed
     greedy streams must come out byte-identical via the recompute
     fallback — which is exactly what the byte-compare proves.
  4. **/metrics stays consistent**: counters are monotone within one
     process incarnation, and draining gauges return to zero once the
     episode's drains complete.
  5. **No admitted class starves** (multi-tenancy,
     docs/multi-tenancy.md): every priority class with journaled
     admits also finishes requests, and in a noisy-neighbor episode
     the interactive class is never shed (429) — admission must shed
     the lowest class first.
  6. **Weighted shares hold**: over contended polls (two or more
     classes active with at least one queued), every class with
     QUEUED demand decodes at least a tolerance fraction of its
     weighted-fair entitlement (read from
     ``ome_engine_class_tokens_total``); classes that are merely
     demand-limited are out of scope.
  7. **No request is lost fleet-wide** (router HA,
     docs/router-ha.md): every workload request driven through the
     N-router ingress ends with exactly ONE outcome — a client that
     fails over to a surviving router after a transport failure
     never observes a duplicate and is never silently dropped
     (request durability below the routers is invariant 1, checked
     across every engine journal regardless of which router admitted
     the request).
  8. **Breaker observations outlive the replica that made them**:
     the backend records a victim router served in its last pre-kill
     gossip snapshot are held by every surviving router within one
     anti-entropy round of the kill (LWW stamps at least as new), so
     the fleet does not re-learn a dead backend the hard way.

Invariants 5 and 6 get their workload from the ``--noisy-neighbor``
episode kind: a seeded best-effort (batch-class) flood of at least
``--flood-factor``x the topology's slot capacity, steady interactive
traffic throughout, and a mid-episode SIGKILL of a serving engine.

Invariants 7 and 8 get theirs from the ``--router-loss`` episode
kind (requires ``--routers N``, N >= 2): N asyncio routers front the
same engine pool and gossip observations to each other
(router/gossip.py), the seeded schedule arms a keyed
``router_forward`` fault on one victim router so it accumulates real
breaker state, the harness snapshots the victim's /gossip/state,
waits one anti-entropy round, SIGKILLs it mid-replay, and the
workload client fails over across the surviving fronts.

Every schedule derives from ``random.Random(f"{seed}:{episode}")`` —
a violation prints the seed, the exact schedule, and a one-command
replay line. The runner REFUSES to start if any fault point it would
inject is missing from the documented catalog in
docs/failure-semantics.md (``catalog_points``, this module's own
reading of the catalog table), so the harness and the failure-contract
docs cannot drift apart. On a CUDA device it also refuses, before
any child spawns, a ``--kv-block`` the engine's paged kernel does not
take (``refuse_kv_block``, with the engine's own reason).

CLI::

    python -m ome_tpu_torch.chaos --seed 7 --episodes 50 --kv-block 32
    python -m ome_tpu_torch.chaos --seed 7 --episode 23 --device cpu

The subprocess children re-enter through ``--serve-child ROLE ARGS``,
which hands argv to the port's entrypoints unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .priority import (DEFAULT_CLASS_WEIGHTS, PRIORITY_CLASSES,
                       highest_class)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
CATALOG_DOC = REPO_ROOT / "docs" / "failure-semantics.md"

# fault points the schedule generator may draw from, by role. Kept
# deliberately clear of journal_* faults: a degraded journal cannot
# honor invariant 1, so journal durability faults stay in their own
# unit tests (tests/test_journal.py).
ENGINE_FAULT_MENU = ("engine_step",)
PD_FAULT_MENU = ("pd_peer_connect", "pd_fetch", "pd_deserialize",
                 "pd_insert")
ROUTER_FAULT_MENU = ("router_forward",)

# invariant 6 (weighted shares): a class's share of contended-window
# tokens must stay above this fraction of its weighted entitlement;
# the window itself must hold at least this many tokens to be judged
SHARE_TOLERANCE = 0.35
MIN_CONTENDED_TOKENS = 30.0

# router health-loop cadence inside chaos topologies; gossip pulls
# run on the same cadence, so invariant 8 (breaker convergence) gives
# survivors one such round plus the slack to adopt the victim's state
ROUTER_HEALTH_INTERVAL = 1.0
GOSSIP_ROUND_SLACK = 1.5


class ChaosError(RuntimeError):
    """Harness refusal or setup failure (not an invariant violation)."""


# -- fault-catalog preflight -----------------------------------------

CATALOG_HEADING = "fault-point catalog"


def catalog_points(doc: pathlib.Path) -> Set[str]:
    """Backticked names in the fault-point catalog section's table
    rows (first cell of each row) — the reference lint's reading of
    docs/failure-semantics.md (ome_tpu/lint/plugins/catalog_drift.py),
    kept here so the harness loads no script of the reference."""
    points: Set[str] = set()
    in_section = False
    section_level = 0
    for line in doc.read_text(encoding="utf-8").splitlines():
        m = re.match(r"(#+)\s+(.*)", line)
        if m:
            level, title = len(m.group(1)), m.group(2).strip().lower()
            if CATALOG_HEADING in title:
                in_section, section_level = True, level
                continue
            if in_section and level <= section_level:
                in_section = False
            continue
        if in_section and line.lstrip().startswith("|"):
            cells = [c.strip() for c in line.strip().strip("|")
                     .split("|")]
            if cells:
                points.update(re.findall(r"`([A-Za-z0-9_]+)`",
                                         cells[0]))
    return points


def preflight_fault_points(specs: Sequence[str],
                           doc: Optional[pathlib.Path] = None) -> None:
    """Refuse to run a schedule that injects any fault point absent
    from the documented catalog — the same source of truth the
    repository's fault-catalog lint enforces in CI."""
    from . import faults
    points = set()
    for spec in specs:
        if spec:
            points |= faults.spec_points(spec)
    if not points:
        return
    catalog = catalog_points(doc or CATALOG_DOC)
    missing = sorted(points - catalog)
    if missing:
        raise ChaosError(
            "refusing to run: fault point(s) not in the "
            f"failure-semantics catalog: {', '.join(missing)} "
            f"(document them in {CATALOG_DOC.name} first)")


def refuse_kv_block(kv_block: int, device: str,
                    model_dir: str) -> None:
    """On a CUDA device, refuse a paged-KV block size the engine's
    paged decode kernel does not take — BEFORE any child spawns, in
    the engine's own words (the child would exit at start with the
    same reason, ``serve --kv-block N: ...``). The CPU takes any
    block, as the reference does."""
    if not kv_block or not str(device).startswith("cuda"):
        return
    from .engine.serve import _load_cfg
    from .ops.flash import check_paged_coverage
    cfg = _load_cfg(str(model_dir), None)
    try:
        check_paged_coverage(kv_block, cfg.head_dim, cfg.num_heads,
                             cfg.num_kv_heads)
    except ValueError as e:
        raise ChaosError(f"--kv-block {kv_block}: {e}") from None


# -- subprocess management -------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, payload: Optional[dict] = None,
          timeout: float = 10.0,
          headers: Optional[Dict[str, str]] = None
          ) -> Tuple[int, object]:
    """GET (payload None) or POST json; returns (status, parsed body).
    Raises URLError/OSError on transport failure."""
    data = None
    hdrs = dict(headers) if headers else {}
    if payload is not None:
        data = json.dumps(payload).encode()
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw = e.read()
        status = e.code
        e.close()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


class ManagedProc:
    """One child process (engine or router) the harness can kill,
    drain, and respawn. `incarnation` increments per start() so
    metrics samples from different lives are never compared;
    `ready_s` keeps each incarnation's start-to-/health seconds (a
    new engine process on a card pays torch's import, the CUDA
    context, the weights and the program ledger's set-up)."""

    def __init__(self, name: str, role: str, args: List[str],
                 port: int, log_path: pathlib.Path):
        self.name = name
        self.role = role          # "engine" | "router"
        self.args = args          # argv AFTER the role token
        self.port = port
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.incarnation = 0
        self.started_mono: Optional[float] = None
        self.ready_s: List[float] = []

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self, faults_spec: Optional[str] = None) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO_ROOT) + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        env.pop("OME_FAULTS", None)  # faults only via explicit argv
        args = list(self.args)
        if faults_spec:
            args += ["--faults", faults_spec]
        cmd = [sys.executable, "-m", "ome_tpu_torch.chaos",
               "--serve-child", self.role] + args
        self.incarnation += 1
        self.started_mono = time.monotonic()
        log_fh = open(self.log_path, "a", encoding="utf-8")
        log_fh.write(f"\n==== incarnation {self.incarnation}: "
                     f"{' '.join(cmd)}\n")
        log_fh.flush()
        self.proc = subprocess.Popen(
            cmd, cwd=str(REPO_ROOT), env=env, stdout=log_fh,
            stderr=subprocess.STDOUT, start_new_session=True)
        log_fh.close()  # the child owns the fd now

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
            self.proc.wait()

    def term(self) -> None:
        if self.alive():
            self.proc.send_signal(signal.SIGTERM)

    def wait_exit(self, timeout: float = 30.0) -> None:
        if self.proc is None:
            return
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def stop(self) -> None:
        if self.alive():
            self.term()
            self.wait_exit(10.0)
        self.kill()

    def tail(self, n: int = 25) -> str:
        try:
            lines = self.log_path.read_text(
                encoding="utf-8", errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "<no log>"

    def wait_ready(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.alive():
                raise ChaosError(
                    f"{self.name} exited during startup (rc="
                    f"{self.proc.returncode}); log tail:\n"
                    f"{self.tail()}")
            try:
                status, _ = _http(self.url + "/health", timeout=2.0)
                if status == 200:
                    self.ready_s.append(
                        time.monotonic() - self.started_mono)
                    return
            except (urllib.error.URLError, OSError):
                pass
            time.sleep(0.25)
        raise ChaosError(f"{self.name} not ready after {timeout}s; "
                         f"log tail:\n{self.tail()}")


def _serve_child(argv: List[str]) -> int:
    """Re-entry point for harness subprocesses: hand argv to the
    port's entrypoint for the role. The engine's device is its own
    ``--device`` flag (the harness passes its ``device``)."""
    if not argv:
        raise SystemExit("--serve-child needs a role: engine|router")
    role, rest = argv[0], argv[1:]
    if role == "engine":
        from .engine import serve
        return serve.main(rest)
    if role == "router":
        # every chaos topology fronts with the asyncio data path
        # (router/aserver.py); the threaded server remains for
        # in-process tests, but the deployable ingress is async
        from .router import aserver
        return aserver.main(rest)
    raise SystemExit(f"unknown --serve-child role {role!r}")


# -- metrics scraping ------------------------------------------------


def scrape_metrics(url: str, timeout: float = 5.0) -> Dict[str, float]:
    """Parse a Prometheus text exposition into {'name{labels}': value}."""
    status, body = _http(url + "/metrics", timeout=timeout)
    if status != 200:
        raise ChaosError(f"/metrics answered {status} at {url}")
    if isinstance(body, bytes):
        body = body.decode("utf-8", errors="replace")
    elif not isinstance(body, str):
        body = json.dumps(body)
    out: Dict[str, float] = {}
    for line in body.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


class MetricsWatch:
    """Background /metrics poller asserting counter monotonicity
    within each process incarnation. Samples that straddle a restart
    (incarnation changed while scraping) are discarded."""

    def __init__(self, procs: Sequence[ManagedProc],
                 interval: float = 0.5):
        self.procs = list(procs)
        self.interval = interval
        self.violations: List[str] = []
        self._last: Dict[Tuple[str, int], Dict[str, float]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def last_samples(self) -> Dict[str, Dict[str, float]]:
        """The last sample of every (child, incarnation) polled, keyed
        "child#incarnation" — counters as they stood before a kill."""
        return {f"{name}#{inc}": dict(sample)
                for (name, inc), sample in self._last.items()}

    def poll_once(self):
        for p in self.procs:
            inc = p.incarnation
            if not p.alive():
                continue
            try:
                sample = scrape_metrics(p.url, timeout=2.0)
            except (ChaosError, urllib.error.URLError, OSError):
                continue
            if p.incarnation != inc or not p.alive():
                continue  # straddled a restart: not comparable
            prev = self._last.get((p.name, inc))
            if prev is not None:
                for key, val in sample.items():
                    name = key.split("{", 1)[0]
                    if not name.endswith("_total"):
                        continue
                    before = prev.get(key)
                    if before is not None and val < before:
                        self.violations.append(
                            f"counter regression on {p.name} "
                            f"(incarnation {inc}): {key} "
                            f"{before} -> {val}")
            self._last[(p.name, inc)] = sample

    def _run(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.interval)


class ShareSampler:
    """Background poller feeding invariant 6 (weighted shares).

    Each poll reads the per-class token counters and queue-depth
    gauges on every serving engine. A poll is CONTENDED on an engine
    when at least two classes are active (queued, or decoded tokens
    since the previous poll) and at least one of them is queued —
    i.e. the weighted scheduler actually had an allocation decision to
    make. Within a contended poll, only classes with QUEUED demand are
    judged: a class that is not queueing is demand-limited, not
    starved, and must not be held to its entitlement (the interactive
    trickle often has exactly one in-flight request). For each queued
    class the poll accumulates the tokens it actually decoded
    (``got``) and its weight share of the poll's total token delta
    (``entitled``); counter resets (restarts) re-base via the
    (name, incarnation) key, same discipline as MetricsWatch."""

    def __init__(self, procs: Sequence[ManagedProc],
                 interval: float = 0.25):
        self.procs = list(procs)
        self.interval = interval
        self.got: Dict[str, float] = {c: 0.0
                                      for c in PRIORITY_CLASSES}
        self.entitled: Dict[str, float] = {c: 0.0
                                           for c in PRIORITY_CLASSES}
        self.contended_polls = 0
        self._last: Dict[Tuple[str, int], Dict[str, float]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _per_class(sample: Dict[str, float], family: str
                   ) -> Dict[str, float]:
        return {c: sample.get(f'{family}{{class="{c}"}}', 0.0)
                for c in PRIORITY_CLASSES}

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def poll_once(self):
        for p in self.procs:
            inc = p.incarnation
            if not p.alive():
                continue
            try:
                sample = scrape_metrics(p.url, timeout=2.0)
            except (ChaosError, urllib.error.URLError, OSError):
                continue
            if p.incarnation != inc or not p.alive():
                continue
            toks = self._per_class(sample,
                                   "ome_engine_class_tokens_total")
            depth = self._per_class(sample,
                                    "ome_engine_class_queue_depth")
            prev = self._last.get((p.name, inc))
            self._last[(p.name, inc)] = toks
            if prev is None:
                continue
            delta = {c: max(0.0, toks[c] - prev[c])
                     for c in PRIORITY_CLASSES}
            active = {c for c in PRIORITY_CLASSES
                      if depth[c] > 0 or delta[c] > 0}
            queued = {c for c in PRIORITY_CLASSES if depth[c] > 0}
            if len(active) >= 2 and queued:
                self.contended_polls += 1
                total_delta = sum(delta.values())
                if total_delta <= 0:
                    continue
                wsum = sum(DEFAULT_CLASS_WEIGHTS.get(c, 1)
                           for c in active)
                for c in queued:
                    self.got[c] += delta[c]
                    self.entitled[c] += total_delta * (
                        DEFAULT_CLASS_WEIGHTS.get(c, 1) / wsum)

    def _run(self):
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.interval)


# -- journal inspection ----------------------------------------------


def journal_live_entries(path: pathlib.Path) -> Dict[int, dict]:
    """Admitted-but-untombstoned requests in a journal file; a torn
    final line (crash mid-append) is skipped, like replay does."""
    live: Dict[int, dict] = {}
    if not path.exists():
        return live
    for line in path.read_text(encoding="utf-8",
                               errors="replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail
        t, jid = rec.get("t"), rec.get("jid")
        if t == "admit":
            live[jid] = rec
        elif t == "prog" and jid in live:
            live[jid].setdefault("toks", []).extend(rec.get("toks", []))
        elif t == "fin":
            live.pop(jid, None)
    return live


def journal_streams(path: pathlib.Path) -> List[dict]:
    """Every request a journal finished, as {"prompt", "max_new",
    "temp", "toks", "reason"} in admission order: the ids a client
    was streamed, across every incarnation that wrote the file (a
    resumed request keeps its jid and appends more ``prog``
    records). Unfinished and torn records are left out."""
    recs: Dict[int, dict] = {}
    done: List[dict] = []
    if not path.exists():
        return done
    for line in path.read_text(encoding="utf-8",
                               errors="replace").splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail or blank line
        t, jid = rec.get("t"), rec.get("jid")
        if t == "admit":
            recs[jid] = {"prompt": list(rec.get("prompt", [])),
                         "max_new": rec.get("max_new"),
                         "temp": rec.get("temp", 0.0), "toks": []}
        elif t == "prog" and jid in recs:
            recs[jid]["toks"].extend(rec.get("toks", []))
        elif t == "fin" and jid in recs:
            entry = recs.pop(jid)
            entry["reason"] = rec.get("reason")
            done.append(entry)
    return done


# -- workload --------------------------------------------------------


@dataclass
class ChaosRequest:
    prompt: str
    max_tokens: int
    temperature: float
    top_k: int = 0
    top_p: float = 1.0
    delay: float = 0.0
    # priority class (ome_tpu/priority.py); None = engine default
    priority: Optional[str] = None
    # filled by the client thread:
    status: Optional[int] = None
    text: Optional[str] = None
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    # fleet-outcome bookkeeping (invariant 7): complete HTTP
    # responses received and transport-failure failovers taken
    answers: int = 0
    failovers: int = 0

    def payload(self) -> dict:
        out = {"prompt": self.prompt, "max_tokens": self.max_tokens,
               "temperature": self.temperature, "top_k": self.top_k,
               "top_p": self.top_p}
        if self.priority:
            out["priority"] = self.priority
        return out

    def headers(self) -> Dict[str, str]:
        # the header path is what the router forwards verbatim, so
        # noisy-neighbor episodes exercise it alongside the payload
        # field (the engine lets the header win)
        return ({"X-OME-Priority": self.priority}
                if self.priority else {})


def requests_from_trace(path: pathlib.Path,
                        prompt_seed: int = 0) -> List[ChaosRequest]:
    """Trace-driven episodes (--trace): replace the seeded synthetic
    workload with a replay trace (autoscale/trace.py — a saved trace
    file or an engine reqlog), keeping its inter-arrival gaps as the
    per-request start delays. The fault/kill schedule stays seeded,
    so one production trace can soak under many chaos schedules."""
    from .autoscale import trace as trace_mod
    try:
        tr = trace_mod.load_trace(path)
    except (KeyError, ValueError):
        tr = trace_mod.load_reqlog(path)
    if not tr:
        raise ChaosError(f"no replayable records in {path}")
    return [ChaosRequest(prompt=r.prompt_text(prompt_seed),
                         max_tokens=r.max_tokens,
                         temperature=r.temperature,
                         delay=r.arrival,
                         priority=r.priority)
            for r in tr]


def _gen_workload(rng: random.Random, n: int,
                  spread: float) -> List[ChaosRequest]:
    out = []
    for _ in range(n):
        prompt = "".join(rng.choice("abcdefgh ") for _ in
                         range(rng.randint(4, 12)))
        greedy = rng.random() < 0.6
        out.append(ChaosRequest(
            prompt=prompt,
            max_tokens=rng.randint(6, 20),
            temperature=0.0 if greedy else rng.choice((0.7, 1.0)),
            top_k=0 if greedy else rng.choice((0, 20)),
            top_p=1.0 if greedy else rng.choice((1.0, 0.9)),
            delay=rng.uniform(0.0, spread)))
    return out


def _gen_noisy_workload(rng: random.Random, topo: "Topology",
                        spread: float,
                        flood_factor: int) -> List[ChaosRequest]:
    """Noisy-neighbor workload: a batch-class flood of at least
    ``flood_factor``x the topology's concurrent-slot capacity lands in
    the first 40% of the episode, while a steady trickle of
    interactive requests spans the whole spread. Everything is greedy
    so invariant 2 (byte-identity vs the oracle) still applies to the
    tenant traffic under preemption and weighted scheduling."""
    serving = max(1, topo.decode + topo.unified)
    capacity = max(1, topo.max_slots) * serving
    flood_n = max(flood_factor * capacity, 2 * flood_factor)
    out = []
    for _ in range(flood_n):
        prompt = "".join(rng.choice("abcdefgh ") for _ in
                         range(rng.randint(4, 12)))
        out.append(ChaosRequest(
            prompt=prompt,
            max_tokens=rng.randint(8, 16),
            temperature=0.0,
            delay=rng.uniform(0.0, spread * 0.4),
            priority="batch"))
    n_interactive = max(4, capacity + 2)
    for i in range(n_interactive):
        prompt = "".join(rng.choice("abcdefgh ") for _ in
                         range(rng.randint(3, 8)))
        at = spread * (i + 0.5) / n_interactive
        out.append(ChaosRequest(
            prompt=prompt,
            max_tokens=rng.randint(4, 8),
            temperature=0.0,
            delay=max(0.0, at + rng.uniform(-0.1, 0.1)),
            priority=highest_class()))
    return out


def _drive(urls, reqs: Sequence[ChaosRequest],
           timeout: float = 60.0) -> None:
    """Send every request against the router front on client threads,
    honoring per-request start delays; blocks until all have an
    outcome. `urls` is one front URL or a list of N router replicas:
    requests spread across the fronts round-robin, and a TRANSPORT
    failure (connection refused/reset — no HTTP response at all)
    fails over to the next front. An HTTP error status is an answer,
    not a failover: retrying a request the router already answered is
    how clients manufacture duplicates (invariant 7)."""
    if isinstance(urls, str):
        urls = [urls]

    def one(i: int, r: ChaosRequest):
        time.sleep(r.delay)
        last = None
        for k in range(len(urls)):
            url = urls[(i + k) % len(urls)]
            try:
                status, body = _http(url + "/v1/completions",
                                     r.payload(), timeout=timeout,
                                     headers=r.headers())
            except Exception as e:  # noqa: BLE001 — a dead router
                last = f"{type(e).__name__}: {e}"  # is expected chaos
                r.failovers += 1
                continue
            r.answers += 1
            r.status = status
            if status == 200 and isinstance(body, dict):
                choice = (body.get("choices") or [{}])[0]
                r.text = choice.get("text")
                r.finish_reason = choice.get("finish_reason")
            else:
                r.error = str(body)[:200]
            return
        r.error = last or "no router front reachable"

    threads = [threading.Thread(target=one, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30.0)


# -- the episode -----------------------------------------------------


@dataclass
class Topology:
    """Subprocess layout for one episode."""

    prefill: int = 2
    decode: int = 2
    unified: int = 0
    router: bool = True
    # router replicas fronting the pool; >1 turns on gossip peering
    # between them (router_loss episodes require >= 2)
    routers: int = 1
    kv_block: int = 16
    kv_blocks: int = 40
    max_slots: int = 2
    # host-DRAM prefix tier budget (MB) for every engine; 0 disables.
    # On by default so soaks exercise spill/swap-in under kills —
    # the tier is value-neutral (recompute fallback), so invariant 2
    # must hold with it on.
    prefix_host_mb: int = 4
    spec_tokens: int = 0
    pd_local_fallback: bool = False
    drain_grace: float = 4.0

    def engine_count(self) -> int:
        return self.prefill + self.decode + self.unified


@dataclass
class Episode:
    seed: int
    index: int
    topo: Topology
    kind: str = "mixed"        # "mixed" | "noisy" | "router_loss"
    requests: List[ChaosRequest] = field(default_factory=list)
    fault_specs: Dict[str, str] = field(default_factory=dict)
    events: List[Tuple[float, str, str]] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    # what the run measured (ChaosRunner.run_episode; not part of the
    # schedule): "ready_s" {child: start-to-/health seconds per
    # incarnation}, "to_resume" {killed or drained child: journaled
    # requests left live for its respawn}, "resume_s" {respawned
    # child: respawn to its journal holding no live entry},
    # "journal_drain_s", "programs"
    # {engine child: {program key: dispatches}} from /debug/programs,
    # "metrics" {"child#incarnation": last /metrics sample}, and
    # "greedy_ids" (journaled greedy streams held against the oracle)
    measured: Dict[str, object] = field(default_factory=dict)

    def schedule(self) -> dict:
        return {"seed": self.seed, "episode": self.index,
                "kind": self.kind,
                "faults": self.fault_specs,
                "events": [{"at": round(at, 3), "action": act,
                            "target": tgt}
                           for at, act, tgt in self.events],
                "requests": len(self.requests)}

    def replay_command(self) -> str:
        extra = ""
        if self.kind == "noisy":
            extra = " --noisy-neighbor"
        elif self.kind == "router_loss":
            extra = f" --router-loss --routers {self.topo.routers}"
        return (f"python -m ome_tpu_torch.chaos --seed {self.seed} "
                f"--episode {self.index}{extra}")


def _plan_episode(seed: int, index: int, topo: Topology, n_requests: int,
                  spread: float,
                  workload: Optional[Sequence[ChaosRequest]] = None,
                  kind: str = "mixed",
                  flood_factor: int = 5) -> Episode:
    """Everything random in an episode comes from this ONE generator
    seeded by (seed, index) — the whole schedule replays from the two
    numbers a violation prints. A --trace workload substitutes the
    requests (fresh copies: episodes mutate outcome fields) but NOT
    the fault/kill schedule, which stays seed-derived."""
    rng = random.Random(f"{seed}:{index}")
    ep = Episode(seed=seed, index=index, topo=topo, kind=kind)
    if workload is not None:
        ep.requests = [ChaosRequest(
            prompt=r.prompt, max_tokens=r.max_tokens,
            temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
            delay=r.delay, priority=r.priority) for r in workload]
    elif kind == "noisy":
        ep.requests = _gen_noisy_workload(rng, topo, spread,
                                          flood_factor)
    else:
        ep.requests = _gen_workload(rng, n_requests, spread)

    decode_names = [f"decode{i}" for i in range(topo.decode)]
    unified_names = [f"unified{i}" for i in range(topo.unified)]
    prefill_names = [f"prefill{i}" for i in range(topo.prefill)]

    if kind == "noisy":
        # overload IS the chaos: no injected fault points, just one
        # seeded mid-episode SIGKILL of a serving engine so the
        # isolation invariants must survive kill-and-resume too
        serving = decode_names + unified_names
        ep.events.append((rng.uniform(0.35, 0.6) * spread, "sigkill",
                          rng.choice(serving)))
        return ep

    if kind == "router_loss":
        # the chaos IS losing one of N router replicas mid-replay. A
        # keyed router_forward fault first makes the victim accumulate
        # real breaker observations to gossip ("{serving0}" is
        # substituted with the first serving engine's URL at start
        # time — backend ports are not known at plan time); the
        # harness then snapshots the victim's /gossip/state, waits
        # one anti-entropy round so peers pull it, and SIGKILLs the
        # victim while the workload fails over across survivors
        victim = f"router{rng.randint(0, topo.routers - 1)}"
        ep.fault_specs[victim] = (
            "router_forward|{serving0}"
            f".raise@1:{rng.randint(3, 5)}")
        ep.events.append((rng.uniform(0.25, 0.5) * spread,
                          "sigkill_router", victim))
        return ep

    # fault-point schedules: at most one rule per serving proc so an
    # episode stays interpretable; hits land in the episode's early
    # request volume
    for name in decode_names:
        if rng.random() < 0.7:
            point = rng.choice(PD_FAULT_MENU + ENGINE_FAULT_MENU)
            ep.fault_specs[name] = \
                f"{point}.raise@{rng.randint(1, 4)}"
    for name in unified_names:
        if rng.random() < 0.5:
            ep.fault_specs[name] = \
                f"engine_step.raise@{rng.randint(2, 6)}"
    if topo.router and rng.random() < 0.3:
        ep.fault_specs["router"] = \
            f"router_forward.raise@{rng.randint(1, 3)}"

    # process-level events: kills and drains at seeded offsets
    serving = decode_names + unified_names
    n_events = rng.randint(0, 2) if serving else 0
    for _ in range(n_events):
        action = rng.choice(("sigkill", "sigterm"))
        ep.events.append((rng.uniform(0.5, spread),
                          action, rng.choice(serving)))
    if prefill_names and rng.random() < 0.6:
        # prefill-peer death mid-handoff: the decode pool must fail
        # over (or fall back locally) without a scheduler restart
        ep.events.append((rng.uniform(0.2, spread * 0.7),
                          "kill_prefill", rng.choice(prefill_names)))
    ep.events.sort(key=lambda e: e[0])
    return ep


class ChaosRunner:
    """Owns the topology's processes and the per-soak oracle engine;
    runs episodes and evaluates invariants."""

    def __init__(self, topo: Topology, base_dir: pathlib.Path,
                 model_dir: Optional[str] = None,
                 keep_logs: bool = False,
                 journal_drain_timeout: float = 90.0,
                 force_violation: bool = False,
                 device: str = "cuda"):
        self.topo = topo
        # every engine child runs `serve --device <device>`; the CPU
        # only when the caller names it
        self.device = device
        self.base = base_dir
        self.base.mkdir(parents=True, exist_ok=True)
        self.keep_logs = keep_logs
        self.journal_drain_timeout = journal_drain_timeout
        # append a synthetic violation to every episode so the bundle
        # pipeline (flight dumps + merged trace) can be exercised
        # end-to-end without waiting for a real invariant to break
        self.force_violation = force_violation
        # empty model dir + --random-weights = the deterministic
        # tiny_test config with ByteTokenizer: every engine in the
        # topology (and the oracle) inits IDENTICAL weights from
        # --seed 0, which is what makes invariant 2 meaningful
        self.model_dir = model_dir or str(self._ensure_model_dir())
        refuse_kv_block(topo.kv_block, device, self.model_dir)
        self.oracle: Optional[ManagedProc] = None
        self._oracle_cache: Dict[Tuple[str, int], Tuple[str, str]] = {}
        # the oracle journals too: its finished greedy streams are the
        # token ids invariant 2 holds every served stream against
        self.oracle_journal = self.base / "journal-oracle"

    def _ensure_model_dir(self) -> pathlib.Path:
        d = self.base / "model"
        d.mkdir(parents=True, exist_ok=True)
        return d

    # -- oracle ------------------------------------------------------

    def _engine_args(self, port: int, topo: Topology,
                     journal_dir: Optional[pathlib.Path] = None,
                     role: Optional[str] = None,
                     prefill_urls: Sequence[str] = (),
                     reqlog: Optional[pathlib.Path] = None,
                     span_log: Optional[pathlib.Path] = None,
                     flight_dump_dir: Optional[pathlib.Path] = None,
                     debug: bool = False) -> List[str]:
        args = ["--model-dir", self.model_dir, "--random-weights",
                "--device", self.device,
                "--dtype", "float32", "--host", "127.0.0.1",
                "--port", str(port),
                "--max-slots", str(topo.max_slots),
                "--prefix-cache-mb", "8",
                "--drain-grace", str(topo.drain_grace)]
        if topo.prefix_host_mb:
            args += ["--prefix-cache-host-mb",
                     str(topo.prefix_host_mb)]
        if topo.kv_block:
            args += ["--kv-block", str(topo.kv_block),
                     "--kv-blocks", str(topo.kv_blocks)]
        if topo.spec_tokens and role != "prefill":
            args += ["--spec-tokens", str(topo.spec_tokens)]
        if role == "prefill":
            args += ["--disaggregation-mode", "prefill"]
        elif role == "decode":
            args += ["--disaggregation-mode", "decode",
                     "--pd-attempt-timeout", "15"]
            for u in prefill_urls:
                args += ["--prefill-url", u]
            if topo.pd_local_fallback:
                args += ["--pd-local-fallback"]
        if journal_dir is not None:
            args += ["--journal", str(journal_dir),
                     "--journal-fsync", "always"]
        if reqlog is not None:
            args += ["--request-log", str(reqlog)]
        # timeline + flight-recorder capture for the violation bundle:
        # every serving child spans its requests and exposes the
        # guarded /debug/events tail (the oracle stays bare)
        if span_log is not None:
            args += ["--span-log", str(span_log)]
        if flight_dump_dir is not None:
            args += ["--flight-dump-dir", str(flight_dump_dir)]
        if debug:
            args += ["--debug-endpoints"]
        return args

    def start_oracle(self) -> ManagedProc:
        """One fault-free unified engine, alive for the whole soak:
        the reference every greedy response is byte-compared against.
        Its process starts with the first episode's children (its cold
        start overlaps theirs); this waits until it serves."""
        oracle = self._spawn_oracle()
        if len(oracle.ready_s) < oracle.incarnation:
            oracle.wait_ready()
        return oracle

    def _spawn_oracle(self) -> ManagedProc:
        """The oracle's process, started if it is not running; not
        waited for."""
        if self.oracle is not None and self.oracle.alive():
            return self.oracle
        port = free_port()
        topo = Topology(prefill=0, decode=0, unified=1, router=False,
                        kv_block=self.topo.kv_block,
                        kv_blocks=max(self.topo.kv_blocks, 64),
                        max_slots=self.topo.max_slots,
                        spec_tokens=0)
        self.oracle = ManagedProc(
            "oracle", "engine",
            self._engine_args(port, topo,
                              journal_dir=self.oracle_journal), port,
            self.base / "oracle.log")
        self.oracle.start()
        return self.oracle

    def oracle_text(self, prompt: str, max_tokens: int
                    ) -> Tuple[str, str]:
        key = (prompt, max_tokens)
        if key not in self._oracle_cache:
            oracle = self.start_oracle()
            status, body = _http(
                oracle.url + "/v1/completions",
                {"prompt": prompt, "max_tokens": max_tokens,
                 "temperature": 0.0}, timeout=60.0)
            if status != 200 or not isinstance(body, dict):
                raise ChaosError(
                    f"oracle answered {status}: {str(body)[:200]}")
            choice = body["choices"][0]
            self._oracle_cache[key] = (choice.get("text"),
                                       choice.get("finish_reason"))
        return self._oracle_cache[key]

    def close(self):
        if self.oracle is not None:
            self.oracle.stop()

    # -- one episode -------------------------------------------------

    def run_episode(self, ep: Episode) -> Episode:
        preflight_fault_points(list(ep.fault_specs.values()))
        topo = ep.topo
        epdir = self.base / f"ep{ep.index}"
        epdir.mkdir(parents=True, exist_ok=True)

        prefills = []
        for i in range(topo.prefill):
            port = free_port()
            name = f"prefill{i}"
            prefills.append(ManagedProc(
                name, "engine",
                self._engine_args(port, topo, role="prefill",
                                  span_log=epdir / f"{name}.spans.jsonl",
                                  flight_dump_dir=epdir, debug=True),
                port, epdir / f"{name}.log"))
        prefill_urls = [p.url for p in prefills]

        serving = []
        journals: Dict[str, pathlib.Path] = {}
        for i in range(topo.decode):
            port = free_port()
            name = f"decode{i}"
            jdir = epdir / f"journal-{name}"
            journals[name] = jdir / "requests.jsonl"
            serving.append(ManagedProc(
                name, "engine",
                self._engine_args(port, topo, journal_dir=jdir,
                                  role="decode",
                                  prefill_urls=prefill_urls,
                                  reqlog=epdir / f"{name}.reqlog",
                                  span_log=epdir / f"{name}.spans.jsonl",
                                  flight_dump_dir=epdir, debug=True),
                port, epdir / f"{name}.log"))
        for i in range(topo.unified):
            port = free_port()
            name = f"unified{i}"
            jdir = epdir / f"journal-{name}"
            journals[name] = jdir / "requests.jsonl"
            serving.append(ManagedProc(
                name, "engine",
                self._engine_args(port, topo, journal_dir=jdir,
                                  reqlog=epdir / f"{name}.reqlog",
                                  span_log=epdir / f"{name}.spans.jsonl",
                                  flight_dump_dir=epdir, debug=True),
                port, epdir / f"{name}.log"))

        routers: List[ManagedProc] = []
        if topo.router:
            n_routers = max(1, topo.routers)
            rports = [free_port() for _ in range(n_routers)]
            for i, rport in enumerate(rports):
                name = "router" if n_routers == 1 else f"router{i}"
                rargs = ["--bind", "127.0.0.1", "--port", str(rport),
                         "--policy", "round_robin",
                         "--health-interval",
                         str(ROUTER_HEALTH_INTERVAL),
                         "--replica-id", name,
                         "--debug-endpoints",
                         "--span-log",
                         str(epdir / f"{name}.spans.jsonl")]
                for s in serving:
                    rargs += ["--backend", s.url]
                for other in rports:
                    if other != rport:
                        rargs += ["--gossip-peer",
                                  f"http://127.0.0.1:{other}"]
                routers.append(ManagedProc(
                    name, "router", rargs, rport,
                    epdir / f"{name}.log"))

        procs = prefills + serving + routers
        by_name = {p.name: p for p in procs}
        watch = None
        sampler = None
        try:
            for p in prefills + serving:
                p.start(ep.fault_specs.get(p.name))
            self._spawn_oracle()
            for p in prefills + serving:
                p.wait_ready()
            for r in routers:
                r.start(self._router_faults(ep, r.name, serving))
            for r in routers:
                r.wait_ready()

            watch = MetricsWatch(procs).start()
            if ep.kind == "noisy":
                sampler = ShareSampler(serving).start()
            fronts = [r.url for r in routers] or [serving[0].url]

            # workload client threads + the kill/term schedule run
            # concurrently — which is what puts a kill "mid-handoff"
            clients = threading.Thread(
                target=_drive, args=(fronts, ep.requests), daemon=True)
            t0 = time.monotonic()
            clients.start()
            killed: List[ManagedProc] = []
            for at, action, target in ep.events:
                delay = t0 + at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                victim = by_name.get(target)
                if victim is None or not victim.alive():
                    continue
                if action == "sigkill_router":
                    # invariant 8 setup: capture what the victim knew,
                    # give peers one anti-entropy round to pull it,
                    # THEN kill — survivors must hold that state
                    snap = None
                    try:
                        status, body = _http(
                            victim.url + "/gossip/state", timeout=5.0)
                        if status == 200 and isinstance(body, dict):
                            snap = body
                    except (urllib.error.URLError, OSError):
                        pass
                    time.sleep(ROUTER_HEALTH_INTERVAL
                               + GOSSIP_ROUND_SLACK)
                    victim.kill()
                    self._check_breaker_convergence(
                        ep, victim.name, snap,
                        [r for r in routers
                         if r is not victim and r.alive()])
                elif action == "sigkill" or action == "kill_prefill":
                    victim.kill()
                else:
                    victim.term()
                    victim.wait_exit(topo.drain_grace + 20.0)
                killed.append(victim)
            clients.join(180.0)

            # recovery: every killed/drained proc respawns FAULT-FREE
            # (the schedule already fired; replay must re-run it, not
            # the respawn), then resumes its journal
            for victim in killed:
                victim.wait_exit(5.0)
            # the journaled requests each respawn has to resume
            ep.measured["to_resume"] = {
                v.name: len(journal_live_entries(journals[v.name]))
                for v in killed if v.name in journals}
            for victim in killed:
                victim.start()
            for victim in killed:
                victim.wait_ready()

            t_drain = time.monotonic()
            self._await_journal_drain(ep, journals, by_name)
            ep.measured["journal_drain_s"] = time.monotonic() - t_drain
            if sampler is not None:
                sampler.stop()
                sampler.poll_once()
            self._check_journals(ep, journals)
            self._check_fleet_outcomes(ep)
            self._check_class_starvation(ep, journals)
            self._check_greedy(ep)
            self._check_greedy_ids(ep, journals)
            self._check_kv_conservation(ep, serving)
            self._check_draining_zero(ep, routers)
            if sampler is not None:
                self._check_weighted_shares(ep, sampler)
            watch.stop()
            watch.poll_once()
            ep.violations.extend(watch.violations)
            ep.measured["metrics"] = watch.last_samples()
            watch = None
            ep.measured["ready_s"] = {p.name: list(p.ready_s)
                                      for p in procs}
            ep.measured["programs"] = self._programs(prefills + serving)
            if self.force_violation:
                ep.violations.append(
                    "forced violation (--force-violation)")
            if ep.violations:
                # grab the bundle while the children are still alive —
                # /debug/events only answers from a live process
                self.collect_bundle(ep, epdir, procs)
        finally:
            if watch is not None:
                watch.stop()
            if sampler is not None:
                sampler.stop()
            for p in procs:
                p.stop()
        return ep

    @staticmethod
    def _router_faults(ep: Episode, name: str,
                       serving: Sequence[ManagedProc]
                       ) -> Optional[str]:
        """A router's fault spec with plan-time placeholders bound to
        the ports this episode actually got ("{serving0}" = first
        serving engine's URL, the backend the victim's keyed
        router_forward rule fails against)."""
        spec = ep.fault_specs.get(name)
        if spec and serving:
            spec = spec.replace("{serving0}", serving[0].url)
        return spec

    # -- violation bundle --------------------------------------------

    def collect_bundle(self, ep: Episode, epdir: pathlib.Path,
                       procs: Sequence[ManagedProc]
                       ) -> Optional[pathlib.Path]:
        """Violation replay bundle under ``<epdir>/bundle``: the
        schedule + violations, a flight-recorder dump per live engine
        child (via the guarded ``/debug/events`` tail), any crash
        auto-dumps the children already wrote into the episode dir,
        and every span log merged into one exported Perfetto trace
        (telemetry/export.py). Best-effort by design — a half-dead
        topology must not turn a violation report into a second
        failure."""
        bundle = epdir / "bundle"
        try:
            bundle.mkdir(parents=True, exist_ok=True)
        except OSError:
            return None

        flight_paths: List[pathlib.Path] = []
        for p in procs:
            if p.role != "engine" or not p.alive():
                continue
            try:
                status, doc = _http(p.url + "/debug/events?n=0",
                                    timeout=5.0)
            except (urllib.error.URLError, OSError):
                continue
            if status != 200 or not isinstance(doc, dict):
                continue
            # shape the endpoint doc like a FlightRecorder.dump()
            # file so the exporter (and a human) reads both the same
            doc.setdefault("pid", p.proc.pid if p.proc else 0)
            doc.setdefault("reason", "chaos_violation")
            doc["component"] = p.name
            path = bundle / f"flight-{p.name}.json"
            try:
                path.write_text(
                    json.dumps(doc, separators=(",", ":"),
                               default=str) + "\n", encoding="utf-8")
            except OSError:
                continue
            flight_paths.append(path)
        # crash recovery inside a child auto-dumps into the episode
        # dir (--flight-dump-dir): fold those lives in too
        flight_paths.extend(sorted(epdir.glob("flight-*.json")))

        # per-router replica state (breaker/gossip/stream view): what
        # each surviving front believed when the invariant broke
        for p in procs:
            if p.role != "router" or not p.alive():
                continue
            try:
                status, doc = _http(p.url + "/debug/state",
                                    timeout=5.0)
            except (urllib.error.URLError, OSError):
                continue
            if status != 200 or not isinstance(doc, dict):
                continue
            try:
                (bundle / f"router-state-{p.name}.json").write_text(
                    json.dumps(doc, indent=2, default=str) + "\n",
                    encoding="utf-8")
            except OSError:
                continue

        span_paths = sorted(epdir.glob("*.spans.jsonl"))
        try:
            from .telemetry import export as trace_export
            spans = trace_export.load_spans(span_paths)
            flights = trace_export.load_flight_dumps(flight_paths)
            doc = trace_export.build_trace(spans, flights)
            (bundle / "trace.json").write_text(
                json.dumps(doc, separators=(",", ":")) + "\n",
                encoding="utf-8")
        except Exception as e:  # noqa: BLE001 — see docstring
            ep.violations.append(
                f"bundle: trace export failed: "
                f"{type(e).__name__}: {e}")
        try:
            (bundle / "violation.json").write_text(
                json.dumps({"schedule": ep.schedule(),
                            "violations": ep.violations,
                            "replay": ep.replay_command(),
                            "span_logs": [str(s) for s in span_paths],
                            "flight_dumps": [str(f)
                                             for f in flight_paths]},
                           indent=2) + "\n", encoding="utf-8")
        except OSError:
            return None
        print(f"[chaos] violation bundle: {bundle}", flush=True)
        return bundle

    # -- invariants --------------------------------------------------

    def _await_journal_drain(self, ep: Episode,
                             journals: Dict[str, pathlib.Path],
                             by_name: Dict[str, ManagedProc]) -> None:
        # respawn-to-resume: from a respawned child's start until its
        # journal first holds no live entry
        resume_s: Dict[str, float] = ep.measured.setdefault(
            "resume_s", {})
        deadline = time.monotonic() + self.journal_drain_timeout
        while time.monotonic() < deadline:
            leftover = {name: journal_live_entries(path)
                        for name, path in journals.items()}
            for name, live in leftover.items():
                p = by_name.get(name)
                if not live and name not in resume_s and p is not None \
                        and p.incarnation > 1:
                    resume_s[name] = time.monotonic() - p.started_mono
            if not any(leftover.values()):
                return
            # a proc that crashed OUTSIDE the schedule (startup race,
            # OOM) would wedge this wait — surface it instead
            for name in leftover:
                p = by_name.get(name)
                if p is not None and not p.alive():
                    ep.violations.append(
                        f"{name} died outside the schedule with "
                        f"{len(leftover[name])} journaled request(s) "
                        f"unresumed; log tail:\n{p.tail()}")
                    return
            time.sleep(0.5)
        # timed out: _check_journals reports the specifics

    def _check_journals(self, ep: Episode,
                        journals: Dict[str, pathlib.Path]) -> None:
        """Invariant 1: journal ⊕ responses cover all admits — after
        recovery + resume, no admit record is left untombstoned."""
        for name, path in journals.items():
            live = journal_live_entries(path)
            if live:
                ep.violations.append(
                    f"request-loss: {name} journal has "
                    f"{len(live)} admitted request(s) never finished "
                    f"(jids {sorted(live)[:8]})")

    def _check_class_starvation(self, ep: Episode,
                                journals: Dict[str, pathlib.Path]
                                ) -> None:
        """Invariant 5: no admitted class starves. Per class, admits
        across the topology's journals must be matched by finishes —
        a class-wide zero means the weighted scheduler never ran that
        class at all (individual stragglers are invariant 1's job).
        In a noisy-neighbor episode, additionally: the interactive
        class is never shed (429). Admission sheds the lowest class
        first, and the episode's interactive demand is modest by
        construction, so any interactive 429 is a shedding-order
        violation."""
        admits: Dict[str, int] = {}
        fins: Dict[str, int] = {}
        for path in journals.values():
            if not path.exists():
                continue
            cls_of: Dict[int, str] = {}
            for line in path.read_text(encoding="utf-8",
                                       errors="replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail
                t, jid = rec.get("t"), rec.get("jid")
                if t == "admit":
                    cls = rec.get("cls", "standard")
                    cls_of[jid] = cls
                    admits[cls] = admits.get(cls, 0) + 1
                elif t == "fin" and jid in cls_of:
                    cls = cls_of[jid]
                    fins[cls] = fins.get(cls, 0) + 1
        for cls in sorted(admits):
            if admits[cls] and not fins.get(cls):
                ep.violations.append(
                    f"class starvation: class {cls!r} admitted "
                    f"{admits[cls]} request(s) but finished none")
        if ep.kind != "noisy":
            return
        shed = [r for r in ep.requests
                if r.priority == highest_class() and r.status == 429]
        if shed:
            ep.violations.append(
                f"shedding-order violation: {len(shed)} interactive "
                f"request(s) got 429 during a batch flood — admission "
                f"must shed the lowest class first")

    def _check_weighted_shares(self, ep: Episode,
                               sampler: ShareSampler) -> None:
        """Invariant 6: a class with QUEUED demand during contended
        polls must decode at least SHARE_TOLERANCE of its weighted
        entitlement over those polls. Judging only queued classes
        keeps demand-limited traffic out of scope (an interactive
        trickle with one in-flight request is not starved just
        because batch fills the other slots), while a queued class
        that the scheduler ignores sits near 0% and is caught. The
        floor is loose on purpose: sampling is coarse (0.25s polls vs
        per-step allocation) and slot granularity skews short
        windows."""
        for cls in PRIORITY_CLASSES:
            entitled = sampler.entitled[cls]
            if entitled < MIN_CONTENDED_TOKENS:
                continue  # not enough queued demand to judge
            got = sampler.got[cls]
            if got < entitled * SHARE_TOLERANCE:
                ep.violations.append(
                    f"weighted-share violation: class {cls!r} "
                    f"decoded {int(got)} tokens against a weighted "
                    f"entitlement of {int(entitled)} while queued "
                    f"(floor {SHARE_TOLERANCE:.0%}, "
                    f"{sampler.contended_polls} contended polls)")

    def _check_greedy(self, ep: Episode) -> None:
        """Invariant 2: greedy completions match the fault-free
        oracle byte-for-byte. Only cleanly finished responses compare
        — errored/timed-out/shutdown requests are covered by the
        journal invariant instead."""
        for r in ep.requests:
            if r.temperature != 0.0 or r.status != 200:
                continue
            if r.finish_reason not in ("stop", "length"):
                continue
            want_text, want_fin = self.oracle_text(r.prompt,
                                                   r.max_tokens)
            if r.text != want_text or r.finish_reason != want_fin:
                ep.violations.append(
                    "greedy divergence: prompt "
                    f"{r.prompt!r} max_tokens={r.max_tokens}: got "
                    f"{r.text!r} ({r.finish_reason}), oracle "
                    f"{want_text!r} ({want_fin})")

    def _check_greedy_ids(self, ep: Episode,
                          journals: Dict[str, pathlib.Path]) -> None:
        """Invariant 2 by token ids: every greedy stream a serving
        child's journal finished ("stop" or "length", across its
        incarnations) equals the oracle's journaled ids for the same
        prompt ids and budget. The oracle first answers every greedy
        request of the episode (a stream a kill tore from its client
        may still have been resumed and finished server-side)."""
        for r in ep.requests:
            if r.temperature == 0.0:
                self.oracle_text(r.prompt, r.max_tokens)
        # the oracle answers before its scheduler appends the tombstone
        oracle_wal = self.oracle_journal / "requests.jsonl"
        deadline = time.monotonic() + 10.0
        while journal_live_entries(oracle_wal) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        want: Dict[Tuple[Tuple[int, ...], int], List[int]] = {}
        for rec in journal_streams(oracle_wal):
            if rec["temp"] == 0.0 and rec["reason"] in ("stop", "length"):
                want[(tuple(rec["prompt"]), rec["max_new"])] = rec["toks"]
        checked = 0
        for name, path in journals.items():
            for rec in journal_streams(path):
                if rec["temp"] != 0.0 or \
                        rec["reason"] not in ("stop", "length"):
                    continue
                key = (tuple(rec["prompt"]), rec["max_new"])
                ref = want.get(key)
                if ref is None:
                    ep.violations.append(
                        f"greedy ids: {name} finished a greedy stream "
                        f"(prompt ids {rec['prompt'][:12]}, max_new "
                        f"{rec['max_new']}) the oracle never journaled")
                    continue
                checked += 1
                if rec["toks"] != ref:
                    at = next((i for i, (a, b) in enumerate(
                        zip(rec["toks"], ref)) if a != b),
                        min(len(rec["toks"]), len(ref)))
                    ep.violations.append(
                        f"greedy id divergence on {name}: prompt ids "
                        f"{rec['prompt'][:12]} max_new {rec['max_new']}"
                        f": first differs at token {at} (got "
                        f"{rec['toks'][at:at + 4]}, oracle "
                        f"{ref[at:at + 4]}; lengths {len(rec['toks'])}"
                        f"/{len(ref)})")
        ep.measured["greedy_ids"] = checked

    def _programs(self, procs: Sequence[ManagedProc]
                  ) -> Dict[str, dict]:
        """Each live engine child's program ledger
        (``GET /debug/programs``): its device row and dispatches per
        program key — which of the engine's programs (prefill, paged
        decode, ...) this incarnation ran, and on what."""
        out: Dict[str, dict] = {}
        for p in procs:
            if p.role != "engine" or not p.alive():
                continue
            try:
                status, body = _http(p.url + "/debug/programs",
                                     timeout=5.0)
            except (urllib.error.URLError, OSError):
                continue
            if status != 200 or not isinstance(body, dict):
                continue
            out[p.name] = {
                "device": body.get("device"),
                "dispatches": {e.get("program"): e.get("dispatches")
                               for e in body.get("programs") or []}}
        return out

    def _check_kv_conservation(self, ep: Episode,
                               serving: Sequence[ManagedProc]) -> None:
        """Invariant 3: at quiescence every paged pool conserves
        blocks (free + owned = total − trash block); the gauge is
        computed per scrape by Scheduler.update_gauges."""
        if not ep.topo.kv_block:
            return
        for p in serving:
            if not p.alive():
                continue
            try:
                sample = scrape_metrics(p.url)
            except (ChaosError, urllib.error.URLError, OSError) as e:
                ep.violations.append(
                    f"kv-conservation: cannot scrape {p.name}: {e}")
                continue
            ok = sample.get("ome_engine_kv_conservation_ok")
            if ok is not None and ok != 1.0:
                ep.violations.append(
                    f"kv-conservation violated on {p.name}: free="
                    f"{sample.get('ome_engine_kv_blocks_free')} "
                    f"owned={sample.get('ome_engine_kv_blocks_owned')} "
                    f"host_bytes="
                    f"{sample.get('ome_engine_prefix_host_bytes')}")
            # host-tier budget from the exported gauge: the in-process
            # tier_conservation check already folds into the gauge
            # above; this asserts the same bound end to end through
            # /metrics, the surface an operator actually alerts on
            host = sample.get("ome_engine_prefix_host_bytes")
            budget = ep.topo.prefix_host_mb * (1 << 20)
            if host is not None and budget and host > budget:
                ep.violations.append(
                    f"host-tier over budget on {p.name}: "
                    f"ome_engine_prefix_host_bytes={int(host)} > "
                    f"{budget}")

    def _check_draining_zero(self, ep: Episode,
                             routers: Sequence[ManagedProc]) -> None:
        """Invariant 4b: once the episode's drains finish, every live
        router's draining gauge returns to zero (the health loop
        re-probes at --health-interval)."""
        for router in routers:
            if not router.alive():
                continue
            deadline = time.monotonic() + 15.0
            last = None
            while time.monotonic() < deadline:
                try:
                    sample = scrape_metrics(router.url)
                except (ChaosError, urllib.error.URLError, OSError):
                    last = None
                    break
                last = sample.get("ome_router_backends_draining", 0.0)
                if not last:
                    break
                time.sleep(1.0)
            if last:
                ep.violations.append(
                    f"draining gauge stuck on {router.name}: "
                    f"ome_router_backends_draining={last} after "
                    f"episode end")

    def _check_fleet_outcomes(self, ep: Episode) -> None:
        """Invariant 7: every workload request ends with exactly one
        outcome fleet-wide. The failover client records how many
        complete HTTP responses it observed; more than one is a
        duplicate (a client retried a request some router had already
        answered), zero with no recorded transport error is a silent
        drop. Failing over only on transport failure — never on an
        HTTP status — is what makes both impossible by construction;
        this check pins that contract against client regressions."""
        for i, r in enumerate(ep.requests):
            if r.answers > 1:
                ep.violations.append(
                    f"fleet outcome: request {i} observed "
                    f"{r.answers} answers across router fronts "
                    f"(duplicate)")
            if r.answers == 0 and r.error is None:
                ep.violations.append(
                    f"fleet outcome: request {i} vanished — no "
                    f"response and no transport error recorded")

    def _check_breaker_convergence(
            self, ep: Episode, victim_name: str,
            snap: Optional[dict],
            survivors: Sequence[ManagedProc]) -> None:
        """Invariant 8: every real observation (stamp > 0) the victim
        router served in its last pre-kill gossip snapshot is held by
        every surviving router within one anti-entropy round of the
        kill — held meaning the survivor's record for that backend
        carries an LWW stamp at least as new (its own fresher
        observation also satisfies the invariant)."""
        if not survivors:
            return
        if not isinstance(snap, dict):
            ep.violations.append(
                f"gossip convergence: no pre-kill snapshot from "
                f"{victim_name} (/gossip/state unreachable)")
            return
        needed = {
            url: rec
            for url, rec in (snap.get("backends") or {}).items()
            if isinstance(rec, dict) and rec.get("stamp", 0) > 0}
        # say what the invariant is judging so a clean episode is
        # auditable as non-vacuous from the soak log alone
        print(f"[chaos] invariant 8: {victim_name} served "
              f"{len(needed)} real observation(s); checking "
              f"{len(survivors)} survivor(s)", flush=True)
        if not needed:
            return
        pending = {(s.name, url) for s in survivors for url in needed}
        states: Dict[str, dict] = {}
        deadline = time.monotonic() + ROUTER_HEALTH_INTERVAL \
            + GOSSIP_ROUND_SLACK
        while pending and time.monotonic() < deadline:
            for s in survivors:
                if not s.alive():
                    pending -= {(s.name, u) for u in needed}
                    continue
                try:
                    status, body = _http(s.url + "/gossip/state",
                                         timeout=3.0)
                except (urllib.error.URLError, OSError):
                    continue
                if status != 200 or not isinstance(body, dict):
                    continue
                have = body.get("backends") or {}
                states[s.name] = have
                for url, rec in needed.items():
                    mine = have.get(url)
                    if isinstance(mine, dict) and \
                            (mine.get("stamp", 0.0),
                             mine.get("origin", "")) >= \
                            (rec.get("stamp", 0.0),
                             rec.get("origin", "")):
                        pending.discard((s.name, url))
            if pending:
                time.sleep(0.25)
        for name, url in sorted(pending):
            want = needed[url]
            have = (states.get(name) or {}).get(url)
            ep.violations.append(
                f"gossip convergence: {name} did not adopt "
                f"{victim_name}'s observation of {url} within one "
                f"anti-entropy round (want stamp >= "
                f"{want.get('stamp')} origin {want.get('origin')!r}, "
                f"have {have and have.get('stamp')})")


# -- weight-plane kill episode (docs/model-fleet.md) -----------------


def _hash_tree(root: pathlib.Path) -> Dict[str, str]:
    """{relative path: sha256} of every file under `root` but the fetch
    manifests, hashed on threads (hashlib lets go of the GIL over large
    buffers, so a multi-GB checkpoint hashes in parallel)."""
    import concurrent.futures

    from .storage.base import sha256_file
    files = [p for p in sorted(root.rglob("*"))
             if p.is_file() and not p.name.startswith(".ome_fetch_")]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return dict(zip((str(p.relative_to(root)) for p in files),
                        ex.map(lambda p: sha256_file(str(p)), files)))


def kill_and_resume_fetch(src: pathlib.Path, target: pathlib.Path, *,
                          name: str, slow_s: float, kill_when,
                          timeout: float = 120.0
                          ) -> Tuple[Dict[str, object], List[str]]:
    """SIGKILL the port's weight-plane CLI mid-download of `src` (a
    directory, fetched from local://) into `target`, re-run it, and
    check the weight plane's failure contract (docs/model-fleet.md):

      1. the serving path NEVER holds a partial tree — until a
         complete publish it does not exist at all, and is never
         ``is_published``;
      2. every object the staging manifest recorded before the kill
         has its staged bytes intact (size + sha256 match) — the
         ledger never gets ahead of the disk;
      3. the re-run RESUMES: every object recorded before the kill is
         skipped (``resumed`` counts them all), the tree publishes,
         and the published bytes are identical to the source.

    The kill lands deterministically mid-download: each object is
    paced by a ``weight_fetch.slow`` rule of `slow_s` seconds, and the
    child is killed once `kill_when(manifest)` holds for its staging
    manifest — not by racing a wall-clock sleep against process
    startup. Returns what happened (``recorded``: the manifest's
    records at the kill; ``stats``: the re-run's; ``source_sha256``;
    ``killed_after_s``, ``rerun_wall_s``, ``hash_s``) and the violation
    list (empty = contract held).
    """
    from .modelagent import weightplane
    from .storage.base import sha256_file

    preflight_fault_points([f"weight_fetch.slow={slow_s}@1:1"])
    src, target = pathlib.Path(src), pathlib.Path(target)
    out: Dict[str, object] = {}
    violations: List[str] = []
    n_objects = sum(1 for p in src.rglob("*") if p.is_file())
    cli = [sys.executable, "-m", "ome_tpu_torch.modelagent.weightplane",
           "--source", f"local://{src}", "--target", str(target),
           "--name", name, "--workers", "2"]
    staging = pathlib.Path(weightplane.staging_dir(str(target)))
    t0 = time.monotonic()
    with open(target.parent / "agent.log", "ab") as lf:
        proc = subprocess.Popen(
            cli + ["--faults", f"weight_fetch.slow={slow_s}@1:{n_objects}"],
            stdout=lf, stderr=lf, cwd=str(REPO_ROOT))
    deadline = t0 + timeout
    try:
        while True:
            m = weightplane.FetchManifest.load(str(staging))
            if m is not None and kill_when(m):
                break
            if proc.poll() is not None:
                violations.append(
                    f"agent exited (rc={proc.returncode}) before the "
                    "kill point — the episode never got to kill "
                    "mid-download")
                return out, violations
            if time.monotonic() > deadline:
                violations.append(f"manifest never reached the kill "
                                  f"point within {timeout:g}s")
                return out, violations
            # the serving path must not flicker into existence while
            # the download is in flight
            if target.exists():
                violations.append(
                    "serving path exists mid-download (invariant 1)")
            time.sleep(0.01)
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out["killed_after_s"] = time.monotonic() - t0

    # invariant 1: nothing partial at the serving path
    if target.exists():
        violations.append("serving path exists after mid-download "
                          "SIGKILL (invariant 1)")
    if weightplane.is_published(str(target)):
        violations.append("partial tree reads as published "
                          "(invariant 1)")

    # invariant 2: the manifest never gets ahead of the disk
    m = weightplane.FetchManifest.load(str(staging))
    if m is None or not m.objects:
        violations.append("no staging manifest survived the kill")
        return out, violations
    if m.complete:
        violations.append("staging manifest marked complete before "
                          "publish (invariant 1)")
    recorded = dict(m.objects)
    out["recorded"] = recorded
    for rel, rec in recorded.items():
        p = staging / rel
        if not p.is_file():
            violations.append(f"manifest records {rel} but the staged "
                              "file is missing (invariant 2)")
        elif p.stat().st_size != rec["size"] \
                or sha256_file(str(p)) != rec["sha256"]:
            violations.append(f"staged {rel} does not match its "
                              "manifest record (invariant 2)")

    # invariant 3: the re-run resumes from verified objects and
    # publishes a byte-identical tree
    t0 = time.monotonic()
    rerun = subprocess.run(cli, capture_output=True, text=True,
                           timeout=timeout, cwd=str(REPO_ROOT))
    out["rerun_wall_s"] = time.monotonic() - t0
    if rerun.returncode != 0:
        violations.append(f"re-run failed (rc={rerun.returncode}): "
                          f"{rerun.stdout[-300:]}{rerun.stderr[-300:]}")
        return out, violations
    stats = json.loads(rerun.stdout.strip().splitlines()[-1])
    out["stats"] = stats
    if stats.get("resumed", 0) != len(recorded):
        violations.append(
            f"re-run resumed {stats.get('resumed')} objects, expected "
            f"every one of the {len(recorded)} recorded before the "
            "kill (invariant 3)")
    if not weightplane.is_published(str(target)):
        violations.append("re-run did not publish (invariant 3)")
    if staging.exists():
        violations.append("staging dir survived publish (invariant 3)")
    t0 = time.monotonic()
    out["source_sha256"] = want = _hash_tree(src)
    got = _hash_tree(target)
    out["hash_s"] = time.monotonic() - t0
    if got != want:
        violations.append("published tree is not byte-identical to "
                          "the source (invariant 3): "
                          f"{sorted(set(got.items()) ^ set(want.items()))}")
    return out, violations


def run_weight_kill_episode(seed: int, base_dir: pathlib.Path, *,
                            n_objects: int = 24, obj_kb: int = 8,
                            slow_s: float = 0.05,
                            timeout: float = 120.0) -> List[str]:
    """SIGKILL the model agent mid-download and assert the weight
    plane's failure contract (`kill_and_resume_fetch`) over a
    seed-derived source tree: sizes and bytes reproduce per seed, and
    the seed picks how many objects the manifest records before the
    kill. The seed gives the reference's source tree and kill
    threshold. Returns the violation list (empty = episode clean).
    """
    rng = random.Random(seed)
    base_dir = pathlib.Path(base_dir)
    src = base_dir / "source"
    target = base_dir / "served" / "model"
    target.parent.mkdir(parents=True, exist_ok=True)
    src.mkdir(parents=True, exist_ok=True)
    for i in range(n_objects):
        size = obj_kb * 1024 + rng.randrange(obj_kb * 1024)
        (src / f"shard-{i:03d}.bin").write_bytes(
            rng.getrandbits(8 * size).to_bytes(size, "little"))
    kill_after = rng.randint(max(2, n_objects // 4),
                             max(3, n_objects // 2))
    _, violations = kill_and_resume_fetch(
        src, target, name=f"chaos-seed{seed}", slow_s=slow_s,
        kill_when=lambda m: len(m.objects) >= kill_after, timeout=timeout)
    return violations


# -- left for later -------------------------------------------------

SCHEDULE_NOT_PORTED = (
    "--schedule is not ported yet: it down-converts a fleet-simulator "
    "FaultSchedule (sim/faultplan.py), and the port has no sim/ yet")


# -- soak entry ------------------------------------------------------


def run_soak(seed: int, episodes: Sequence[int], topo: Topology,
             base_dir: pathlib.Path, n_requests: int, spread: float,
             keep_logs: bool = False,
             journal_drain_timeout: float = 90.0,
             force_violation: bool = False,
             workload: Optional[Sequence[ChaosRequest]] = None,
             kind: str = "mixed", flood_factor: int = 5,
             device: str = "cuda", model_dir: Optional[str] = None) -> int:
    from .telemetry import Registry
    registry = Registry()
    c_episodes = registry.counter("ome_chaos_episodes_total",
                                  "Chaos episodes completed")
    c_requests = registry.counter("ome_chaos_requests_total",
                                  "Chaos workload requests driven")
    c_violations = registry.counter(
        "ome_chaos_invariant_failures_total",
        "Invariant violations detected across the soak")
    runner = ChaosRunner(topo, base_dir, model_dir=model_dir,
                         keep_logs=keep_logs,
                         journal_drain_timeout=journal_drain_timeout,
                         force_violation=force_violation, device=device)
    failed = []
    try:
        for index in episodes:
            ep = _plan_episode(seed, index, topo, n_requests, spread,
                               workload=workload, kind=kind,
                               flood_factor=flood_factor)
            print(f"[chaos] episode {index} ({ep.kind}): "
                  f"{len(ep.requests)} requests, faults="
                  f"{ep.fault_specs or '{}'}, events="
                  f"{[(round(a, 2), b, c) for a, b, c in ep.events]}",
                  flush=True)
            runner.run_episode(ep)
            c_episodes.inc()
            c_requests.inc(len(ep.requests))
            if ep.violations:
                c_violations.inc(len(ep.violations))
                failed.append(ep)
                print(f"[chaos] EPISODE {index} FAILED "
                      f"({len(ep.violations)} violation(s)):",
                      flush=True)
                for v in ep.violations:
                    print(f"  - {v}", flush=True)
                print("[chaos] schedule: "
                      + json.dumps(ep.schedule()), flush=True)
                print(f"[chaos] replay: {ep.replay_command()}",
                      flush=True)
            else:
                print(f"[chaos] episode {index} OK", flush=True)
    finally:
        runner.close()
    total = len(list(episodes))
    print(f"[chaos] soak done: {total - len(failed)}/{total} episodes "
          f"clean, {int(c_violations.value)} violation(s)", flush=True)
    if failed:
        print("[chaos] replay failing episodes with:", flush=True)
        for ep in failed:
            print(f"  {ep.replay_command()}", flush=True)
    return 1 if failed else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ome_tpu_torch.chaos",
        description="Seed-replayable chaos soak over a router + "
                    "prefill/decode/unified engine topology of the "
                    "port's engines, with invariant checking "
                    "(docs/README.md). Subprocess re-entry: "
                    "--serve-child {engine,router} ARGS...")
    p.add_argument("--seed", type=int, default=0,
                   help="schedule seed; a violation's printed "
                        "(seed, episode) pair replays exactly")
    p.add_argument("--episodes", type=int, default=5,
                   help="number of episodes (0..N-1) to run")
    p.add_argument("--episode", type=int, default=None,
                   help="run exactly ONE episode index (replay mode)")
    p.add_argument("--prefill", type=int, default=2,
                   help="prefill engines in the PD pool")
    p.add_argument("--decode", type=int, default=2,
                   help="PD decode engines behind the router")
    p.add_argument("--unified", type=int, default=0,
                   help="monolithic (non-PD) engines behind the router")
    p.add_argument("--no-router", action="store_true",
                   help="drive the first serving engine directly")
    p.add_argument("--routers", type=int, default=1,
                   help="router replicas fronting the pool; >1 peers "
                        "them with anti-entropy gossip and spreads "
                        "the workload across the fronts with "
                        "client-side failover")
    p.add_argument("--requests", type=int, default=10,
                   help="workload requests per episode")
    p.add_argument("--spread", type=float, default=4.0,
                   help="seconds the workload (and fault events) are "
                        "spread over")
    p.add_argument("--trace", default=None,
                   help="replay-driven episodes: drive each episode "
                        "with this trace (autoscale save_trace JSONL "
                        "or engine reqlog) instead of the synthetic "
                        "workload; the fault/kill schedule stays "
                        "seed-derived, and --spread grows to cover "
                        "the trace duration")
    p.add_argument("--schedule", default=None,
                   help="fidelity spot-check: down-convert a "
                        "simulator FaultSchedule JSON "
                        "(sim/faultplan.py) onto this topology; NOT "
                        "PORTED YET (needs sim/): refused by name")
    p.add_argument("--device", default="cuda",
                   help="device of every engine child (cuda, cuda:N "
                        "or cpu); a child that cannot start there "
                        "fails the run")
    p.add_argument("--model-dir", default=None,
                   help="model directory whose config.json every "
                        "engine serves with --random-weights (default: "
                        "an empty directory, the tiny test model, whose "
                        "head_dim 16 only the CPU serves)")
    p.add_argument("--kv-block", type=int, default=16,
                   help="paged-KV block size for the engines (0 = "
                        "dense; disables the conservation invariant); "
                        "on a CUDA device a multiple of 32 (the paged "
                        "kernel's tile), else refused before any child "
                        "starts")
    p.add_argument("--kv-blocks", type=int, default=40,
                   help="paged-KV pool size (small = pool pressure)")
    p.add_argument("--max-slots", type=int, default=2)
    p.add_argument("--prefix-host-mb", type=int, default=4,
                   help="host-DRAM prefix-cache tier budget (MB) on "
                        "every engine (0 disables); the conservation "
                        "invariant then covers both tiers and kills "
                        "exercise the recompute fallback")
    p.add_argument("--spec-tokens", type=int, default=0,
                   help="speculative draft tokens on decode/unified "
                        "engines (greedy stays byte-identical)")
    p.add_argument("--pd-local-fallback", action="store_true",
                   help="decode engines compute prefill locally when "
                        "the whole prefill pool is down")
    p.add_argument("--drain-grace", type=float, default=4.0)
    p.add_argument("--journal-drain-timeout", type=float, default=90.0,
                   help="seconds to wait after recovery for resumed "
                        "requests to tombstone their journal entries")
    p.add_argument("--base-dir", default=None,
                   help="scratch directory for logs/journals "
                        "(default: a fresh temp dir)")
    p.add_argument("--keep-logs", action="store_true",
                   help="do not delete the scratch directory")
    p.add_argument("--force-violation", action="store_true",
                   help="append a synthetic violation to every "
                        "episode, exercising the replay bundle "
                        "(flight dumps + merged trace) end to end")
    p.add_argument("--noisy-neighbor", action="store_true",
                   help="noisy-neighbor episodes: a batch-class "
                        "flood of --flood-factor x slot capacity "
                        "plus steady interactive traffic and one "
                        "mid-episode SIGKILL, checked against the "
                        "multi-tenant isolation invariants (no "
                        "admitted class starves, weighted shares "
                        "hold, interactive never shed)")
    p.add_argument("--flood-factor", type=int, default=5,
                   help="noisy-neighbor flood size as a multiple of "
                        "the topology's concurrent slot capacity")
    p.add_argument("--router-loss", action="store_true",
                   help="router-loss episodes (requires --routers "
                        ">= 2): arm a keyed router_forward fault on "
                        "one victim router, snapshot its gossip "
                        "state, SIGKILL it mid-replay, and check the "
                        "fleet invariants (exactly one outcome per "
                        "request, survivors adopt the victim's "
                        "breaker observations within one "
                        "anti-entropy round)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--serve-child":
        return _serve_child(argv[1:])
    args = build_parser().parse_args(argv)
    if args.schedule:
        build_parser().error(SCHEDULE_NOT_PORTED)
    topo = Topology(prefill=args.prefill, decode=args.decode,
                    unified=args.unified, router=not args.no_router,
                    routers=args.routers,
                    kv_block=args.kv_block, kv_blocks=args.kv_blocks,
                    max_slots=args.max_slots,
                    prefix_host_mb=args.prefix_host_mb,
                    spec_tokens=args.spec_tokens,
                    pd_local_fallback=args.pd_local_fallback,
                    drain_grace=args.drain_grace)
    if topo.engine_count() == 0:
        build_parser().error("topology has no serving engines")
    if topo.decode and not topo.prefill:
        build_parser().error("--decode engines need a --prefill pool "
                             "(or use --unified engines)")
    if args.router_loss and (args.no_router or topo.routers < 2):
        build_parser().error("--router-loss needs --routers >= 2 "
                             "(a victim plus survivors)")
    if args.router_loss and args.noisy_neighbor:
        build_parser().error("--router-loss and --noisy-neighbor are "
                             "separate episode kinds")
    if args.base_dir:
        base = pathlib.Path(args.base_dir)
        cleanup = False
    else:
        import tempfile
        base = pathlib.Path(tempfile.mkdtemp(prefix="ome-chaos-"))
        cleanup = not args.keep_logs
    episodes = ([args.episode] if args.episode is not None
                else list(range(args.episodes)))
    workload = None
    spread = args.spread
    if args.trace:
        workload = requests_from_trace(pathlib.Path(args.trace))
        # kill/drain events must land inside the replayed traffic
        spread = max(spread, max(r.delay for r in workload))
    try:
        rc = run_soak(args.seed, episodes, topo, base,
                      n_requests=args.requests, spread=spread,
                      keep_logs=args.keep_logs,
                      journal_drain_timeout=args.journal_drain_timeout,
                      force_violation=args.force_violation,
                      workload=workload,
                      kind=("router_loss" if args.router_loss
                            else "noisy" if args.noisy_neighbor
                            else "mixed"),
                      flood_factor=args.flood_factor,
                      device=args.device, model_dir=args.model_dir)
    except ChaosError as e:
        print(f"[chaos] refused: {e}", flush=True)
        rc = 2
    finally:
        if cleanup:
            import shutil
            shutil.rmtree(base, ignore_errors=True)
        else:
            print(f"[chaos] logs kept under {base}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
