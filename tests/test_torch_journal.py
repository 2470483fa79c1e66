"""Durable requests in the port: the request journal and restart resume.

Ported from tests/test_journal.py, against the port's journal
(`ome_tpu_torch/engine/journal.py`) and scheduler:

* WAL mechanics: admit + progress + tombstone records survive a reopen;
  a resumable finish leaves the entry live, a normal finish tombstones
  it; progress records are incremental; a torn tail is repaired on open;
  mid-file garbage is skipped; compaction rewrites atomically; the
  fsync policies; injected I/O faults degrade the journal, never a
  request;
* kill and resume through the scheduler over a position-dependent fake
  engine: a greedy stream interrupted by a fatal engine fault resumes
  byte-identical in a fresh scheduler; deadlines are honored across the
  restart; a spent budget finishes `length`; a replay fault fails open;
  masked requests are not journaled;
* the real engine (fp32, bridged from the JAX init): resume composes
  with spec decoding and paged-KV pool pressure, every stream equal to
  the JAX greedy reference; and the port and the JAX engine, each killed
  and resumed the same way, give the same resumed streams;
* the journal's bytes: a journal the port writes is replayed by
  `ome_tpu.engine.journal.RequestJournal` to the same entries, and the
  other way round;
* the serve flags, the admit with the scheduler lock released, the
  raced drain's tombstone, and `serve --journal` end to end on the CPU
  (the `/debug/state` journal block, a kill, a new server over the same
  directory resuming the stream).
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu import faults as jfaults
from ome_tpu.engine import journal as jjournal
from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.scheduler import Request as JaxRequest
from ome_tpu.engine.scheduler import Scheduler as JaxScheduler
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch import faults
from ome_tpu_torch.engine import serve
from ome_tpu_torch.engine.core import InferenceEngine
from ome_tpu_torch.engine.journal import (FILENAME, FSYNC_POLICIES,
                                          RequestJournal)
from ome_tpu_torch.engine.scheduler import (Request, Scheduler,
                                            SchedulerDraining)
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params
from ome_tpu_torch.telemetry import Registry

sys.path.insert(0, os.path.dirname(__file__))
from test_pipeline import reference_greedy  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Cfg:
    vocab_size = 4096


class SeqEngine:
    """Deterministic position-dependent fake: the token at sequence
    position L is always 100+L, so a resumed fold (prompt + generated
    prefix re-prefilled) reproduces the uninterrupted stream exactly."""

    max_seq = 4096
    cfg = _Cfg()

    def __init__(self, max_slots=1):
        self.max_slots = max_slots
        self._pos = np.zeros(max_slots, np.int64)

    def new_state(self):
        return "s"

    def prefill(self, ids, t, k, p, **kw):
        return 100 + len(ids), "kv", len(ids), 16

    def insert(self, state, kv, slot, true_len, token, bucket):
        self._pos[slot] = true_len + 1
        return state

    def decode(self, state, t, k, p, **kw):
        toks = (100 + self._pos).astype(np.int32)
        self._pos += 1
        return state, toks

    def free_slot(self, slot):
        pass


def _journal_lines(directory):
    with open(os.path.join(directory, FILENAME), encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _raw_path(directory):
    return os.path.join(directory, FILENAME)


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.005)


# -- WAL mechanics -------------------------------------------------------------


class TestJournalWAL:
    def test_roundtrip_resumable_vs_tombstone(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        a = Request(prompt_ids=[1, 2, 3], max_new_tokens=8,
                    temperature=0.5, top_k=4, top_p=0.9,
                    stop_ids=[42], adapter="lora-x")
        b = Request(prompt_ids=[9], max_new_tokens=4)
        j.admit(a)
        j.admit(b)
        a.output_ids.extend([7, 8])
        b.output_ids.append(5)
        j.poll()
        a.finish_reason = "shutdown"
        j.finish(a, resumable=True)       # entry stays live
        b.finish_reason = "stop"
        j.finish(b)                       # tombstoned
        j.close()

        j2 = RequestJournal(d)
        entries = j2.replay()
        assert len(entries) == 1
        e = entries[0]
        assert e.jid == a.journal_id
        assert e.prompt_ids == [1, 2, 3]
        assert e.output_ids == [7, 8]
        assert e.max_new_tokens == 8 and e.temperature == 0.5
        assert e.top_k == 4 and e.top_p == 0.9
        assert e.stop_ids == [42] and e.adapter == "lora-x"
        assert j2._seq > max(a.journal_id, b.journal_id)
        j2.close()

    def test_progress_records_are_incremental(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        r = Request(prompt_ids=[1], max_new_tokens=10)
        j.admit(r)
        r.output_ids.extend([11, 12])
        j.poll()
        r.output_ids.append(13)
        j.poll()
        j.poll()  # nothing new: no empty prog record
        j.close()
        progs = [rec for rec in _journal_lines(d) if rec["t"] == "prog"]
        assert [p["toks"] for p in progs] == [[11, 12], [13]]

    def test_torn_tail_repaired_on_open(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        r = Request(prompt_ids=[4, 5], max_new_tokens=6)
        j.admit(r)
        r.output_ids.extend([20, 21])
        j.poll()
        j.close()
        with open(_raw_path(d), "a", encoding="utf-8") as f:
            f.write('{"t":"prog","jid":0,"to')
        torn_size = os.path.getsize(_raw_path(d))

        j2 = RequestJournal(d)
        entries = j2.replay()
        assert len(entries) == 1
        assert entries[0].output_ids == [20, 21]
        assert os.path.getsize(_raw_path(d)) < torn_size
        j2.admit(Request(prompt_ids=[6], max_new_tokens=2))
        j2.close()
        assert all(isinstance(rec, dict) for rec in _journal_lines(d))

    def test_mid_file_garbage_skipped(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        a = Request(prompt_ids=[1], max_new_tokens=4)
        j.admit(a)
        j.close()
        with open(_raw_path(d), "a", encoding="utf-8") as f:
            f.write("NOT JSON AT ALL\n")
            f.write(json.dumps({"t": "prog", "jid": a.journal_id,
                                "toks": [33]}) + "\n")
        j2 = RequestJournal(d)
        entries = j2.replay()
        assert len(entries) == 1
        assert entries[0].output_ids == [33]
        j2.close()

    def test_compaction_rewrites_and_preserves_state(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off", compact_bytes=600)
        done = Request(prompt_ids=[1], max_new_tokens=2)
        live = Request(prompt_ids=[2], max_new_tokens=500)
        j.admit(done)
        j.admit(live)
        done.finish_reason = "length"
        j.finish(done)
        for i in range(40):
            live.output_ids.append(1000 + i)
            j.poll()
        assert j.compactions >= 1
        recs = _journal_lines(d)
        assert done.journal_id not in {r["jid"] for r in recs}
        assert os.path.getsize(_raw_path(d)) <= 600 + 200
        j.close()
        j2 = RequestJournal(d)
        entries = j2.replay()
        assert len(entries) == 1
        assert entries[0].output_ids == [1000 + i for i in range(40)]
        j2.close()

    def test_fsync_policy(self, tmp_path, monkeypatch):
        calls = []
        monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd))

        j = RequestJournal(str(tmp_path / "always"), fsync="always")
        j.admit(Request(prompt_ids=[1], max_new_tokens=2))
        assert len(calls) == 1            # per append
        j.close()

        calls.clear()
        j = RequestJournal(str(tmp_path / "batch"), fsync="batch",
                           fsync_interval=0.0)
        j.admit(Request(prompt_ids=[1], max_new_tokens=2))
        assert not calls                  # an append alone does not sync
        j.poll()
        assert len(calls) == 1            # interval elapsed: sync
        j.close()

        calls.clear()
        j = RequestJournal(str(tmp_path / "off"), fsync="off")
        r = Request(prompt_ids=[1], max_new_tokens=2)
        j.admit(r)
        j.poll()
        assert not calls                  # off: poll never syncs
        r.finish_reason = "shutdown"
        j.finish(r, resumable=True)
        assert len(calls) == 1            # an eviction syncs regardless
        j.close()

    def test_bad_fsync_policy_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            RequestJournal(str(tmp_path), fsync="sometimes")
        assert "sometimes" not in FSYNC_POLICIES

    def test_append_fault_degrades_not_raises(self, tmp_path):
        faults.install("journal_append.raise@1")
        j = RequestJournal(str(tmp_path), fsync="off")
        reg = Registry()
        j.bind(reg)
        j.admit(Request(prompt_ids=[1], max_new_tokens=2))
        assert j.degraded and j.errors == 1
        assert reg.get("ome_engine_journal_errors_total") == 1
        j.admit(Request(prompt_ids=[2], max_new_tokens=2))
        assert j.appends >= 1
        j.close()

    def test_fsync_fault_degrades(self, tmp_path):
        faults.install("journal_fsync.raise@1")
        j = RequestJournal(str(tmp_path), fsync="always")
        j.admit(Request(prompt_ids=[1], max_new_tokens=2))
        assert j.degraded and j.errors == 1
        j.close()


# -- the same bytes both ways --------------------------------------------------


def _write_script(journal_cls, request_cls, d):
    """One script of admits, progress, a resumable eviction, a
    tombstone and a deadline, through either package's journal."""
    j = journal_cls(d, fsync="off",
                    provenance={"mode": "pd-decode",
                                "peers": ["http://127.0.0.1:9"]})
    a = request_cls(prompt_ids=[1, 2, 3], max_new_tokens=8,
                    temperature=0.5, top_k=4, top_p=0.9, stop_ids=[42],
                    priority="batch",
                    deadline=time.monotonic() + 60.0)
    b = request_cls(prompt_ids=[9], max_new_tokens=4)
    c = request_cls(prompt_ids=[5, 5], max_new_tokens=6)
    for r in (a, b, c):
        j.admit(r)
    a.output_ids.extend([7, 8])
    c.output_ids.append(11)
    j.poll()
    a.output_ids.append(9)
    a.finish_reason = "shutdown"
    j.finish(a, resumable=True)
    b.finish_reason = "stop"
    j.finish(b)
    j.close()


def _entries(journal_cls, d):
    j = journal_cls(d)
    out = [dict(vars(e), deadline_epoch=None) for e in j.replay()]
    deadlines = [e.deadline_epoch for e in j.replay()]
    j.close()
    return out, deadlines


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_read_by_the_other_package(tmp_path, writer):
    """A journal written by one package replays to the same entries in
    both readers (deadlines to the same epoch), record for record."""
    d = str(tmp_path)
    if writer == "port":
        _write_script(RequestJournal, Request, d)
    else:
        _write_script(jjournal.RequestJournal, JaxRequest, d)
    port, pdl = _entries(RequestJournal, d)
    ref, jdl = _entries(jjournal.RequestJournal, d)
    assert port == ref and pdl == jdl
    assert [e["jid"] for e in port] == [0, 2]
    assert port[0]["output_ids"] == [7, 8, 9]
    assert port[0]["cls"] == "batch" and pdl[0] is not None
    assert port[0]["pd"] == {"mode": "pd-decode",
                             "peers": ["http://127.0.0.1:9"]}


def test_journal_bytes_equal_the_reference(tmp_path):
    """The same script writes the same lines in both packages (the
    deadline, a wall-clock reading, aside)."""
    lines = {}
    for name, jcls, rcls in (("port", RequestJournal, Request),
                             ("jax", jjournal.RequestJournal, JaxRequest)):
        d = str(tmp_path / name)
        _write_script(jcls, rcls, d)
        recs = _journal_lines(d)
        for rec in recs:
            rec.pop("deadline", None)
            rec.pop("trace", None)
        lines[name] = recs
    assert lines["port"] == lines["jax"]


# -- scheduler integration: kill and resume -------------------------------------


class TestRestartResume:
    def test_kill_and_resume_byte_identical(self, tmp_path):
        d = str(tmp_path)
        ref_sched = Scheduler(SeqEngine(), restart_backoff=0.01)
        ref_sched.start()
        ref = ref_sched.submit(Request(prompt_ids=[1, 2, 3],
                                       max_new_tokens=8))
        assert ref.done.wait(15) and ref.finish_reason == "length"
        ref_sched.stop()
        assert len(ref.output_ids) == 8

        faults.install("engine_step.raise@4")
        j = RequestJournal(d, fsync="batch", fsync_interval=0.0)
        sched = Scheduler(SeqEngine(), max_restarts=0, journal=j)
        sched.start()
        req = sched.submit(Request(prompt_ids=[1, 2, 3], max_new_tokens=8))
        assert req.done.wait(15)
        assert req.finish_reason == "engine_fault"
        _wait(lambda: sched.status == "dead")
        got_before = list(req.output_ids)
        assert 0 < len(got_before) < 8
        sched.stop()
        j.close()
        faults.reset()

        j2 = RequestJournal(d)
        sched2 = Scheduler(SeqEngine(), journal=j2)
        assert sched2.resume_from_journal() == 1
        assert j2.replayed == 1
        resumed = sched2.pending.queue[0]
        assert resumed.prompt_ids == [1, 2, 3] + got_before
        assert resumed.output_ids == got_before
        sched2.start()
        assert resumed.done.wait(15)
        assert resumed.finish_reason == "length"
        sched2.stop()
        assert resumed.output_ids == ref.output_ids
        j2.close()
        j3 = RequestJournal(d)
        assert j3.replay() == []
        j3.close()

    def test_deadline_honored_across_restart(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        live = Request(prompt_ids=[1], max_new_tokens=4,
                       deadline=time.monotonic() + 60.0)
        gone = Request(prompt_ids=[2], max_new_tokens=4,
                       deadline=time.monotonic() + 0.01)
        j.admit(live)
        j.admit(gone)
        for r in (live, gone):
            r.finish_reason = "shutdown"
            j.finish(r, resumable=True)
        j.close()
        time.sleep(0.05)

        j2 = RequestJournal(d)
        by_jid = {e.jid: e for e in j2.replay()}
        back = by_jid[live.journal_id].deadline_epoch - time.time()
        assert 55.0 < back < 60.5
        sched = Scheduler(SeqEngine(), journal=j2)
        sched.resume_from_journal()
        assert sched.stats["timeouts_total"] == 1
        sched.start()
        _wait(lambda: not j2.replay())  # the live one's tombstone
        sched.stop()
        j2.close()
        j3 = RequestJournal(d)
        assert j3.replay() == []
        j3.close()

    def test_budget_already_spent_finishes_length(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        r = Request(prompt_ids=[1], max_new_tokens=3)
        j.admit(r)
        r.output_ids.extend([5, 6, 7])
        r.finish_reason = "shutdown"
        j.finish(r, resumable=True)
        j.close()
        j2 = RequestJournal(d)
        sched = Scheduler(SeqEngine(), journal=j2)
        assert sched.resume_from_journal() == 0
        assert sched.pending.qsize() == 0
        j2.close()
        j3 = RequestJournal(d)
        assert j3.replay() == []
        j3.close()

    def test_replay_fault_fails_open(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        r = Request(prompt_ids=[1], max_new_tokens=4)
        j.admit(r)
        r.finish_reason = "shutdown"
        j.finish(r, resumable=True)
        j.close()
        faults.install("journal_replay.raise@1")
        j2 = RequestJournal(d)
        sched = Scheduler(SeqEngine(), journal=j2)
        assert sched.resume_from_journal() == 0
        assert j2.errors == 1
        j2.close()

    def test_masked_requests_not_journaled(self, tmp_path):
        j = RequestJournal(str(tmp_path), fsync="off")
        sched = Scheduler(SeqEngine(), journal=j)
        masked = sched.submit(Request(prompt_ids=[1], max_new_tokens=4,
                                      masker=object()))
        plain = sched.submit(Request(prompt_ids=[2], max_new_tokens=4))
        assert masked.journal_id is None
        assert plain.journal_id is not None
        j.close()

    def test_debug_state_carries_the_journal(self, tmp_path):
        j = RequestJournal(str(tmp_path), fsync="off")
        sched = Scheduler(SeqEngine(), journal=j)
        sched.submit(Request(prompt_ids=[2], max_new_tokens=4))
        block = sched.debug_state()["journal"]
        assert block["path"] == j.path and block["appends"] == 1
        assert block["errors"] == 0 and block["degraded"] is False
        assert block["bytes"] == os.path.getsize(j.path)
        assert Scheduler(SeqEngine()).debug_state()["journal"] is None
        j.close()


# -- the real engine -----------------------------------------------------------


MAX_SEQ = 64


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    return jcfg, jp, tcfg, tp


def test_spec_and_paged_kv_resume_byte_identical(tmp_path, weights):
    """Kill-and-resume on the port's engine with spec_tokens > 0 and an
    undersized paged pool (5 blocks of 16 rows, 4 slots): every
    journaled stream completes equal to the JAX greedy reference."""
    jcfg, jp, tcfg, tp = weights
    engine = InferenceEngine(tp, tcfg, max_slots=4, max_seq=MAX_SEQ,
                             prefill_buckets=[32], kv_block=16,
                             kv_blocks=5, device="cpu")
    d = str(tmp_path)
    plans = [([1, 7, 42, 99, 5, 1, 7, 42, 99], 16),
             ([3, 4, 3, 4, 3], 14),
             ([2, 3, 4, 5, 6, 7], 12)]
    want = {tuple(p): reference_greedy(jp, jcfg, p, n) for p, n in plans}

    faults.install("engine_step.raise@5")
    j = RequestJournal(d, fsync="batch", fsync_interval=0.0)
    sched = Scheduler(engine, max_restarts=0, pipeline_depth=1,
                      spec_tokens=3, journal=j)
    reqs = [sched.submit(Request(prompt_ids=p, max_new_tokens=n))
            for p, n in plans]
    sched.start()
    for r in reqs:
        assert r.done.wait(60), r.id
    _wait(lambda: sched.status == "dead", timeout=30)
    sched.stop()
    j.close()
    faults.reset()
    assert [r for r in reqs if r.finish_reason == "engine_fault"]

    j2 = RequestJournal(d)
    sched2 = Scheduler(engine, pipeline_depth=1, spec_tokens=3,
                       journal=j2)
    entries = {e.jid: e for e in j2.replay()}
    n = sched2.resume_from_journal()
    assert n == len(entries) > 0
    resumed = list(sched2.pending.queue)
    sched2.start()
    try:
        for r in resumed:
            assert r.done.wait(120), r.id
            assert r.finish_reason == "length"
            e = entries[r.journal_id]
            assert list(r.output_ids) == want[tuple(e.prompt_ids)]
            assert r.output_ids[:len(e.output_ids)] == e.output_ids
    finally:
        sched2.stop()
        j2.close()
    assert engine.kv_conservation()[0]


def _kill_and_resume(make_engine, journal_cls, scheduler_cls, request_cls,
                     fault_mod, d, prompt, n):
    """Journal a greedy request, kill the scheduler with an engine fault
    at its 4th step (no restart budget), resume it in a fresh scheduler
    over the same directory; returns (tokens before, the whole stream,
    the journal's records)."""
    fault_mod.install("engine_step.raise@4")
    j = journal_cls(d, fsync="always")
    sched = scheduler_cls(make_engine(), max_restarts=0, journal=j)
    sched.start()
    req = sched.submit(request_cls(prompt_ids=prompt, max_new_tokens=n))
    assert req.done.wait(60) and req.finish_reason == "engine_fault"
    _wait(lambda: sched.status == "dead")
    before = list(req.output_ids)
    sched.stop()
    j.close()
    fault_mod.reset()
    j2 = journal_cls(d)
    sched2 = scheduler_cls(make_engine(), journal=j2)
    assert sched2.resume_from_journal() == 1
    resumed = sched2.pending.queue[0]
    sched2.start()
    assert resumed.done.wait(60) and resumed.finish_reason == "length"
    sched2.stop()
    j2.close()
    return before, list(resumed.output_ids), _journal_lines(d)


def test_resumed_stream_equals_the_jax_engines(tmp_path, weights):
    """The port's fp32 engine and the JAX engine over the same weights,
    each killed at the same step and resumed from its own journal, give
    the same whole stream — the uninterrupted greedy reference — and
    journal the same tokens."""
    jcfg, jp, tcfg, tp = weights
    prompt, n = [5, 9, 2, 33, 17, 8], 12
    port = _kill_and_resume(
        lambda: InferenceEngine(tp, tcfg, max_slots=2, max_seq=MAX_SEQ,
                                device="cpu"),
        RequestJournal, Scheduler, Request, faults,
        str(tmp_path / "port"), prompt, n)
    ref = _kill_and_resume(
        lambda: JaxEngine(jp, jcfg, max_slots=2, max_seq=MAX_SEQ),
        jjournal.RequestJournal, JaxScheduler, JaxRequest, jfaults,
        str(tmp_path / "jax"), prompt, n)
    assert 0 < len(port[0]) < n
    assert port[1] == ref[1] == reference_greedy(jp, jcfg, prompt, n)
    toks = [[r.get("toks") for r in recs if r["t"] == "prog"]
            for recs in (port[2], ref[2])]
    assert sum(toks[0], []) == sum(toks[1], []) == port[1]


# -- serve ---------------------------------------------------------------------


class TestServeFlags:
    def test_journal_flags_parse(self):
        args = serve.build_parser().parse_args(
            ["--model-dir", "/m", "--random-weights",
             "--journal", "/var/lib/ome/journal",
             "--journal-fsync", "always", "--journal-compact-mb", "8",
             "--drain-grace", "5.5"])
        assert args.journal == "/var/lib/ome/journal"
        assert args.journal_fsync == "always"
        assert args.journal_compact_mb == 8
        assert args.drain_grace == 5.5

    def test_defaults(self):
        args = serve.build_parser().parse_args(
            ["--model-dir", "/m", "--random-weights"])
        assert args.journal is None
        assert args.journal_fsync == "batch"
        assert args.journal_compact_mb == 4
        assert args.drain_grace == 30.0

    def test_bad_fsync_choice_rejected(self):
        with pytest.raises(SystemExit):
            serve.build_parser().parse_args(
                ["--model-dir", "/m", "--random-weights",
                 "--journal-fsync", "sometimes"])

    def test_prefill_node_refuses_a_journal(self, tmp_path):
        args = serve.build_parser().parse_args(
            ["--model-dir", "/m", "--random-weights", "--journal",
             str(tmp_path), "--disaggregation-mode", "prefill"])
        with pytest.raises(SystemExit, match="--journal"):
            serve.check_slice(args)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_journal_kill_and_resume(tmp_path):
    """`serve --journal` on the CPU: the admit is journaled and
    /debug/state shows the block; a fault kills the scheduler
    mid-decode; a second server over the same directory resumes the
    request before serving, and its whole stream equals an uninterrupted
    server's answer to the same prompt."""
    model = tmp_path / "model"
    model.mkdir()
    d = str(tmp_path / "journal")
    base = ["--model-dir", str(model), "--random-weights", "--device",
            "cpu", "--dtype", "float32", "--max-slots", "2", "--max-seq",
            "64", "--port", "0", "--host", "127.0.0.1",
            "--debug-endpoints", "--prefix-cache-mb", "0"]
    body = {"prompt": [5, 6, 7, 8], "max_tokens": 10, "temperature": 0.0}

    def recording(sched):
        seen = []
        submit = sched.submit
        sched.submit = lambda r: (seen.append(r), submit(r))[1]
        return seen
    server, sched, _ = serve.build_server(base)
    try:
        seen = recording(sched)
        _post(f"http://127.0.0.1:{server.port}", body)
        want = list(seen[0].output_ids)
    finally:
        server.stop()
    assert len(want) == 10

    server, sched, _ = serve.build_server(
        base + ["--journal", d, "--journal-fsync", "always",
                "--max-restarts", "0", "--faults", "engine_step.raise@4"])
    url = f"http://127.0.0.1:{server.port}"
    try:
        seen = recording(sched)
        try:
            _post(url, body)   # answered with what came before the fault
        except urllib.error.HTTPError:
            pass
        _wait(lambda: sched.status == "dead")
        assert seen[0].finish_reason == "engine_fault"
        before = list(seen[0].output_ids)
        assert 0 < len(before) < 10
        state = _get(url + "/debug/state")
        assert state["journal"]["path"] == os.path.join(d, FILENAME)
        assert state["journal"]["appends"] >= 2
    finally:
        server.stop()
        sched.journal.close()
        faults.reset()

    server, sched, _ = serve.build_server(base + ["--journal", d])
    try:
        assert sched.journal.replayed == 1
        # finished when its tombstone is written (drain_idle can read
        # idle while the admission thread holds the request it took)
        _wait(lambda: not sched.journal.replay(), timeout=60)
        assert _get(f"http://127.0.0.1:{server.port}/debug/state")[
            "journal"]["replayed"] == 1
    finally:
        server.stop()
        sched.journal.close()
    recs = _journal_lines(d)
    admit = [r for r in recs if r["t"] == "admit"]
    toks = sum((r["toks"] for r in recs if r["t"] == "prog"), [])
    assert len(admit) == 1 and admit[0]["prompt"] == body["prompt"]
    assert recs[-1] == {"t": "fin", "jid": admit[0]["jid"],
                        "reason": "length"}
    assert toks[:len(before)] == before and toks == want


# -- admit lock discipline -----------------------------------------------------


class TestAdmitLocking:
    def test_admit_runs_with_scheduler_lock_released(self, tmp_path):
        j = RequestJournal(str(tmp_path), fsync="off")
        sched = Scheduler(SeqEngine(), journal=j)
        lock_free = []
        orig = j.admit

        def spy(req):
            ok = sched._lock.acquire(blocking=False)
            if ok:
                sched._lock.release()
            lock_free.append(ok)
            orig(req)

        j.admit = spy
        req = sched.submit(Request(prompt_ids=[1, 2]))
        assert lock_free == [True]
        assert req.journal_id is not None
        assert sched.pending.qsize() == 1
        j.close()

    def test_raced_drain_tombstones_the_admit(self, tmp_path):
        d = str(tmp_path)
        j = RequestJournal(d, fsync="off")
        sched = Scheduler(SeqEngine(), journal=j)
        orig = j.admit

        def race(req):
            orig(req)
            sched._draining = True  # SIGTERM lands mid journal write

        j.admit = race
        with pytest.raises(SchedulerDraining):
            sched.submit(Request(prompt_ids=[1, 2]))
        assert sched.pending.qsize() == 0
        j.close()
        assert [rec["t"] for rec in _journal_lines(d)] == ["admit", "fin"]
        j2 = RequestJournal(d)
        assert j2.replay() == []
        j2.close()
