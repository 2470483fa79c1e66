"""The port's per-class pending queues (`engine/scheduler.py::ClassQueues`,
start-time fair queueing) against the reference's deficit round-robin
(`ome_tpu/engine/scheduler.py`): the same FIFO orders where the two
must agree (one class; priorities off), the same weighted token shares
under backlog, no starvation, the same bounds and snapshots; and the
one place they part on purpose: an interactive request that arrives
while batch holds the rotation is next in line, where the reference's
round-robin serves up to 64 more tokens of batch first. Also the
scheduler's two other departures: the queue-wait estimate counts free
slots, and a queued higher class preempts a lower class that holds
more than its share of the slots: through the port's dense, paged,
paged speculative and K-step engines, every stream still equals the
JAX greedy continuation of its prompt, and under a sustained
interactive backlog batch keeps its weighted token share.
"""

import collections
import queue

import numpy as np
import pytest

from ome_tpu.engine.scheduler import ClassQueues as RefQueues
from ome_tpu.engine.scheduler import Request as RefRequest
from ome_tpu_torch.engine.scheduler import ClassQueues, Request
from ome_tpu_torch.priority import DEFAULT_CLASS_WEIGHTS, PRIORITY_CLASSES


def _req(cls, cost=4, tag=0, make=Request):
    return make(prompt_ids=[1, tag], max_new_tokens=cost, priority=cls)


def _drain(q, n):
    return [q.get_nowait() for _ in range(n)]


@pytest.mark.parametrize("enabled,classes", [
    (True, ["standard"]), (False, ["batch", "interactive", "standard"])])
def test_fifo_orders_match_the_reference(enabled, classes):
    spec = [(classes[i % len(classes)], 1 + i % 7) for i in range(24)]
    port, ref = ClassQueues(0, enabled=enabled), RefQueues(
        0, enabled=enabled)
    for i, (cls, cost) in enumerate(spec):
        port.put_nowait(_req(cls, cost, i))
        ref.put_nowait(_req(cls, cost, i, make=RefRequest))
    got = [(r.priority, r.prompt_ids[1]) for r in _drain(port, 24)]
    want = [(r.priority, r.prompt_ids[1]) for r in _drain(ref, 24)]
    assert got == want == [(c, i) for i, (c, _) in enumerate(spec)]


@pytest.mark.parametrize("make_queue", [ClassQueues, RefQueues],
                         ids=["port", "reference"])
def test_weighted_cost_shares(make_queue):
    """While every class has backlog, each class's served token cost
    tracks its weight share (8 : 4 : 1), in both packages."""
    rng = np.random.default_rng(42)
    make = Request if make_queue is ClassQueues else RefRequest
    q = make_queue(0)
    for cls in PRIORITY_CLASSES:
        for i in range(80):
            q.put_nowait(_req(cls, int(rng.integers(1, 33)), i, make))
    served = collections.Counter()
    while all(q.qsize(c) > 0 for c in PRIORITY_CLASSES):
        r = q.get_nowait()
        served[r.priority] += r.max_new_tokens
    total = sum(served.values())
    wsum = sum(DEFAULT_CLASS_WEIGHTS.values())
    assert total > 500
    for cls in PRIORITY_CLASSES:
        want = DEFAULT_CLASS_WEIGHTS[cls] / wsum
        assert abs(served[cls] / total - want) < 0.1, (cls, served)


def test_no_class_starves():
    q = ClassQueues(0)
    for i in range(40):
        q.put_nowait(_req("interactive", 32, i))
    for i in range(5):
        q.put_nowait(_req("batch", 8, i))
    assert "batch" in [r.priority for r in _drain(q, 40)]


def test_idle_class_forfeits_credit():
    """A class that sat idle starts at the virtual time, not earlier:
    after batch ran alone for 20 requests, interactive arrives and the
    two contend at about 8 : 1 from that point (had interactive banked
    its idle time, its 30 requests would all go before the next
    batch)."""
    q = ClassQueues(0)
    for i in range(30):
        q.put_nowait(_req("batch", 8, i))
    _drain(q, 20)
    for i in range(30):
        q.put_nowait(_req("interactive", 8, i))
    first = [r.priority for r in _drain(q, 18)]
    assert first.count("batch") in (1, 2), first


def test_arrival_behind_a_batch_rotation():
    """Batch has filled the queue and been served once; an interactive
    request that arrives now is the port's next pick. The reference's
    round-robin stays on batch while its 64 tokens of credit last
    (53 after the first pick: four more batch requests first)."""
    port, ref = ClassQueues(0), RefQueues(0)
    for i in range(8):
        port.put_nowait(_req("batch", 11, i))
        ref.put_nowait(_req("batch", 11, i, make=RefRequest))
    port.get_nowait()
    ref.get_nowait()
    port.put_nowait(_req("interactive", 8, 99))
    ref.put_nowait(_req("interactive", 8, 99, make=RefRequest))
    assert port.get_nowait().priority == "interactive"
    ref_order = [r.priority for r in _drain(ref, 6)]
    assert ref_order.index("interactive") == 4


def test_bounds_snapshot_and_timeouts():
    q = ClassQueues(maxsize=2)
    q.put_nowait(_req("batch", tag=0))
    q.put_nowait(_req("batch", tag=1))
    with pytest.raises(queue.Full):
        q.put_nowait(_req("batch", tag=2))
    q.put_nowait(_req("interactive", tag=3))
    assert [r.priority for r in q.queue] == [
        "interactive", "batch", "batch"]
    assert q.qsize() == 3 and q.qsize("batch") == 2
    assert q.depths() == {"interactive": 1, "standard": 0, "batch": 2}
    _drain(q, 3)
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)
    with pytest.raises(queue.Empty):
        q.get_nowait()


class _IdleEngine:
    """Engine double for admission only: the scheduler is never
    started, so nothing is prefilled or decoded."""

    max_seq = 1024

    def __init__(self, max_slots):
        self.max_slots = max_slots

    def new_state(self):
        return "s"


@pytest.mark.parametrize("occupied,queued,shed", [
    (0, 0, False), (3, 0, False), (4, 0, True), (0, 4, True),
    (2, 2, True), (2, 1, False)])
def test_wait_estimate_counts_free_slots(occupied, queued, shed):
    """A request that finds a slot free waits for nothing: with a slow
    step-time EWMA (one request = 120 steps x 0.3 s = 36 s, above the
    30 s cap) an idle replica still admits it, where the reference's
    estimate, one whole wave for any queued request, sheds it (429).
    A request that must wait for a slot is shed as before."""
    from ome_tpu_torch.engine.scheduler import Scheduler, SchedulerOverloaded
    sched = Scheduler(_IdleEngine(max_slots=4), max_queue_wait=30.0,
                      priority_scheduling=False)
    sched._ewma_step_s, sched._ewma_req_steps = 0.3, 120.0
    for i in range(occupied):
        sched.slots[i] = _req("standard", tag=i)
    for i in range(queued):
        sched.pending.put_nowait(_req("standard", tag=100 + i))
    req = _req("standard", cost=120, tag=999)
    if shed:
        with pytest.raises(SchedulerOverloaded):
            sched.submit(req)
    else:
        assert sched.submit(req) is req
        assert not req.done.is_set()
    want = None if not shed else 36.0 * -(-(queued + 1 - (4 - occupied))
                                           // 4)
    est = sched._queue_wait_estimate(queued + 1)
    assert est == (0.0 if not shed else want)


class _SlotEngine(_IdleEngine):
    def __init__(self, max_slots):
        super().__init__(max_slots)
        self.freed = []

    def free_slot(self, slot):
        self.freed.append(slot)


@pytest.mark.parametrize("running,queued,victim", [
    (("batch", "batch"), ("interactive",), 0),
    (("standard", "standard"), ("interactive",), 0),
    (("batch", "batch", "batch", "interactive"), ("interactive",), 0),
    (("standard", "batch"), ("standard",), None),
    (("batch", "standard"), ("interactive",), None),
    (("interactive", "standard"), ("interactive",), None),
    (("batch", "standard"), ("batch",), None),
    (("standard", "standard"), ("standard", "batch"), None),
    (("interactive", "interactive"), ("interactive",), None),
])
def test_a_queued_higher_class_takes_a_slot(running, queued, victim):
    """Every slot busy and a class queued above a running request's:
    if a lower class holds more slots than its weight share of them
    (rounded up, among the classes that hold or wait for slots), its
    running request with the least progress leaves its slot with its
    tokens folded into its prompt and goes back to its class queue,
    where the higher class is picked first. A lower class within its
    share keeps its slot (batch keeps one of two against interactive),
    and a queued class at or below every running one preempts
    nothing."""
    from ome_tpu_torch.engine.scheduler import Scheduler
    eng = _SlotEngine(max_slots=len(running))
    sched = Scheduler(eng, max_queue_wait=30.0)
    reqs = []
    for i, cls in enumerate(running):
        # later slots have made more progress since admission: between
        # two of one class, the lower slot is the victim
        r = _req(cls, cost=20, tag=i)
        r.output_ids = list(range(10, 10 + 3 + 2 * i))
        sched.slots[i] = r
        reqs.append(r)
    sched._base_out[:] = 0
    for i, cls in enumerate(queued):
        sched.pending.put_nowait(_req(cls, tag=100 + i))
    before = [list(r.prompt_ids) for r in reqs]
    sched._preempt_for_class()
    if victim is None:
        assert eng.freed == [] and sched.slots == reqs
        return
    r = reqs[victim]
    assert eng.freed == [victim] and sched.slots[victim] is None
    assert r.prompt_ids == before[victim] + r.output_ids
    assert sched.pending.qsize(sched._class_of(r)) == \
        queued.count(sched._class_of(r)) + 1
    assert sched.pending.get_nowait().priority == max(
        queued, key=lambda c: ("batch", "standard",
                               "interactive").index(c))


# -- class preemption through the port's engines ----------------------------

MAX_SEQ = 64
# (engine kwargs, scheduler kwargs): a dense cache, a paged pool, paged
# speculative decoding and K-step dispatch chunks
ENGINES = {
    "dense": ({}, {}),
    "paged": (dict(kv_block=16, kv_blocks=40), {}),
    "paged-spec": (dict(kv_block=16, kv_blocks=40), dict(spec_tokens=3)),
    "multi-step": ({}, dict(steps_per_dispatch=4)),
}


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp
    import torch
    from ome_tpu.models import llama as jllama
    from ome_tpu.models.config import tiny_test as jax_tiny
    from ome_tpu_torch.models.config import tiny_test
    from ome_tpu_torch.models.params import from_jax_params
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=MAX_SEQ)
    yield jcfg, jp, tcfg, tp
    torch.set_num_threads(n)


def _greedy_ref(tiny, cache, prompt, n):
    """The JAX greedy continuation of `prompt` served alone."""
    import sys
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_pipeline import reference_greedy
    key = (tuple(prompt), n)
    if key not in cache:
        cache[key] = reference_greedy(tiny[1], tiny[0], prompt, n)
    return cache[key]


def _sched(tiny, variant, slots=2):
    from ome_tpu_torch.engine.core import InferenceEngine
    from ome_tpu_torch.engine.scheduler import Scheduler
    ekw, skw = ENGINES[variant]
    eng = InferenceEngine(tiny[3], tiny[2], max_slots=slots,
                          max_seq=MAX_SEQ, prefill_buckets=[16, 32, 64],
                          device="cpu", **ekw)
    return eng, Scheduler(eng, pipeline_depth=1, **skw)


def _prompts(seed, n, repeat):
    rng = np.random.default_rng(seed)
    # repetitive prompts give the speculative drafter n-grams to propose
    return [[int(t) for t in rng.integers(3, 500, 4)] * repeat
            for _ in range(n)]


_REFS = {}


@pytest.mark.parametrize("variant", list(ENGINES))
def test_class_preemption_through_the_engines(tiny, variant):
    """Both slots decode batch requests when an interactive request
    arrives: at the next step one batch request (over its share of
    the slots) leaves its slot, the interactive request is admitted,
    and every stream, the preempted one included, equals the JAX
    greedy continuation of its prompt served alone."""
    eng, sched = _sched(tiny, variant)
    batch = [Request(prompt_ids=p, max_new_tokens=14, priority="batch")
             for p in _prompts(1, 3, 3)]
    inter = Request(prompt_ids=_prompts(2, 1, 2)[0], max_new_tokens=6,
                    priority="interactive")
    for r in batch:
        sched.submit(r)
    for _ in range(40):
        sched.step()
        if all(s is not None and len(s.output_ids) >= 3
               for s in sched.slots):
            break
    assert [s.priority for s in sched.slots] == ["batch", "batch"]
    sched.submit(inter)
    sched.step()
    assert inter in sched.slots
    assert sched.stats["preemptions_total"] == 1
    for _ in range(400):
        if all(r.done.is_set() for r in batch + [inter]):
            break
        sched.step()
    for r, p, n in [(r, r0, 14) for r, r0 in zip(batch, _prompts(1, 3, 3))] \
            + [(inter, inter.prompt_ids, 6)]:
        assert r.finish_reason == "length", r.id
        assert list(r.output_ids) == _greedy_ref(tiny, _REFS, p, n), r.id
    if ENGINES[variant][0]:
        assert eng.kv_conservation()[0]
    sched.stop()


@pytest.mark.parametrize("variant", list(ENGINES))
def test_sustained_backlog_keeps_the_lower_class_share(tiny, variant):
    """A sustained interactive backlog beside a batch backlog on two
    slots: batch keeps the slot it holds within its share, so no class
    preemption happens, and while both classes have queued demand
    batch decodes at least its weighted share (1 of 8 + 1) of the
    tokens, and every stream equals the JAX greedy continuation."""
    eng, sched = _sched(tiny, variant)
    wsum = DEFAULT_CLASS_WEIGHTS["interactive"] + \
        DEFAULT_CLASS_WEIGHTS["batch"]
    batch = [Request(prompt_ids=p, max_new_tokens=12, priority="batch")
             for p in _prompts(3, 4, 3)]
    inter = [Request(prompt_ids=p, max_new_tokens=6,
                     priority="interactive")
             for p in _prompts(4, 24, 2)]
    for r in inter + batch:
        sched.submit(r)
    got = collections.Counter()
    prev = {r.id: 0 for r in batch + inter}
    for _ in range(600):
        if all(r.done.is_set() for r in batch + inter):
            break
        depths = sched.pending.depths()
        contended = depths["interactive"] > 0 and depths["batch"] > 0
        sched.step()
        for r in batch + inter:
            n = len(r.output_ids)
            if contended:
                got[r.priority] += n - prev[r.id]
            prev[r.id] = n
    total = sum(got.values())
    assert total >= 60, got
    assert got["batch"] / total >= \
        DEFAULT_CLASS_WEIGHTS["batch"] / wsum, got
    assert sched.stats["preemptions_total"] == 0
    for r in batch + inter:
        assert r.finish_reason == "length", r.id
        assert list(r.output_ids) == _greedy_ref(
            tiny, _REFS, r.prompt_ids, r.max_new_tokens), r.id
    sched.stop()
