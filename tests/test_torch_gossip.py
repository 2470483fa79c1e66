"""The port's router anti-entropy (`ome_tpu_torch/router/gossip.py`)
against the reference's (`ome_tpu/router/gossip.py`).

* The merge algebra on seeded random observation maps: the port's LWW
  merge is commutative, associative and idempotent, converges under any
  pull order, and equals the reference's merge on the same inputs.
* `GossipState` on both sides, driven the same way on a frozen clock,
  serializes byte-identical snapshots (the wire format is shared, so a
  fleet can mix the two routers while it migrates), and each side's
  snapshot merges into the other's state as into its own.
* Over HTTP: a port replica and a reference replica gossip through
  `/gossip/state`; a breaker opened on one is honoured by the other
  within one pull, in both directions, and the prefix directory
  travels with it.
"""

import json
import random
import time

import pytest

from ome_tpu.router import aserver as ref_aserver
from ome_tpu.router import gossip as ref_gossip
from ome_tpu.router import server as ref_server
from ome_tpu_torch.router import aserver as port_aserver
from ome_tpu_torch.router import gossip as port_gossip
from ome_tpu_torch.router import server as port_server

SIDES = {"reference": (ref_server, ref_gossip, ref_aserver),
         "port": (port_server, port_gossip, port_aserver)}


def _record(rng):
    """A random observation record whose content is a pure function of
    its (stamp, origin) identity, as real snapshots are (a record is
    re-stamped whenever its content changes)."""
    stamp = rng.choice([0.0, round(rng.uniform(1.0, 100.0), 3)])
    origin = "" if stamp == 0.0 else rng.choice(["r0", "r1", "r2"])
    body = random.Random(f"{stamp}|{origin}")
    return {"pool": "engine",
            "healthy": body.random() < 0.7,
            "draining": body.random() < 0.2,
            "cb_state": body.choice(["closed", "half_open", "open"]),
            "fails": body.randint(0, 5),
            "cb_trips": body.randint(0, 3),
            "models": sorted(body.sample(["m1", "m2", "m3"],
                                         body.randint(0, 2))),
            "stamp": stamp, "origin": origin}


def _obs_map(rng):
    return {f"http://e{i}": _record(rng)
            for i in range(5) if rng.random() < 0.7}


@pytest.mark.parametrize("seed", [11, 13, 17])
def test_merge_algebra_and_equal_to_the_reference(seed):
    rng = random.Random(seed)
    m = port_gossip.merge_backends
    for _ in range(300):
        a, b, c = _obs_map(rng), _obs_map(rng), _obs_map(rng)
        assert m(a, b) == m(b, a)                       # commutative
        assert m(m(a, b), c) == m(a, m(b, c))           # associative
        assert m(a, a) == a and m(m(a, b), b) == m(a, b)  # idempotent
        assert m(a, b) == ref_gossip.merge_backends(a, b)
        assert port_gossip.merge_prefix(a, c) == \
            ref_gossip.merge_prefix(a, c)
        ra, rb = rng.choice(list(a.values()) or [None]), \
            rng.choice(list(b.values()) or [None])
        assert port_gossip.lww_wins(ra, rb) == ref_gossip.lww_wins(ra, rb)
        assert port_gossip.merge_records(ra, rb) == \
            ref_gossip.merge_records(ra, rb)


def test_any_pull_order_converges():
    rng = random.Random(19)
    for _ in range(50):
        n = rng.randint(2, 4)
        initial = [_obs_map(rng) for _ in range(n)]
        views = [dict(v) for v in initial]
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        schedule = pairs * 2
        rng.shuffle(schedule)
        for dst, src in schedule:
            views[dst] = port_gossip.merge_backends(views[dst], views[src])
        want = {}
        for v in initial:
            want = ref_gossip.merge_backends(want, v)
        assert all(v == want for v in views)


class _Frozen:
    """time.time / time.monotonic frozen (and steppable), for snapshots
    whose stamps and remaining cooldowns must be comparable."""

    def __init__(self, monkeypatch):
        self.wall, self.mono = 1_700_000_000.0, 5000.0
        monkeypatch.setattr(time, "time", lambda: self.wall)
        monkeypatch.setattr(time, "monotonic", lambda: self.mono)

    def step(self, s):
        self.wall += s
        self.mono += s


def _drive(side, clock):
    """One replica's observations, the same script on either side."""
    server, gossip, _ = SIDES[side]
    urls = ["http://e1", "http://e2", "http://e3"]
    # the breaker reads the frozen clock too (Router's default clock is
    # the real time.monotonic, bound when the module was imported)
    r = server.Router([server.Backend(u) for u in urls],
                      policy="round_robin", cb_threshold=1,
                      cb_cooldown=5.0, clock=lambda: time.monotonic())
    s = gossip.GossipState(r, "rA")
    snaps = [json.dumps(s.snapshot())]
    r.note_result(r.backends[0], ok=False)
    clock.step(1.0)
    r.note_draining(r.backends[1])
    r.prefix_directory.update("http://e3", ["d1", "d2"])
    r.model_map.advertise("http://e3", ["m1"])
    snaps.append(json.dumps(s.snapshot()))
    clock.step(2.0)
    r.note_result(r.backends[0], ok=True)
    snaps.append(json.dumps(s.snapshot()))
    return r, s, snaps


def test_snapshots_are_byte_identical(monkeypatch):
    clock = _Frozen(monkeypatch)
    _, _, want = _drive("reference", clock)
    clock = _Frozen(monkeypatch)
    _, _, got = _drive("port", clock)
    assert got == want
    assert '"cb_state": "open"' in got[1] and '"d1"' in got[1]
    assert '"cb_open_remaining": 4.0' in got[1]


@pytest.mark.parametrize("src,dst", [("reference", "port"),
                                     ("port", "reference")])
def test_snapshot_merges_across_implementations(src, dst, monkeypatch):
    """A snapshot from one side merges into the other exactly as into a
    replica of its own kind: the records adopted, the live breaker and
    drain state, the directory, the model map and the stats agree."""
    clock = _Frozen(monkeypatch)
    _, _, snaps = _drive(src, clock)
    snap = json.loads(snaps[1])
    outcomes = []
    for side in (src, dst):
        server, gossip, _ = SIDES[side]
        r = server.Router([server.Backend(u) for u in
                           ("http://e1", "http://e2", "http://e3")],
                          policy="round_robin")
        s = gossip.GossipState(r, "rB")
        adopted = s.merge(snap)
        again = s.merge(snap)                  # same version: skipped
        outcomes.append((
            adopted, again,
            [(b.url, b.healthy, b.draining, b.cb_state, b.fails,
              b.cb_trips, b.cb_open_until) for b in r.backends],
            r.prefix_directory.export(), r.model_map.export(),
            s.stats(), json.dumps(s.snapshot())))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] >= 4 and outcomes[0][1] == 0


def _pair(a_side, b_side):
    url = "http://127.0.0.1:9"                 # nothing listens there
    sa_mod, ga_mod, aa_mod = SIDES[a_side]
    sb_mod, gb_mod, ab_mod = SIDES[b_side]
    ra = sa_mod.Router([sa_mod.Backend(url)], policy="round_robin",
                       cb_threshold=1, cb_cooldown=30.0)
    rb = sb_mod.Router([sb_mod.Backend(url)], policy="round_robin",
                       cb_threshold=3, cb_cooldown=30.0)
    ga, gb = ga_mod.GossipState(ra, "ra"), gb_mod.GossipState(rb, "rb")
    srv_a = aa_mod.AsyncRouterServer(ra, host="127.0.0.1", port=0,
                                     gossip=ga).start()
    srv_b = ab_mod.AsyncRouterServer(rb, host="127.0.0.1", port=0,
                                     gossip=gb).start()
    return ra, rb, ga, gb, srv_a, srv_b, gb_mod, ga_mod


@pytest.mark.parametrize("a_side,b_side", [("reference", "port"),
                                           ("port", "reference")])
def test_breaker_opened_on_one_honoured_by_the_other(a_side, b_side):
    """Replica A (one implementation) trips a breaker; replica B (the
    other) adopts the open state in its very next pull from A's
    /gossip/state and stops routing there, without spending its own
    failures. Then the directory B learns travels back to A."""
    ra, rb, ga, gb, srv_a, srv_b, gb_mod, ga_mod = _pair(a_side, b_side)
    try:
        ra.note_result(ra.backends[0], ok=False)
        assert ra.backends[0].cb_state == "open"
        assert rb.backends[0].cb_state == "closed"
        agent_b = gb_mod.GossipAgent(
            gb, [f"http://127.0.0.1:{srv_a.port}"], interval=3600)
        assert agent_b.pull_once() >= 1            # one pull...
        b = rb.backends[0]
        assert b.cb_state == "open" and not b.healthy  # ...suffices
        assert rb.pick("engine") is None
        assert rb.stats["circuit_open_total"] == 0  # no failure spent
        assert 25.0 < b.cb_open_until - time.monotonic() <= 30.0
        rb.prefix_directory.update("http://127.0.0.1:9", ["d42"])
        agent_a = ga_mod.GossipAgent(
            ga, [f"http://127.0.0.1:{srv_b.port}"], interval=3600)
        assert agent_a.pull_once() >= 1
        assert ra.prefix_directory.lookup("d42") == "http://127.0.0.1:9"
        assert agent_b._c_pulls.value == agent_a._c_pulls.value == 1
    finally:
        srv_a.stop()
        srv_b.stop()
