"""The prefix cache's host tier in the port, against the JAX package.

One op script — the scenarios of the reference's `TestHostTier` and
`test_engine_host_tier_spill_swapin_divergent_suffix`
(tests/test_prefix_cache.py): spill on eviction, a host hit that queues
a swap-in while the request recomputes, the next request hitting on the
device, a divergent suffix sharing the swapped-in block, the host LRU
budget, a re-put dropping the stale host copy, a swap-in refused while
the parent chain is not device-resident — runs against the reference's
`PrefixCache` (jax arrays) and the port's (torch tensors) on the same
seeded values. After every op (and its swap-ins drained), device and
host bytes, hits, misses, evictions, host hits, swap-ins, recomputes,
`tier_conservation` and each match's length and bytes are equal. A
swapped-in block's bytes equal the spilled block's. The port engine's
`kv_conservation` fails when a block sits in both tiers, and engine
greedy streams with `prefix_host_bytes` equal the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine.core import InferenceEngine as JaxEngine
from ome_tpu.engine.core import PrefixCache as JaxPrefixCache
from ome_tpu.models import llama as jllama
from ome_tpu.models.config import tiny_test as jax_tiny
from ome_tpu_torch.engine.core import InferenceEngine, PrefixCache
from ome_tpu_torch.models.config import tiny_test
from ome_tpu_torch.models.params import from_jax_params

BLOCK = 4
BLOCK_BYTES = 2 * (1 * 1 * BLOCK * 1 * 2 * 4)  # one block, k + v, fp32
MB64 = 64 << 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """The reference's cache and the port's, driven op for op on the same
    planes."""

    def __init__(self, dev_blocks, host_blocks):
        kw = dict(capacity_bytes=dev_blocks * BLOCK_BYTES, block=BLOCK,
                  min_prefix=BLOCK,
                  host_capacity_bytes=host_blocks * BLOCK_BYTES)
        self.ref, self.port = JaxPrefixCache(**kw), PrefixCache(**kw)
        self.rng = np.random.default_rng(0)
        self.planes = {}   # ids -> the k plane put for them (numpy)

    def put(self, ids):
        n = len(ids)
        k = self.rng.standard_normal((1, 1, n, 1, 2)).astype(np.float32)
        v = -k
        self.planes[tuple(ids)] = k
        self.ref.put(list(ids), jnp.asarray(k), jnp.asarray(v), n, n)
        self.port.put(list(ids), torch.from_numpy(k), torch.from_numpy(v),
                      n, n)
        return self.check()

    def match(self, ids):
        a = self.ref.match(list(ids))
        b = self.port.match(list(ids))
        assert (a is None) == (b is None)
        if a is not None:
            assert a[2:] == b[2:]
            np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy())
            np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())
        self.check()
        return b

    def swapin(self, path):
        self.ref._swapin_one(tuple(path))
        self.port._swapin_one(tuple(path))
        return self.check()

    def host_put(self, path, k):
        """Place a block straight into both host tiers (an orphan whose
        parent chain is not on the device)."""
        v = -k
        with self.ref._tier_lock:
            self.ref._host[tuple(path)] = (k, v, k.nbytes + v.nbytes)
            self.ref.host_bytes += k.nbytes + v.nbytes
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        with self.port._tier_lock:
            self.port._host[tuple(path)] = (tk, tv, k.nbytes + v.nbytes)
            self.port.host_bytes += k.nbytes + v.nbytes
        return self.check()

    def check(self):
        for pc in (self.ref, self.port):
            pc.drain_swapins()
        names = ("bytes", "host_bytes", "hits", "misses", "evictions",
                 "host_hits", "host_swapins", "host_recomputes")
        a = {n: getattr(self.ref, n) for n in names}
        b = {n: getattr(self.port, n) for n in names}
        assert a == b
        assert self.ref.tier_conservation() == self.port.tier_conservation()
        assert self.port.tier_conservation()[0]
        assert list(self.ref._host) == list(self.port._host)
        for path, (k, v, nb) in self.port._host.items():
            rk, rv, rnb = self.ref._host[path]
            assert nb == rnb
            np.testing.assert_array_equal(np.asarray(rk), k.numpy())
            np.testing.assert_array_equal(np.asarray(rv), v.numpy())
        return b


def test_op_script_state_equals_reference():
    t = Twin(dev_blocks=2, host_blocks=8)
    # eviction spills instead of dropping
    t.put([1, 2, 3, 4])
    t.put([5, 6, 7, 8])
    st = t.put([9, 10, 11, 12])
    assert st["evictions"] == 1 and st["host_bytes"] == BLOCK_BYTES
    # a host hit queues the swap-in; this request recomputes
    assert t.match([1, 2, 3, 4, 0]) is None
    assert (t.port.host_hits, t.port.host_recomputes,
            t.port.host_swapins) == (1, 1, 1)
    # the next same-prefix request hits on the device, with the spilled
    # block's own bytes
    hit = t.match([1, 2, 3, 4, 0])
    assert hit is not None and hit[2] == BLOCK
    np.testing.assert_array_equal(hit[0].numpy(), t.planes[(1, 2, 3, 4)])
    # a two-block prompt; a divergent continuation shares the first
    # block after a spill and swap-in of the leaf
    t.put([1, 2, 3, 4, 5, 6, 7, 8])
    t.put([20, 21, 22, 23])
    t.put([30, 31, 32, 33])
    t.match([1, 2, 3, 4, 5, 6, 7, 8, 0])
    hit = t.match([1, 2, 3, 4, 99, 98, 97, 96, 0])
    assert hit is not None and hit[2] == BLOCK
    # a re-put of a spilled path drops its stale host copy
    spilled = [p for p in t.port._host if len(p) == BLOCK]
    assert spilled
    t.put(list(spilled[0]))
    assert spilled[0] not in t.port._host
    # a block whose parent chain is off the device stays hosted; once the
    # parent is put back, the same swap-in lands
    rng = np.random.default_rng(9)
    orphan = (40, 41, 42, 43, 44, 45, 46, 47)
    t.host_put(orphan, rng.standard_normal((1, 1, BLOCK, 1, 2))
               .astype(np.float32))
    st = t.swapin(orphan)
    assert orphan in t.port._host
    t.put([40, 41, 42, 43])
    before = t.port.host_swapins
    st = t.swapin(orphan)
    assert st["host_swapins"] == before + 1 and orphan not in t.port._host


def test_host_budget_bounds_the_lru_like_the_reference():
    t = Twin(dev_blocks=1, host_blocks=2)
    for start in range(0, 24, 4):
        st = t.put(list(range(start, start + 4)))
        assert st["host_bytes"] <= 2 * BLOCK_BYTES
    # the oldest spills were dropped: no host hit for them
    before = t.port.host_hits
    assert t.match([0, 1, 2, 3, 9]) is None
    assert t.port.host_hits == before
    # the newest spill still swaps in
    assert t.match([16, 17, 18, 19, 9]) is None
    assert t.match([16, 17, 18, 19, 9]) is not None


def _chain_planes(ids, seed):
    k = np.random.default_rng(seed).standard_normal(
        (1, 1, len(ids), 1, 2)).astype(np.float32)
    return k, -k


N_CHAIN = 4
CHAIN_A = list(range(1, 1 + N_CHAIN * BLOCK))
CHAIN_B = list(range(100, 100 + N_CHAIN * BLOCK))
CHAIN_KW = dict(capacity_bytes=N_CHAIN * BLOCK_BYTES, block=BLOCK,
                min_prefix=BLOCK, host_capacity_bytes=4 * N_CHAIN
                * BLOCK_BYTES)


def test_put_into_a_full_tier_evicts_the_older_chain_first():
    """A tier that holds one chain of n blocks takes the put of another
    n-block chain by evicting the older chain whole: LRU over the
    leaves of the moment. The reference evicts every leaf of one pass,
    the new chain's last block among them, so there the new chain
    keeps half its blocks; the port departs from it here."""
    got = {}
    for name, pc, conv in (("ref", JaxPrefixCache(**CHAIN_KW), jnp.asarray),
                           ("port", PrefixCache(**CHAIN_KW),
                            torch.from_numpy)):
        for seed, ids in enumerate((CHAIN_A, CHAIN_B)):
            k, v = _chain_planes(ids, seed)
            pc.put(ids, conv(k), conv(v), len(ids), len(ids))
        got[name] = pc.match(CHAIN_B + [0])[2]
        pc.drain_swapins()
        assert pc.tier_conservation()[0]
    assert got == {"ref": N_CHAIN // 2 * BLOCK, "port": N_CHAIN * BLOCK}


def test_put_after_swapins_keeps_the_whole_chain():
    """A host hit's recomputing put that lands after some of the chain's
    swap-ins (the swap thread runs beside the prefill) leaves the whole
    chain on the device, and the chain it displaced whole in the host
    tier."""
    pc = PrefixCache(**CHAIN_KW)
    for seed, ids in enumerate((CHAIN_A, CHAIN_B)):
        k, v = _chain_planes(ids, seed)
        pc.put(ids, torch.from_numpy(k), torch.from_numpy(v), len(ids),
               len(ids))
    for j in (1, 2):        # two of the chain's blocks swapped in first
        pc._swapin_one(tuple(CHAIN_A[:j * BLOCK]))
    assert pc.host_swapins == 2
    k, v = _chain_planes(CHAIN_A, 0)
    pc.put(CHAIN_A, torch.from_numpy(k), torch.from_numpy(v),
           len(CHAIN_A), len(CHAIN_A))
    hit = pc.match(CHAIN_A + [0])
    assert hit[2] == N_CHAIN * BLOCK
    np.testing.assert_array_equal(hit[0].numpy(), k)
    assert all(tuple(CHAIN_B[:j * BLOCK]) in pc._host
               for j in range(1, N_CHAIN + 1))
    assert pc.tier_conservation() == (True, N_CHAIN, N_CHAIN)


def test_tier_disabled_without_budget():
    t = Twin(dev_blocks=2, host_blocks=0)
    for start in range(0, 16, 4):
        st = t.put(list(range(start, start + 4)))
    assert st["host_bytes"] == 0 and st["evictions"] == 2
    assert t.match([0, 1, 2, 3, 9]) is None
    assert t.port.host_hits == 0


# -- engines -----------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    jcfg = jax_tiny().replace(dtype=jnp.float32, max_seq_len=256)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tcfg = tiny_test().replace(dtype=torch.float32, max_seq_len=256)
    return jcfg, jparams, tcfg, tparams


def _greedy(engine, prompt, steps=6, slot=0):
    state = engine.new_state()
    tok, kv, true_len, bucket = engine.prefill(prompt)
    state = engine.insert(state, kv, slot, true_len, tok, bucket)
    out = [int(tok)]
    B = engine.max_slots
    for _ in range(steps):
        state, toks = engine.decode(state, np.zeros(B, np.float32),
                                    np.zeros(B, np.int32),
                                    np.ones(B, np.float32))
        out.append(int(np.asarray(toks)[slot]))
    return out


def _engines(world, **kw):
    jcfg, jparams, tcfg, tparams = world
    kw = dict(max_slots=2, max_seq=128, prefill_buckets=[16, 32, 64, 128],
              **kw)
    return (JaxEngine(jparams, jcfg, **kw),
            InferenceEngine(tparams, tcfg, device="cpu", **kw))


def test_engine_host_tier_streams_equal_jax(world):
    base1 = list(range(2, 40))    # one cached 32-block each
    base2 = list(range(100, 138))
    p1 = base1 + [77, 78, 79]
    p2 = base1 + [90, 91, 92]     # divergent suffix, same block
    jprobe, tprobe = _engines(world, prefix_cache_bytes=MB64)
    _greedy(tprobe, base1)
    one_block = tprobe.prefix_cache.bytes
    assert one_block > 0
    jeng, teng = _engines(world, prefix_cache_bytes=one_block,
                          prefix_host_bytes=MB64)
    names = ("bytes", "host_bytes", "hits", "misses", "host_hits",
             "host_swapins", "host_recomputes", "evictions")
    for prompt in (base1, base2, p1, None, p2):
        for eng in (jeng, teng):
            if prompt is None:
                eng.prefix_cache.drain_swapins()
        if prompt is not None:
            assert _greedy(teng, prompt) == _greedy(jeng, prompt)
        assert ({n: getattr(teng.prefix_cache, n) for n in names}
                == {n: getattr(jeng.prefix_cache, n) for n in names})
    pc = teng.prefix_cache
    assert pc.host_swapins >= 1 and pc.host_recomputes >= 1
    assert teng.kv_conservation()[0]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_kv_conservation_fails_with_a_block_in_both_tiers(world, cache):
    kw = dict(kv_block=16, kv_blocks=20) if cache == "paged" else {}
    _, teng = _engines(world, prefix_cache_bytes=MB64,
                       prefix_host_bytes=MB64, **kw)
    _greedy(teng, list(range(2, 40)))
    for slot in range(teng.max_slots):
        teng.free_slot(slot)
    assert teng.kv_conservation()[0]
    pc = teng.prefix_cache
    (key, node), = pc._root.items()
    ks, vs = node["kv"]
    with pc._tier_lock:
        pc._host[key] = (ks.clone(), vs.clone(), pc._leaf_bytes(ks, vs))
        pc.host_bytes += pc._leaf_bytes(ks, vs)
    assert not pc.tier_conservation()[0]
    assert not teng.kv_conservation()[0]
