"""Sampling parity: ome_tpu_torch.engine.sampling against the JAX package.

`filtered_logits` must give the same distribution on the same numpy
logits, and greedy `sample` the same tokens. The random draws cannot
match `jax.random` bit for bit, so temperature > 0 is held to the
filtered distribution by a frequency test instead.

The main inputs are tie-free (continuous random logits, checked): the
reference orders by `argsort(...)[:, ::-1]`, and although the port
reproduces that order among equal logits too (stable ascending sort,
then reversed — checked separately below), a comparison that hinged
on tie order would test the sort, not the sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ome_tpu.engine import sampling as jsampling
from ome_tpu_torch.engine import sampling

PARAMS = dict(
    temperature=np.asarray([0.0, 0.7, 1.0, 1.3, 0.5], np.float32),
    top_k=np.asarray([0, 5, 50, 0, 1], np.int32),
    top_p=np.asarray([1.0, 0.9, 0.5, 0.95, 1.0], np.float32),
)


def _logits(seed, B=5, V=300, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((B, V)) * scale
    x = x.astype(np.float32)
    for row in x:
        assert np.unique(row).size == row.size  # tie-free
    return x


def _both(logits, **p):
    ref = jsampling.filtered_logits(
        jnp.asarray(logits), *(jnp.asarray(p[k]) for k in PARAMS))
    out = sampling.filtered_logits(
        torch.from_numpy(logits), *(torch.from_numpy(p[k]) for k in PARAMS))
    return np.asarray(ref), out.numpy()


def _near_top_p(logits, eps=1e-6):
    """[B, V] mask of tokens whose top-p decision sits within `eps` of
    the threshold: the mass ranked before them, computed in float64, is
    that close to top_p. Both packages compare an fp32 cumulative sum
    against top_p; summed in different orders, such a token can fall on
    either side, so the comparison skips the (rare) few."""
    t = PARAMS["temperature"].astype(np.float64)
    scaled = logits.astype(np.float64) / np.where(t > 0, t, 1)[:, None]
    order = np.argsort(-scaled, axis=1, kind="stable")
    srt = np.take_along_axis(scaled, order, 1)
    p = np.exp(srt - srt.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    near_sorted = np.abs(np.cumsum(p, 1) - p
                         - PARAMS["top_p"][:, None]) < eps
    # where top-k already drops a rank, top-p cannot change the outcome
    k = PARAMS["top_k"][:, None]
    near_sorted &= (k <= 0) | (np.arange(p.shape[1])[None, :] < k)
    near = np.zeros_like(near_sorted)
    np.put_along_axis(near, order, near_sorted, 1)
    return near


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filtered_logits_equal(seed):
    logits = _logits(seed)
    ref, out = _both(logits, **PARAMS)
    kept_ref, kept = ref > -1e29, out > -1e29
    sure = ~_near_top_p(logits)
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(kept[sure], kept_ref[sure])
    both = kept & kept_ref
    np.testing.assert_allclose(out[both], ref[both], rtol=1e-6)
    # the filters really filtered something
    assert kept.sum(axis=1)[4] == 1 and kept.sum(axis=1)[1] <= 5


def test_filtered_logits_tie_order_matches_reference():
    # equal logits: the reference ranks the higher index first; top-k
    # then keeps the same members of a tie in both packages
    logits = np.zeros((2, 16), np.float32)
    logits[:, 3] = 1.0
    p = dict(temperature=np.ones(2, np.float32),
             top_k=np.asarray([4, 9], np.int32),
             top_p=np.ones(2, np.float32))
    ref = jsampling.filtered_logits(jnp.asarray(logits),
                                    *(jnp.asarray(p[k]) for k in PARAMS))
    out = sampling.filtered_logits(torch.from_numpy(logits),
                                   *(torch.from_numpy(p[k]) for k in PARAMS))
    np.testing.assert_array_equal(out.numpy() > -1e29,
                                  np.asarray(ref) > -1e29)


@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_sample_equal(seed):
    logits = _logits(seed)
    B = logits.shape[0]
    zeros = np.zeros(B, np.float32)
    ref = jsampling.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                           jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
                           jnp.ones(B, jnp.float32))
    out = sampling.sample(torch.from_numpy(logits),
                          torch.Generator().manual_seed(0),
                          torch.from_numpy(zeros),
                          torch.zeros(B, dtype=torch.int32),
                          torch.ones(B))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_frequencies_follow_the_filtered_distribution():
    # one row repeated N times: the empirical token frequencies of the
    # Gumbel-max draws match softmax(filtered logits)
    V, N = 12, 20000
    row = np.linspace(-1.0, 1.5, V).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    t = torch.full((N,), 0.8)
    k = torch.full((N,), 6, dtype=torch.int32)
    p = torch.full((N,), 0.9)
    toks = sampling.sample(logits, torch.Generator().manual_seed(7), t, k, p)
    want = torch.softmax(sampling.filtered_logits(
        logits[:1], t[:1], k[:1], p[:1])[0], dim=0).numpy()
    got = np.bincount(toks.numpy(), minlength=V) / N
    np.testing.assert_allclose(got, want, atol=0.015)
    assert got[want == 0].sum() == 0  # filtered tokens are never drawn


def test_sample_is_seeded():
    logits = torch.from_numpy(_logits(5))
    t = torch.ones(5)
    k = torch.zeros(5, dtype=torch.int32)
    p = torch.ones(5)
    a = sampling.sample(logits, torch.Generator().manual_seed(1), t, k, p)
    b = sampling.sample(logits, torch.Generator().manual_seed(1), t, k, p)
    assert torch.equal(a, b)
