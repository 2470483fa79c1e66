"""Ring attention of the port (ome_tpu_torch/parallel/ring_attention.py)
in gloo groups of n = 2, 4 and 8 rank processes: each rank holds only
its S/n rows of q, k and v and returns its S/n rows, which equal full
causal attention over the gathered sequence (the reference's XLA path,
`attention(..., backend="xla")`) within 2e-5, with and without a logit
softcap, as tests/test_ring_attention.py holds the reference."""

import jax.numpy as jnp
import numpy as np
import pytest

from ome_tpu.ops.attention import attention
from tests import torch_tp_workers as tp_workers
from tests import torch_train_workers as workers


def _mk(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


def _full(q, k, v, softcap=None):
    B, S = q.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    return np.asarray(attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), positions=positions,
                                logit_softcap=softcap, backend="xla"))


@pytest.mark.parametrize("n,HK,softcap", [(2, (8, 4), None),
                                          (4, (8, 8), None),
                                          (8, (4, 2), None),
                                          (4, (4, 4), 30.0)])
def test_ring_matches_full_causal(n, HK, softcap):
    H, K = HK
    B, S, D = (2, 64, 16) if softcap is None else (1, 32, 16)
    q, k, v = _mk(n, B, S, H, K, D)
    want = _full(q, k, v, softcap)
    got = tp_workers.run_group(workers.ring, q, k, v, softcap, size=n)
    sl = S // n
    for r, out in enumerate(got):
        assert out.shape == (B, sl, H, D)  # each rank holds S/n rows
        np.testing.assert_allclose(out, want[:, r * sl:(r + 1) * sl],
                                   atol=2e-5, err_msg=f"ring n={n} rank {r}")
