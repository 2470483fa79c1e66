"""Host-side n-gram self-drafting (prompt-lookup decoding).

Copied unchanged from ome_tpu/engine/spec.py (it imports no jax): the
port keeps its own copy, as it imports nothing of the JAX package.

The drafter proposes up to `k` continuation tokens per slot by
matching the tail n-gram of the already-committed token stream
(`prompt_ids + output_ids`) against earlier occurrences in the same
stream and replaying what followed the most recent one — the
"prompt lookup" trick (Saxena 2023; vLLM's `[ngram]` speculative
mode). It is free: no draft model, no device work, just a numpy
scan over host-resident token lists. A miss proposes nothing and the
slot degenerates to plain decode inside the batched verify, so a bad
drafter can only cost throughput, never correctness — the verify
forward accepts exactly the tokens the target model would have
produced (docs/speculative-decoding.md).

Grammar-masked slots draft through the same machinery: the planner
walks the grammar and drafts forced-token runs directly (accepted
with certainty — the masked target distribution has no other
support), and at a free boundary it screens these n-gram proposals
through the automaton walk with `grammar_prefix` — a proposal the
grammar rejects truncates the draft, it can never emit
(docs/structured-outputs.md).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# longest / shortest tail n-gram tried for a lookup match; longer
# n-grams are tried first because their continuations are more
# specific (higher acceptance), shorter ones keep the hit rate up on
# loosely repetitive streams
NGRAM_MAX = 3
NGRAM_MIN = 1


def propose(ctx: Sequence[int], k: int, *, ngram_max: int = NGRAM_MAX,
            ngram_min: int = NGRAM_MIN) -> np.ndarray:
    """Propose up to ``k`` draft tokens continuing ``ctx``.

    ``ctx`` is the slot's committed token stream (prompt + emitted
    output, host ints). Tries tail n-grams from ``ngram_max`` down to
    ``ngram_min``; on the first n with an earlier occurrence, returns
    the (up to ``k``) tokens that followed the most recent match.
    Returns an int32 array of length in [0, k] — empty means "no
    match, decode plainly".
    """
    # omelint: disable=hot-path-sync -- ctx is a host-side int list (the committed token stream), not a device array
    arr = np.asarray(ctx, np.int32)
    L = arr.shape[0]
    if k <= 0 or L < ngram_min + 1:
        return np.zeros((0,), np.int32)
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        tail = arr[L - n:]
        # candidate starts are 0..L-n-2 relative to the full stream:
        # strictly earlier than the tail itself, with at least one
        # follower token to replay
        windows = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((windows == tail).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n
            return arr[start:start + k].copy()
    return np.zeros((0,), np.int32)


def grammar_prefix(proposals: Sequence[int], accept) -> int:
    """Length of the longest draftable prefix of ``proposals``.

    ``accept(token) -> bool`` is the planner's probe: it advances a
    scratch copy of the slot's grammar automaton and reports whether
    the token keeps the draft inside the grammar AND the position
    after it remains plannable (mask row resident, byte budget not
    exhausted). The first refusal truncates — a truncated draft is
    just a shorter draft; the verify step's per-position masks
    guarantee nothing out-of-grammar can be emitted either way."""
    n = 0
    for t in proposals:
        if not accept(int(t)):
            break
        n += 1
    return n
