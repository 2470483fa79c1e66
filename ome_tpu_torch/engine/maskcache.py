"""AOT grammar-mask compiler and the adaptive state-mask cache.

Copied unchanged from ome_tpu/engine/maskcache.py (it imports no jax): the
port keeps its own copy, as it imports nothing of the JAX package.

XGrammar (Dong et al., arXiv:2411.15100 — PAPERS.md) splits grammar
masking into an ahead-of-time part (classify the vocabulary once per
grammar x tokenizer pair) and a tiny per-step residual. This module is
that split for the in-repo byte automata:

  * `CompiledTokenTable` — one compilation per tokenizer: raw token
    bytes plus numpy-indexable first-byte / length / plain-string
    columns. `mask_bits()` computes an allowed-token mask with the
    first-byte prefilter (256 trial `advance()` calls decide most of
    the vocabulary), a plain-string-interior fast path (inside an
    unconstrained JSON string, every printable token whose bytes avoid
    `"` and `\\` is legal — no walk at all), and a per-first-byte
    advanced-automaton reuse so a miss costs O(surviving tokens), not
    O(V) full byte-walks.
  * `compiled_table()` — the process-wide table cache. Keyed by
    tokenizer identity with `weakref.finalize` eviction so a GC'd
    tokenizer's reused `id()` can never alias a stale table (the old
    `TokenMasker._tables` bug).
  * `GrammarMaskCache` — bounded LRU from automaton-state signature
    (structured.TokenMasker.cache_key) to a row of the engine's
    device-resident `[S, V]` mask table. Steady-state decode plans
    reference cached states by row index (K ints per slot on the
    wire instead of K*V mask bools); rows referenced by the plan
    being built are pinned so eviction can't pull a row out from
    under an in-flight gather.

Host-side numpy only — nothing here touches the device; uploads go
through the engine callback handed to `GrammarMaskCache`.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class CompiledTokenTable:
    """Per-tokenizer AOT artifact: token byte strings plus the numpy
    columns the first-byte prefilter indexes by token id."""

    def __init__(self, table: List[bytes]):
        self.raw = table
        n = len(table)
        self.lengths = np.fromiter((len(t) for t in table),
                                   dtype=np.int32, count=n)
        self.first_byte = np.fromiter((t[0] if t else 0 for t in table),
                                      dtype=np.int32, count=n)
        self.nonempty = self.lengths > 0
        self.max_len = int(self.lengths.max()) if n else 0
        self.present_first = sorted(
            {t[0] for t in table if t})
        self.single_first = sorted(
            {t[0] for t in table if len(t) == 1})
        # tokens made only of plain string-interior bytes: printable,
        # no quote, no backslash — legal anywhere inside an
        # unconstrained JSON string, and they leave the automaton
        # state unchanged
        self.str_plain = np.fromiter(
            (bool(t) and all(0x20 <= b and b != 0x22 and b != 0x5C
                             for b in t) for t in table),
            dtype=bool, count=n)

    def mask_bits(self, automaton, eos_id: Optional[int],
                  vocab_size: int, closing: bool = False,
                  budget: Optional[int] = None,
                  with_slack: bool = False):
        """Allowed-token mask for one automaton state.

        Semantics match the original TokenMasker.mask() byte-walk:
        `closing` restricts to the minimal completion path, `budget`
        (bytes) bans tokens after which the minimal completion no
        longer fits. The prefilter only changes the cost model.

        `with_slack` (budget-free, non-closing only) returns
        `(mask, slack)` where slack is the worst growth of
        `closing_distance()` over any single accepted token. A cache
        holding this mask may serve a budget-limited request exactly
        when `remaining - 1 >= closing_distance() + slack`: past that
        horizon no accepted token can push the minimal completion out
        of budget, so the budgeted mask equals this one."""
        if with_slack and (closing or budget is not None):
            raise ValueError("with_slack requires the budget-free, "
                             "non-closing mask")
        n = len(self.raw)
        m = np.zeros(vocab_size, dtype=bool)
        slack = 0
        cd_now = automaton.closing_distance() if with_slack else 0
        if closing:
            cb = automaton.closing_bytes()
            surv = self.nonempty.copy()
            if cb:
                allowed = np.zeros(256, dtype=bool)
                allowed[list(cb)] = True
                surv &= allowed[self.first_byte]
            else:
                surv[:] = False
            for i in np.flatnonzero(surv):
                if automaton.accepts_closing(self.raw[i]):
                    m[i] = True
        else:
            # first-byte prefilter: one trial advance per byte value
            # present in the vocab; keep the advanced copies so
            # surviving tokens skip their first byte
            allowed = np.zeros(256, dtype=bool)
            advanced: Dict[int, object] = {}
            for b in self.present_first:
                w = automaton.copy()
                if w.advance(b):
                    allowed[b] = True
                    advanced[b] = w
            surv = self.nonempty & allowed[self.first_byte]
            if budget is None:
                plain = getattr(automaton, "plain_str_interior", None)
                if plain is not None and plain():
                    # inside a plain string every surviving
                    # plain-bytes token is legal as-is
                    sp = surv & self.str_plain
                    m[:n] |= sp
                    surv &= ~sp
                # single-byte tokens are fully decided by the prefilter
                one = surv & (self.lengths == 1)
                m[:n] |= one
                surv &= ~one
                if with_slack:
                    # plain-interior tokens leave the state (and its
                    # closing distance) unchanged; single-byte tokens
                    # end in the already-advanced prefilter state
                    for b in self.single_first:
                        if allowed[b]:
                            slack = max(slack, advanced[b]
                                        .closing_distance() - cd_now)
            for i in np.flatnonzero(surv):
                w = advanced[self.raw[i][0]].copy()
                ok = True
                for b in self.raw[i][1:]:
                    if not w.advance(b):
                        ok = False
                        break
                if ok and (budget is None
                           or w.closing_distance() <= budget):
                    m[i] = True
                    if with_slack:
                        slack = max(slack,
                                    w.closing_distance() - cd_now)
        if eos_id is not None and automaton.is_complete():
            m[eos_id] = True
        if not m.any() and eos_id is not None:
            m[eos_id] = True  # dead end: finish rather than hang
        if with_slack:
            return m, slack
        return m


# tokenizer identity -> (table, pin). `pin` keeps a strong reference
# only when the tokenizer is not weakref-able (then its id can never
# be reused while the entry lives); otherwise weakref.finalize evicts
# the entry the moment the tokenizer is collected.
_COMPILED: Dict[int, Tuple[CompiledTokenTable, object]] = {}


def _evict_compiled(key: int) -> None:
    _COMPILED.pop(key, None)


def compiled_table(tok) -> CompiledTokenTable:
    """The process-wide CompiledTokenTable for `tok` (built once)."""
    key = id(tok)
    ent = _COMPILED.get(key)
    if ent is not None:
        return ent[0]
    from .structured import _build_token_table
    ctab = CompiledTokenTable(_build_token_table(tok))
    try:
        weakref.finalize(tok, _evict_compiled, key)
        pin = None
    except TypeError:
        pin = tok
    _COMPILED[key] = (ctab, pin)
    return ctab


class GrammarMaskCache:
    """Bounded LRU of automaton-state masks resident on the device.

    Owns rows 1..rows-1 of the engine's `[rows, V]` mask table — row 0
    is the engine's reserved all-True row that unmasked slots index.
    Each entry carries the state's budget-free mask bits, its device
    row, and its budget *slack*: the worst growth of the automaton's
    closing distance over any single accepted token, measured when the
    mask was compiled. A cached row substitutes for a budget-limited
    dense mask exactly when `remaining - 1 >= closing_distance +
    slack` — past that horizon the byte budget provably bans nothing
    the grammar allows, so the masks are identical.

    `get()` hits touch the LRU and pin the row; `insert()` installs a
    freshly compiled mask, uploading its row (row None when every row
    is pinned by the plan being built — the caller then keeps that
    position dense). Eviction simply reuses the LRU unpinned row: the
    next upload overwrites it, which is the invalidation; pinning
    keeps eviction from pulling a row out from under the plan that
    referenced it."""

    def __init__(self, rows: int,
                 upload: Callable[[int, np.ndarray], None],
                 on_hit: Optional[Callable[[], None]] = None,
                 on_miss: Optional[Callable[[], None]] = None,
                 on_evict: Optional[Callable[[], None]] = None):
        self.rows = int(rows)
        self._upload = upload
        self._on_hit = on_hit or (lambda: None)
        self._on_miss = on_miss or (lambda: None)
        self._on_evict = on_evict or (lambda: None)
        # key -> (row, host bits, slack), in LRU order (oldest first)
        self._lru: "OrderedDict[object, Tuple[int, np.ndarray, int]]" \
            = OrderedDict()
        self._free = list(range(self.rows - 1, 0, -1))
        self._pinned: set = set()

    def __len__(self) -> int:
        return len(self._lru)

    def begin_plan(self) -> None:
        """Start a new step plan: rows looked up from here on are
        pinned (ineligible for eviction) until the next begin_plan."""
        self._pinned.clear()

    def get(self, key):
        """(bits, row, slack) on a hit — touching LRU order and
        pinning the row — or None on a miss."""
        ent = self._lru.get(key)
        if ent is None:
            return None
        self._lru.move_to_end(key)
        self._pinned.add(ent[0])
        self._on_hit()
        return ent[1], ent[0], ent[2]

    def insert(self, key, bits: np.ndarray, slack: int):
        """Install a freshly compiled state mask and upload its row.
        Returns (bits, row, slack); row is None — and nothing is
        installed — when the table is exhausted by pinned rows."""
        self._on_miss()
        row = self._alloc()
        if row is None:
            return bits, None, slack
        self._lru[key] = (row, bits, slack)
        self._pinned.add(row)
        self._upload(row, bits)
        return bits, row, slack

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        for key, (row, _, _) in self._lru.items():
            if row not in self._pinned:
                del self._lru[key]
                self._on_evict()
                return row
        return None
