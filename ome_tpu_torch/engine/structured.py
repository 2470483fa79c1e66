"""Structured outputs: grammar-constrained decoding (JSON mode).

Copied from ome_tpu/engine/structured.py (it imports no jax), code
unchanged: the port keeps its own copy, as it imports nothing of the
JAX package.

The reference serves structured output through SGLang's constrained
decoding (xgrammar/outlines compile grammars to token-level FSMs on
GPU); this is the TPU-native redesign for the in-repo engine:

  * a BYTE-level pushdown automaton accepts exactly the JSON grammar
    (objects/arrays/strings with escapes/numbers/literals + bounded
    whitespace). Byte-level beats token-level as the source of truth:
    it is tokenizer-independent, and the engine's hermetic
    ByteTokenizer maps one token to one byte, so masks there are exact
    set lookups.
  * masks are an ahead-of-time compiled, cached, device-resident
    artifact (maskcache.py, after XGrammar's adaptive token-mask
    cache): the token->bytes table compiles once per tokenizer into
    numpy columns; a cache miss computes the state's mask with a
    first-byte prefilter + plain-string fast path (O(surviving
    tokens), not O(V) byte-walks) and uploads it as one row of the
    engine's [S, V] device mask table; steady-state decode hits the
    cache and the step plan ships per-slot ROW INDICES (K ints)
    instead of dense [K, V] bool masks, with the device program
    gathering rows in-program. States the cache can't hold (closing
    masks, tight budgets, pinned-out tables) fall back to the dense
    host-computed mask path. Unconstrained batches keep the maskless
    compiled program — zero cost when the feature is off.
  * EOS becomes legal exactly when the automaton has accepted a
    complete JSON value; max_new_tokens still bounds pathological
    grammars.

Scope: `response_format {"type": "json_object"}` (any complete JSON
value, object-rooted when `object_root`). Schema-conditioned grammars
(`json_schema`) compile to the same mask interface and are recorded as
future work — the automaton is the extension point.
"""

from __future__ import annotations

import base64
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import maskcache


def pack_mask(mask: Optional[np.ndarray]) -> Optional[dict]:
    """Wire form of a boolean mask (np.packbits + base64): ~V/8 bytes
    per row, small enough to ride the multi-host op stream and the PD
    prefill request body."""
    if mask is None:
        return None
    m = np.asarray(mask, bool)
    return {"shape": list(m.shape),
            "bits": base64.b64encode(np.packbits(m)).decode()}


def unpack_mask(obj: Optional[dict]) -> Optional[np.ndarray]:
    """Inverse of pack_mask (None passes through)."""
    if not obj:
        return None
    shape = tuple(int(d) for d in obj["shape"])
    n = int(np.prod(shape))
    bits = np.frombuffer(base64.b64decode(obj["bits"]), np.uint8)
    return np.unpackbits(bits, count=n).astype(bool).reshape(shape)

# -- byte-level JSON pushdown automaton ------------------------------------

WS = frozenset(b" \t\n\r")
DIGITS = frozenset(b"0123456789")
HEX = frozenset(b"0123456789abcdefABCDEF")

# modes (top of an explicit stack; the stack nests containers)
VALUE = "value"            # expecting a value
OBJ_KEY_OR_END = "obj0"    # '{' seen: '"' or '}'
OBJ_KEY = "objk"           # after ',': a '"' key must follow
OBJ_COLON = "objc"         # key done: ':'
OBJ_COMMA_OR_END = "obje"  # value done: ',' or '}'
ARR_VAL_OR_END = "arr0"    # '[' seen: value or ']'
ARR_COMMA_OR_END = "arre"  # value done: ',' or ']'
STR = "str"                # inside a string
STR_ESC = "esc"            # after backslash
STR_HEX = "hex"            # inside \uXXXX (digits remaining in aux)
NUM = "num"                # inside a number (aux = sub-state)
LIT = "lit"                # inside true/false/null (aux = rest)
DONE = "done"

_NUM_START = frozenset(b"-0123456789")
_LITERALS = {ord("t"): b"rue", ord("f"): b"alse", ord("n"): b"ull"}


class JsonAutomaton:
    """One request's constrained-decoding state. Immutable transitions
    via advance() mutating internal stack — copy() before speculative
    walks."""

    def __init__(self, object_root: bool = False):
        # stack of (mode, aux); bottom sentinel handles the root value
        self.stack: List[Tuple[str, object]] = [
            (OBJ_KEY_OR_END, None)] if object_root else []
        if object_root:
            self.stack = [(VALUE, "root_obj")]
        else:
            self.stack = [(VALUE, None)]
        self.complete = False

    def copy(self) -> "JsonAutomaton":
        a = JsonAutomaton.__new__(JsonAutomaton)
        a.stack = list(self.stack)
        a.complete = self.complete
        return a

    # -- transitions ---------------------------------------------------

    def advance(self, b: int) -> bool:
        """Consume one byte; False if it is not a legal continuation."""
        if not self.stack:
            # after the root value closed: only trailing whitespace
            return b in WS
        mode, aux = self.stack[-1]

        if mode == STR:
            if b == 0x22:                       # closing quote
                self.stack.pop()
                self._value_done()
                return True
            if b == 0x5C:                       # backslash
                self.stack[-1] = (STR_ESC, aux)
                return True
            return 0x20 <= b <= 0x10FFFF and b != 0x22
        if mode == STR_ESC:
            if b in b'"\\/bfnrt':
                self.stack[-1] = (STR, aux)
                return True
            if b == ord("u"):
                self.stack[-1] = (STR_HEX, 4)
                return True
            return False
        if mode == STR_HEX:
            if b in HEX:
                left = aux - 1
                self.stack[-1] = (STR, None) if left == 0 \
                    else (STR_HEX, left)
                return True
            return False
        if mode == NUM:
            return self._advance_number(b, aux)
        if mode == LIT:
            rest: bytes = aux
            if rest and b == rest[0]:
                if len(rest) == 1:
                    self.stack.pop()
                    self._value_done()
                else:
                    self.stack[-1] = (LIT, rest[1:])
                return True
            return False

        if b in WS:
            return True

        if mode == VALUE:
            root_obj = aux == "root_obj"
            if b == 0x7B:                       # {
                self.stack[-1] = (OBJ_KEY_OR_END, None)
                return True
            if root_obj:
                return False                    # object-rooted mode
            if b == 0x5B:                       # [
                self.stack[-1] = (ARR_VAL_OR_END, None)
                return True
            if b == 0x22:
                self.stack[-1] = (STR, "value")
                return True
            if b in _NUM_START:
                self.stack[-1] = (NUM, "int-first" if b != ord("0")
                                  else "int-zero")
                if b == ord("-"):
                    self.stack[-1] = (NUM, "neg")
                return True
            if b in _LITERALS:
                self.stack[-1] = (LIT, _LITERALS[b])
                return True
            return False
        if mode == OBJ_KEY_OR_END:
            if b == 0x7D:                       # }
                self.stack.pop()
                self._value_done()
                return True
            if b == 0x22:
                self.stack[-1] = (OBJ_COLON, None)
                self.stack.append((STR, "key"))
                return True
            return False
        if mode == OBJ_KEY:
            if b == 0x22:
                self.stack[-1] = (OBJ_COLON, None)
                self.stack.append((STR, "key"))
                return True
            return False
        if mode == OBJ_COLON:
            if b == 0x3A:                       # :
                self.stack[-1] = (OBJ_COMMA_OR_END, None)
                self.stack.append((VALUE, None))
                return True
            return False
        if mode == OBJ_COMMA_OR_END:
            if b == 0x2C:                       # ,
                self.stack[-1] = (OBJ_KEY, None)
                return True
            if b == 0x7D:
                self.stack.pop()
                self._value_done()
                return True
            return False
        if mode == ARR_VAL_OR_END:
            if b == 0x5D:                       # ]
                self.stack.pop()
                self._value_done()
                return True
            self.stack[-1] = (ARR_COMMA_OR_END, None)
            self.stack.append((VALUE, None))
            return self.advance(b)
        if mode == ARR_COMMA_OR_END:
            if b == 0x2C:
                self.stack.append((VALUE, None))
                return True
            if b == 0x5D:
                self.stack.pop()
                self._value_done()
                return True
            return False
        return False

    def _advance_number(self, b: int, sub: str) -> bool:
        def to(new):
            self.stack[-1] = (NUM, new)
            return True

        if sub == "neg":
            if b == ord("0"):
                return to("int-zero")
            if b in DIGITS:
                return to("int-first")
            return False
        if sub in ("int-first", "int"):
            if b in DIGITS:
                return to("int")
            return self._number_tail(b)
        if sub == "int-zero":
            return self._number_tail(b)
        if sub == "frac0":
            return to("frac") if b in DIGITS else False
        if sub == "frac":
            if b in DIGITS:
                return True
            return self._number_tail(b, allow_frac=False)
        if sub == "exp0":
            if b in b"+-":
                return to("exp1")
            return to("exp") if b in DIGITS else False
        if sub == "exp1":
            return to("exp") if b in DIGITS else False
        if sub == "exp":
            return True if b in DIGITS else self._number_end(b)
        return False

    def _number_tail(self, b: int, allow_frac: bool = True) -> bool:
        if allow_frac and b == ord("."):
            self.stack[-1] = (NUM, "frac0")
            return True
        if b in b"eE":
            self.stack[-1] = (NUM, "exp0")
            return True
        return self._number_end(b)

    def _number_end(self, b: int) -> bool:
        # the number is complete; the byte belongs to the ENCLOSING
        # context — pop and re-dispatch
        self.stack.pop()
        self._value_done()
        return self.advance(b)

    def _number_can_end(self) -> bool:
        if not self.stack or self.stack[-1][0] != NUM:
            return False
        return self.stack[-1][1] in ("int", "int-first", "int-zero",
                                     "frac", "exp")

    def _value_done(self):
        if not self.stack:
            self.complete = True

    # -- queries -------------------------------------------------------

    def is_complete(self) -> bool:
        """A full JSON value has been emitted (EOS is legal). Numbers
        complete implicitly: `12` is complete even though `123` could
        continue."""
        if self.complete and (not self.stack):
            return True
        # a bare root number/"value finished" case: stack holds a
        # completable number at the root
        if len(self.stack) == 1 and self._number_can_end():
            return True
        return False

    def accepts(self, data: bytes) -> bool:
        """Would this byte string be a legal continuation? (Pure — works
        on a copy.)"""
        a = self.copy()
        for b in data:
            if not a.advance(b):
                return False
        return True

    def closing_bytes(self) -> frozenset:
        """Bytes on the MINIMAL completion path from this state — the
        close-out mask near the token budget: close strings, close
        containers, finish literals/escapes; open nothing new."""
        if not self.stack:
            return frozenset()
        mode, aux = self.stack[-1]
        if mode == STR:
            return frozenset((0x22,))
        if mode == STR_ESC:
            return frozenset(b'"\\/bfnrt')
        if mode == STR_HEX:
            return frozenset(b"0123456789abcdef")
        if mode == LIT:
            return frozenset((aux[0],))
        if mode == NUM:
            if self._number_can_end():
                # the closer belongs to the enclosing context
                a = self.copy()
                a.stack.pop()
                a._value_done()
                return a.closing_bytes()
            return frozenset(b"0123456789")
        if mode == VALUE:
            return frozenset((0x7B,)) if aux == "root_obj" \
                else frozenset((ord("0"),))
        if mode in (OBJ_KEY_OR_END, OBJ_COMMA_OR_END):
            return frozenset((0x7D,))
        if mode == OBJ_KEY:
            return frozenset((0x22,))
        if mode == OBJ_COLON:
            return frozenset((0x3A,))
        if mode in (ARR_VAL_OR_END, ARR_COMMA_OR_END):
            return frozenset((0x5D,))
        return frozenset()

    def accepts_closing(self, data: bytes) -> bool:
        """Legal continuation where EVERY byte stays on the minimal
        completion path."""
        a = self.copy()
        for b in data:
            if b not in a.closing_bytes() or not a.advance(b):
                return False
        return True

    def closing_distance(self) -> int:
        """Upper bound on bytes needed to complete from here (the
        scheduler's budget margin)."""
        n = 0
        for mode, aux in self.stack:
            if mode in (STR, STR_ESC):
                n += 3
            elif mode == STR_HEX:
                n += 5
            elif mode == LIT:
                n += len(aux) if isinstance(aux, bytes) else 4
            elif mode == VALUE:
                n += 2  # "{}" worst case (object root)
            elif mode == OBJ_COLON:
                n += 2
            else:
                n += 2
        return n

    def signature(self, window: int):
        """Hashable state key for the grammar-mask cache
        (maskcache.GrammarMaskCache). Within one token walk (bounded
        by the tokenizer's max token byte length) each byte pops at
        most two frames (a number ending pops NUM and re-dispatches
        into a container close), so the top `window` frames plus a
        deeper-than-window flag determine acceptance of every token
        exactly — and a deeper stack can never be complete, so the
        EOS bit is exact too. The budget slack is also exact: a token
        walk only touches frames inside the window, so the
        closing-distance delta any token causes is determined by the
        windowed frames alone (the untouched deep suffix contributes
        the same bytes before and after)."""
        deep = len(self.stack) > window
        return ("json", self.complete, deep, tuple(self.stack[-window:]))

    def plain_str_interior(self) -> bool:
        """Inside an unconstrained string: any token made purely of
        printable non-quote non-backslash bytes is legal and leaves
        the state unchanged — the mask compiler's fast path."""
        return bool(self.stack) and self.stack[-1][0] == STR


def _gpt2_uni2byte() -> Dict[str, int]:
    """Inverse of GPT-2's bytes_to_unicode table: the fixed invertible
    byte<->printable-char map every byte-level BPE vocab uses."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


_BYTE_FALLBACK = re.compile(r"<0x([0-9A-Fa-f]{2})>\Z")


def _build_token_table(tok) -> list:
    """Per-token raw BYTE sequences — the mask's source of truth.

    `tok.decode([i])` is NOT it for real BPE vocabs: byte-fallback and
    partial-UTF-8 pieces decode to U+FFFD, making masks approximate
    (round-3 advisor finding). Instead, read the vocab's own byte
    conventions via the underlying HF tokenizer when present:

      * byte-level BPE (GPT-2/Llama-3/Qwen): token chars map through
        the fixed bytes_to_unicode table — exact bytes for every token;
      * SentencePiece: U+2581 is the space marker and `<0xHH>` pieces
        are byte fallback — exact bytes for every piece;
      * anything else falls back to decode(), with tokens that decode
        to U+FFFD banned (b"" never passes the mask) — conservative:
        the constrained output stays valid even if some exotic
        multi-byte content is unreachable.

    Special tokens (BOS/EOS/pad...) get b"" — EOS legality is handled
    explicitly from the automaton's completion state, never via bytes.
    """
    inner = getattr(tok, "_tok", None)  # engine/tokenizer.HFTokenizer
    n = tok.vocab_size
    table: list = []
    uni2byte = _gpt2_uni2byte()
    if inner is not None:
        try:
            specials = set(getattr(inner, "all_special_ids", []) or [])
            toks = inner.convert_ids_to_tokens(list(range(n)))
        except Exception:
            inner, toks, specials = None, None, set()
    if inner is not None and toks is not None:
        # classify the VOCAB once (per-token guessing is ambiguous:
        # "Ã" is byte 0xC3 in a byte-level vocab but the letter A-tilde
        # in a plain one). U+2581 ▁ can NEVER appear in a byte-level
        # token (outside bytes_to_unicode's range) so its presence is
        # decisive for SentencePiece; otherwise Ġ marks byte-level BPE
        sample = [t for t in toks[:50000] if t is not None]
        byte_level = (not any("▁" in t for t in sample)
                      and any("Ġ" in t for t in sample))
        for i, t in enumerate(toks):
            if t is None or i in specials:
                table.append(b"")
                continue
            m = _BYTE_FALLBACK.match(t)
            if m:                       # sentencepiece byte fallback
                table.append(bytes([int(m.group(1), 16)]))
            elif byte_level and all(c in uni2byte for c in t):
                table.append(bytes(uni2byte[c] for c in t))
            elif byte_level:
                table.append(b"")       # malformed for this vocab: ban
            else:                       # sentencepiece/plain text piece
                table.append(t.replace("▁", " ").encode("utf-8"))
        return table
    for i in range(n):
        try:
            s = tok.decode([i])
            table.append(b"" if "�" in s else s.encode("utf-8"))
        except Exception:
            table.append(b"")
    return table


class TokenMasker:
    """Tokenizer-aware token masker over a JsonAutomaton.

    The token->bytes table compiles once per tokenizer into a
    maskcache.CompiledTokenTable (weakref-evicted, so a collected
    tokenizer's reused id() can never alias a stale table) and mask()
    delegates to its prefiltered vectorized walk. cache_key() names
    this automaton state for the scheduler's device-resident mask
    cache when the state is cacheable (no closing/budget pressure).
    """

    def __init__(self, tokenizer, object_root: bool = False,
                 automaton=None):
        self.tok = tokenizer
        # `automaton`: any object with the JsonAutomaton query surface
        # (e.g. schema.SchemaAutomaton for response_format json_schema)
        self.automaton = automaton if automaton is not None \
            else JsonAutomaton(object_root=object_root)
        self.ctab = maskcache.compiled_table(tokenizer)
        self.table = self.ctab.raw
        self.eos_id = getattr(tokenizer, "eos_id", None)

    def copy(self) -> "TokenMasker":
        """Independent masker at the same grammar state — what the
        step planner walks ahead of the committed stream to build a
        chunk's per-iteration mask stack (docs/step-plan.md) without
        disturbing the request's real automaton. Requires the
        underlying automaton to support copy(); maskers wrapping an
        automaton that can't be copied raise AttributeError, and the
        planner falls back to one mask per synchronous step."""
        m = TokenMasker.__new__(TokenMasker)
        m.tok = self.tok
        m.automaton = self.automaton.copy()
        m.ctab = self.ctab
        m.table = self.table
        m.eos_id = self.eos_id
        return m

    def feed(self, token_id: int) -> None:
        """Advance past an emitted token (its bytes were validated by
        the mask, but be tolerant of forced tokens)."""
        for b in self.table[token_id]:
            if not self.automaton.advance(b):
                break

    def mask(self, vocab_size: int, closing: bool = False,
             remaining: Optional[int] = None) -> np.ndarray:
        """Boolean [vocab_size]: which tokens keep the output valid.

        `closing` restricts to the minimal completion path — the
        scheduler sets it when the remaining token budget approaches
        the closing distance, so budget exhaustion cannot strand an
        unterminated string or open container.

        `remaining` (token budget incl. this step) additionally bans
        any token AFTER which the minimal completion would no longer
        fit the budget — without it, a step just above the closing
        threshold can open an optional subtree (an un-required object
        key, a fresh array) whose completion cost overshoots the
        budget before the closing switch can re-engage. Distances are
        in bytes; every token covers >= 1 byte, so bytes upper-bound
        tokens (conservative)."""
        budget = None if remaining is None else remaining - 1
        return self.ctab.mask_bits(self.automaton, self.eos_id,
                                   vocab_size, closing=closing,
                                   budget=budget)

    def cache_window(self) -> int:
        """Signature window in stack frames: generous multiple of the
        max token byte length (see JsonAutomaton.signature — <= 2
        pops per byte make 2L+2 exact; 4L+8 leaves margin for
        automatons with deeper redispatch chains)."""
        return 4 * max(self.ctab.max_len, 1) + 8

    def cache_key(self):
        """Hashable key naming this state's BUDGET-FREE mask, or None
        when the state is uncacheable (automaton without a signature,
        or a signature that declines — e.g. a schema NFA with too
        many threads). Whether a cached mask may serve a
        budget-limited position is decided per use from the entry's
        recorded slack (see GrammarMaskCache), not baked into the
        key. Keys hold the compiled table and any schema nodes by
        strong reference, so a cached row can never alias a recycled
        id()."""
        sig_fn = getattr(self.automaton, "signature", None)
        if sig_fn is None:
            return None
        sig = sig_fn(self.cache_window())
        if sig is None:
            return None
        return (self.ctab, self.eos_id, sig)

    def mask_with_slack(self, vocab_size: int):
        """(budget-free mask, budget slack) — the cacheable artifact.
        Slack is the worst closing-distance growth over any accepted
        token; `remaining - 1 >= closing_distance() + slack` proves
        the budgeted mask identical to this one."""
        return self.ctab.mask_bits(self.automaton, self.eos_id,
                                   vocab_size, with_slack=True)

    def closing_distance(self) -> int:
        return self.automaton.closing_distance()

    def done(self) -> bool:
        return self.automaton.is_complete()
