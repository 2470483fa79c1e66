"""Regex -> byte NFA for JSON-Schema `pattern` constrained decoding.

Copied from ome_tpu/engine/repattern.py (it imports no jax), code
unchanged: the port keeps its own copy, as it imports nothing of the
JAX package.

The reference gets `pattern` support from xgrammar's regex->grammar
compiler inside its SGLang runtime images (SURVEY.md L0, the
`--grammar-backend` flag of its runtime configs); here a small
Thompson-construction NFA walks byte sets so the schema automaton
(engine/schema.py) can mask tokens byte-by-byte AND steer a minimal
close-out path (shortest distance-to-accept is precomputed per state,
so `closing_bytes` always has a byte that strictly decreases it).

Scope (SchemaError beyond it, so the API 400s instead of silently
under-constraining): literals, '.', character classes incl. ranges and
negation, \\d \\w \\s (+ complements), escapes, grouping, alternation,
'*' '+' '?' '{m}' '{m,}' '{m,n}', anchors '^'/'$' at the ends.
Per JSON-Schema semantics an unanchored pattern is a substring match:
missing '^'/'$' get an implicit '.*' on that side.

The byte universe is printable ASCII minus '"' and '\\' (bytes that
would need JSON escaping inside a string literal) — the automaton
never emits escapes inside pattern-constrained strings, which narrows
the emittable language but never widens it.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple


class PatternError(ValueError):
    """Pattern uses syntax this compiler does not support."""


# emittable bytes inside a JSON string without escaping
_UNIVERSE = frozenset(range(0x20, 0x7F)) - frozenset((0x22, 0x5C))
_DIGITS = frozenset(b"0123456789")
_WORD = frozenset(b"abcdefghijklmnopqrstuvwxyz"
                  b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(b" \t\n\r\f\v") & _UNIVERSE  # -> {space}

_MAX_REPEAT = 64
_MAX_STATES = 4096

# AST: ("cls", frozenset) | ("seq", [ast]) | ("alt", [ast])
#    | ("rep", ast, min, max|None)


def _class_escape(c: str) -> Optional[FrozenSet[int]]:
    return {"d": _DIGITS, "D": _UNIVERSE - _DIGITS, "w": _WORD,
            "W": _UNIVERSE - _WORD, "s": _SPACE,
            "S": _UNIVERSE - _SPACE}.get(c)


class _Parser:
    def __init__(self, pat: str):
        self.pat = pat
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.pat[self.i] if self.i < len(self.pat) else None

    def take(self) -> str:
        c = self.pat[self.i]
        self.i += 1
        return c

    def parse(self):
        ast = self.alt()
        if self.i != len(self.pat):
            raise PatternError(f"unexpected {self.pat[self.i]!r} at "
                               f"{self.i}")
        return ast

    def alt(self):
        branches = [self.seq()]
        while self.peek() == "|":
            self.take()
            branches.append(self.seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def seq(self):
        items = []
        while self.peek() not in (None, "|", ")"):
            items.append(self.rep())
        return ("seq", items)

    def rep(self):
        a = self.atom()
        c = self.peek()
        if c == "*":
            self.take()
            return ("rep", a, 0, None)
        if c == "+":
            self.take()
            return ("rep", a, 1, None)
        if c == "?":
            self.take()
            return ("rep", a, 0, 1)
        if c == "{":
            return self.counted(a)
        return a

    def counted(self, a):
        self.take()  # {
        lo = self.int_until(",}")
        if self.peek() is None:
            raise PatternError("unterminated {m,n} quantifier")
        c = self.take()
        if c == "}":
            hi: Optional[int] = lo
        else:
            if self.peek() == "}":
                self.take()
                hi = None
            else:
                hi = self.int_until("}")
                if self.peek() is None:
                    raise PatternError("unterminated {m,n} quantifier")
                self.take()
        if lo > _MAX_REPEAT or (hi or 0) > _MAX_REPEAT:
            raise PatternError(f"repeat bound > {_MAX_REPEAT}")
        if hi is not None and hi < lo:
            raise PatternError("bad repeat {m,n} with n < m")
        return ("rep", a, lo, hi)

    def int_until(self, stops: str) -> int:
        s = ""
        while self.peek() is not None and self.peek() not in stops:
            s += self.take()
        if not s.isdigit():
            raise PatternError("bad {m,n} bound")
        return int(s)

    def atom(self):
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                if self.peek() != ":":
                    raise PatternError("only (?:...) groups supported")
                self.take()
            inner = self.alt()
            if self.peek() != ")":
                raise PatternError("unbalanced group")
            self.take()
            return inner
        if c == ".":
            return ("cls", _UNIVERSE)
        if c == "[":
            return self.char_class()
        if c == "\\":
            return ("cls", self.escape())
        if c in "^$":
            raise PatternError("anchors only at the pattern ends")
        if c in "*+?{":
            raise PatternError(f"dangling quantifier {c!r}")
        return ("cls", self._lit(c))

    @staticmethod
    def _lit(c: str) -> FrozenSet[int]:
        b = ord(c)
        if b not in _UNIVERSE:
            raise PatternError(
                f"pattern character {c!r} cannot appear unescaped in a "
                f"JSON string")
        return frozenset((b,))

    def escape(self) -> FrozenSet[int]:
        if self.peek() is None:
            raise PatternError("trailing backslash")
        c = self.take()
        cls = _class_escape(c)
        if cls is not None:
            return cls
        mapped = {"n": "\n", "t": "\t", "r": "\r"}.get(c, c)
        b = ord(mapped)
        if b not in _UNIVERSE:
            raise PatternError(
                f"escape \\{c} maps outside the emittable JSON-string "
                f"byte range")
        return frozenset((b,))

    def char_class(self):
        neg = False
        if self.peek() == "^":
            self.take()
            neg = True
        out: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise PatternError("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            c = self.take()
            if c == "\\":
                cls = self.escape()
                out |= cls
                continue
            lo = ord(c)
            if self.peek() == "-" and self.pat[self.i + 1: self.i + 2] \
                    not in ("]", ""):
                self.take()
                hi_c = self.take()
                if hi_c == "\\":
                    raise PatternError("escape as range endpoint")
                hi = ord(hi_c)
                if hi < lo:
                    raise PatternError("reversed class range")
                out |= set(range(lo, hi + 1))
            else:
                out.add(lo)
        cls = frozenset(out) & _UNIVERSE if not neg \
            else _UNIVERSE - frozenset(out)
        if not cls:
            raise PatternError("character class matches no emittable "
                               "byte")
        return ("cls", cls)


def _toplevel_alternation(pat: str) -> bool:
    """True when an unescaped '|' sits at group-depth 0 outside a
    character class."""
    depth = 0
    in_class = False
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "\\":
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
        elif c == "[":
            in_class = True
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == "|" and depth == 0:
            return True
        i += 1
    return False


class Regex:
    """Compiled byte NFA with per-state shortest-distance-to-accept.

    States are ints; `advance` works on frozensets of states (the
    standard subset walk). min_dist/closing_byte drive the schema
    automaton's greedy close-out.
    """

    def __init__(self, pattern: str):
        self.pattern = pattern
        pat = pattern
        anchored_l = pat.startswith("^")
        anchored_r = pat.endswith("$") and not pat.endswith("\\$")
        if (anchored_l or anchored_r) and _toplevel_alternation(pat):
            # '^a|b$' means (^a)|(b$) under regex precedence; stripping
            # the anchors here would silently compile '^(a|b)$' — a
            # narrower language. Refuse instead of under-serving.
            raise PatternError(
                "anchors with a top-level alternation are ambiguous; "
                "group the alternation: ^(?:a|b)$")
        if anchored_l:
            pat = pat[1:]
        if anchored_r:
            pat = pat[:-1]
        ast = _Parser(pat).parse()  # parser rejects interior anchors
        if not anchored_l:
            ast = ("seq", [("rep", ("cls", _UNIVERSE), 0, None), ast])
        if not anchored_r:
            ast = ("seq", [ast, ("rep", ("cls", _UNIVERSE), 0, None)])

        # Thompson construction
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[FrozenSet[int], int]]] = []
        start = self._state()
        accept = self._build(ast, start)
        self.accept = accept
        self._closure_memo: Dict[FrozenSet[int], FrozenSet[int]] = {}
        self.dist = self._distances()
        if self.dist[start] >= _MAX_STATES * 2:
            raise PatternError("pattern matches no string")
        self.start_set = self._closure(frozenset((start,)))

    def _state(self) -> int:
        if len(self.eps) >= _MAX_STATES:
            raise PatternError("pattern too large")
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def _build(self, ast, entry: int) -> int:
        """Wire ast from `entry`, return its exit state."""
        kind = ast[0]
        if kind == "cls":
            out = self._state()
            self.trans[entry].append((ast[1], out))
            return out
        if kind == "seq":
            cur = entry
            for item in ast[1]:
                cur = self._build(item, cur)
            return cur
        if kind == "alt":
            out = self._state()
            for br in ast[1]:
                b_in = self._state()
                self.eps[entry].append(b_in)
                self.eps[self._build(br, b_in)].append(out)
            return out
        if kind == "rep":
            _, sub, lo, hi = ast
            cur = entry
            for _ in range(lo):
                cur = self._build(sub, cur)
            if hi is None:  # star tail: loop on a fresh state
                loop = self._state()
                self.eps[cur].append(loop)
                self.eps[self._build(sub, loop)].append(loop)
                return loop
            for _ in range(hi - lo):
                nxt = self._build(sub, cur)
                self.eps[cur].append(nxt)  # skip edge
                cur = nxt
            return cur
        raise AssertionError(kind)

    def _closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        memo = self._closure_memo.get(states)
        if memo is not None:
            return memo
        seen = set(states)
        todo = list(states)
        while todo:
            s = todo.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        out = frozenset(seen)
        self._closure_memo[states] = out
        return out

    def _distances(self) -> List[int]:
        """Shortest #bytes from each state to accept (eps edges free):
        0-1 BFS on the reversed graph."""
        import collections
        INF = _MAX_STATES * 4
        n = len(self.eps)
        radj_e: List[List[int]] = [[] for _ in range(n)]
        radj_b: List[List[int]] = [[] for _ in range(n)]
        for s in range(n):
            for t in self.eps[s]:
                radj_e[t].append(s)
            for _, t in self.trans[s]:
                radj_b[t].append(s)
        dist = [INF] * n
        dist[self.accept] = 0
        dq = collections.deque([self.accept])
        while dq:
            s = dq.popleft()
            for p in radj_e[s]:
                if dist[s] < dist[p]:
                    dist[p] = dist[s]
                    dq.appendleft(p)
            for p in radj_b[s]:
                if dist[s] + 1 < dist[p]:
                    dist[p] = dist[s] + 1
                    dq.append(p)
        return dist

    # -- the walk interface used by schema.SchemaAutomaton -------------

    def advance(self, states: FrozenSet[int],
                b: int) -> FrozenSet[int]:
        nxt = set()
        for s in states:
            for cls, t in self.trans[s]:
                if b in cls:
                    nxt.add(t)
        return self._closure(frozenset(nxt)) if nxt else frozenset()

    def accepting(self, states: FrozenSet[int]) -> bool:
        return self.accept in states

    def min_dist(self, states: FrozenSet[int]) -> int:
        return min((self.dist[s] for s in states),
                   default=_MAX_STATES * 4)

    def closing_byte(self, states: FrozenSet[int]) -> int:
        """A byte that strictly decreases min_dist (exists whenever
        min_dist > 0 and finite)."""
        target = self.min_dist(states) - 1
        best = None
        for s in states:
            for cls, t in self.trans[s]:
                if self.dist[t] <= target:
                    cand = min(cls)
                    if best is None or cand < best:
                        best = cand
        if best is None:
            raise AssertionError("no closing byte (pattern dead end)")
        return best
