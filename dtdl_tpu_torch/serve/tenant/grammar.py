"""Grammar-constrained decoding: regex / JSON-schema -> token-level DFA,
the port's own copy of dtdl_tpu/serve/tenant/grammar.py (framework-free:
host numpy tables, the same compiler and the same errors).

The compiler runs entirely on the host and entirely ahead of time: a
regex (or a JSON schema lowered to one) is parsed to a Thompson NFA,
determinized over the characters that actually occur in the token
vocabulary, pruned to coaccessible states, and finally *lifted* to the
token level by walking every token's string from every DFA state.  The
result is two dense tables:

``trans[n_states, V]``
    next DFA state after emitting token ``t`` from state ``q``
    (``-1`` = illegal / dead).
``allow[n_states, V]``
    boolean mask, ``trans >= 0`` plus an EOS column that is legal
    exactly in accepting states.

At serve time the scheduler keeps one ``int`` of automaton state per
slot and advances it at the lag-harvest boundary; the only thing that
ever reaches the device is a row of ``allow``, packed into uint32
words (``sampling.pack_mask``) and folded into the sampler as a
per-slot mask before the argmax and the top-k/top-p truncation.  The
automaton itself never runs on the card, so constrained requests ride
the same decode, verify and prefill steps as everyone else.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TokenDFA",
    "compile_regex",
    "compile_json_schema",
    "json_schema_to_regex",
    "byte_vocab",
]


# ---------------------------------------------------------------------------
# regex -> NFA (Thompson construction)
# ---------------------------------------------------------------------------
# Supported syntax: literals, escapes (\d \w \s \n \t \r \\ and any
# escaped punctuation), character classes with ranges and negation,
# '.', '*', '+', '?', '|', grouping parens.  Counted repetition {m,n}
# is intentionally not supported — expand it at schema-lowering time.

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")

# A charset is (negated: bool, chars: frozenset[str]).
_ANY = (True, frozenset())


class _Nfa:
    """Mutable NFA under construction: integer states, eps + char edges."""

    def __init__(self) -> None:
        self.eps: List[set] = []
        self.edges: List[List[Tuple[Tuple[bool, frozenset], int]]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1


class _Parser:
    def __init__(self, pattern: str) -> None:
        self.pat = pattern
        self.i = 0
        self.nfa = _Nfa()

    # -- fragment constructors (start, end), single end state ----------
    def _char(self, cs) -> Tuple[int, int]:
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.edges[s].append((cs, e))
        return s, e

    def _eps_frag(self) -> Tuple[int, int]:
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].add(e)
        return s, e

    def _concat(self, a, b):
        self.nfa.eps[a[1]].add(b[0])
        return a[0], b[1]

    def _alt(self, a, b):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].update((a[0], b[0]))
        self.nfa.eps[a[1]].add(e)
        self.nfa.eps[b[1]].add(e)
        return s, e

    def _star(self, a):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].update((a[0], e))
        self.nfa.eps[a[1]].update((a[0], e))
        return s, e

    def _plus(self, a):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].add(a[0])
        self.nfa.eps[a[1]].update((a[0], e))
        return s, e

    def _opt(self, a):
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.eps[s].update((a[0], e))
        self.nfa.eps[a[1]].add(e)
        return s, e

    # -- recursive descent --------------------------------------------
    def _peek(self) -> Optional[str]:
        return self.pat[self.i] if self.i < len(self.pat) else None

    def _take(self) -> str:
        c = self.pat[self.i]
        self.i += 1
        return c

    def _escape_set(self, c: str):
        if c == "d":
            return (False, _DIGITS)
        if c == "w":
            return (False, _WORD)
        if c == "s":
            return (False, _SPACE)
        if c == "D":
            return (True, _DIGITS)
        if c == "W":
            return (True, _WORD)
        if c == "S":
            return (True, _SPACE)
        if c == "n":
            return (False, frozenset("\n"))
        if c == "t":
            return (False, frozenset("\t"))
        if c == "r":
            return (False, frozenset("\r"))
        return (False, frozenset(c))

    def _class(self):
        negated = False
        if self._peek() == "^":
            self._take()
            negated = True
        chars: set = set()
        while True:
            c = self._peek()
            if c is None:
                raise ValueError(f"unterminated class in {self.pat!r}")
            if c == "]":
                self._take()
                break
            self._take()
            if c == "\\":
                neg, cs = self._escape_set(self._take())
                if neg:
                    raise ValueError("negated escape inside class")
                chars |= cs
                continue
            if self._peek() == "-" and self.i + 1 < len(self.pat) \
                    and self.pat[self.i + 1] != "]":
                self._take()
                hi = self._take()
                if hi == "\\":
                    hi = self._take()
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        return (negated, frozenset(chars))

    def _atom(self):
        c = self._take()
        if c == "(":
            frag = self._alternation()
            if self._peek() != ")":
                raise ValueError(f"unbalanced '(' in {self.pat!r}")
            self._take()
            return frag
        if c == "[":
            return self._char(self._class())
        if c == ".":
            return self._char(_ANY)
        if c == "\\":
            return self._char(self._escape_set(self._take()))
        if c in ")|*+?":
            raise ValueError(f"unexpected {c!r} at {self.i - 1} "
                             f"in {self.pat!r}")
        if c == "{":
            raise ValueError("counted repetition {m,n} is not supported; "
                             "expand it when lowering the schema")
        return self._char((False, frozenset(c)))

    def _repeat(self):
        frag = self._atom()
        while self._peek() in ("*", "+", "?"):
            op = self._take()
            frag = {"*": self._star, "+": self._plus,
                    "?": self._opt}[op](frag)
        return frag

    def _concat_seq(self):
        frag = None
        while self._peek() is not None and self._peek() not in ")|":
            nxt = self._repeat()
            frag = nxt if frag is None else self._concat(frag, nxt)
        return frag if frag is not None else self._eps_frag()

    def _alternation(self):
        frag = self._concat_seq()
        while self._peek() == "|":
            self._take()
            frag = self._alt(frag, self._concat_seq())
        return frag

    def parse(self) -> Tuple[_Nfa, int, int]:
        frag = self._alternation()
        if self.i != len(self.pat):
            raise ValueError(f"trailing {self.pat[self.i:]!r} "
                             f"in {self.pat!r}")
        return self.nfa, frag[0], frag[1]


# ---------------------------------------------------------------------------
# NFA -> char DFA (subset construction over the vocab alphabet)
# ---------------------------------------------------------------------------

def _eps_closure(nfa: _Nfa, states: frozenset) -> frozenset:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _matches(cs: Tuple[bool, frozenset], c: str) -> bool:
    negated, chars = cs
    return (c in chars) != negated


def _determinize(nfa: _Nfa, start: int, accept: int,
                 alphabet: Sequence[str]):
    """Subset construction restricted to the chars the vocab can emit."""
    s0 = _eps_closure(nfa, frozenset((start,)))
    ids: Dict[frozenset, int] = {s0: 0}
    order = [s0]
    trans: List[Dict[str, int]] = [{}]
    i = 0
    while i < len(order):
        cur = order[i]
        for c in alphabet:
            nxt = set()
            for s in cur:
                for cs, dst in nfa.edges[s]:
                    if _matches(cs, c):
                        nxt.add(dst)
            if not nxt:
                continue
            closed = _eps_closure(nfa, frozenset(nxt))
            if closed not in ids:
                ids[closed] = len(order)
                order.append(closed)
                trans.append({})
            trans[i][c] = ids[closed]
        i += 1
    accepting = [accept in st for st in order]
    return trans, accepting


def _prune(trans: List[Dict[str, int]], accepting: List[bool]):
    """Drop states from which no accepting state is reachable, so that
    a token leading into a doomed corridor is masked *now*, not after
    the request has painted itself into a corner."""
    n = len(trans)
    rev: List[set] = [set() for _ in range(n)]
    for q, row in enumerate(trans):
        for dst in row.values():
            rev[dst].add(q)
    live = {q for q in range(n) if accepting[q]}
    stack = list(live)
    while stack:
        q = stack.pop()
        for p in rev[q]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise ValueError("pattern matches nothing over this vocabulary")
    remap = {q: i for i, q in enumerate(sorted(live))}
    new_trans = [{c: remap[d] for c, d in trans[q].items() if d in live}
                 for q in sorted(live)]
    new_acc = [accepting[q] for q in sorted(live)]
    return new_trans, new_acc


# ---------------------------------------------------------------------------
# char DFA -> token DFA
# ---------------------------------------------------------------------------

class TokenDFA:
    """Token-level automaton: dense host tables, one int of state.

    ``trans``  int32 ``[n_states, V]`` — next state, ``-1`` illegal.
    ``allow``  bool  ``[n_states, V]`` — ``trans >= 0``, with the EOS
    column legal exactly in accepting states (EOS keeps the state).
    """

    __slots__ = ("n_states", "start", "accept", "trans", "allow",
                 "eos_id", "pattern")

    def __init__(self, trans: np.ndarray, accept: np.ndarray,
                 eos_id: int, pattern: str) -> None:
        self.trans = trans
        self.accept = accept
        self.n_states = int(trans.shape[0])
        self.start = 0
        self.eos_id = int(eos_id)
        self.pattern = pattern
        allow = trans >= 0
        allow[:, self.eos_id] = accept
        self.allow = allow

    def step(self, state: int, token: int) -> int:
        """Advance by one emitted token; ``-1`` means the token was
        illegal in ``state`` (a grammar violation)."""
        if token == self.eos_id:
            return state if self.accept[state] else -1
        return int(self.trans[state, token])

    def walk(self, tokens: Sequence[int], state: Optional[int] = None) -> int:
        """Advance over a token sequence; stops at ``-1``."""
        q = self.start if state is None else state
        for t in tokens:
            q = self.step(q, int(t))
            if q < 0:
                return -1
        return q

    def mask(self, state: int) -> np.ndarray:
        """Boolean ``[V]`` row of legal next tokens from ``state``."""
        return self.allow[state]

    def nbytes(self) -> int:
        return int(self.trans.nbytes + self.allow.nbytes)


def _lift(trans: List[Dict[str, int]], accepting: List[bool],
          vocab: Sequence[str], eos_id: int, pattern: str) -> TokenDFA:
    n, V = len(trans), len(vocab)
    tt = np.full((n, V), -1, dtype=np.int32)
    for t, s in enumerate(vocab):
        if t == eos_id or not s:
            continue  # empty tokens would stall the automaton
        for q in range(n):
            cur = q
            for c in s:
                cur = trans[cur].get(c, -1)
                if cur < 0:
                    break
            tt[q, t] = cur
    return TokenDFA(tt, np.asarray(accepting, dtype=bool), eos_id, pattern)


def compile_regex(pattern: str, vocab: Sequence[str],
                  eos_id: int) -> TokenDFA:
    """Compile ``pattern`` to a :class:`TokenDFA` over ``vocab`` (a
    sequence of token strings indexed by token id)."""
    nfa, start, accept = _Parser(pattern).parse()
    alphabet = sorted({c for i, s in enumerate(vocab)
                       if i != eos_id for c in s})
    ctrans, cacc = _determinize(nfa, start, accept, alphabet)
    ctrans, cacc = _prune(ctrans, cacc)
    return _lift(ctrans, cacc, vocab, eos_id, pattern)


def byte_vocab(vocab_size: int) -> List[str]:
    """The degenerate tokenizer used by the examples and tests: token
    id ``i`` is the single character ``chr(i)``."""
    return [chr(i) for i in range(vocab_size)]


# ---------------------------------------------------------------------------
# JSON schema -> regex (a deliberately small subset)
# ---------------------------------------------------------------------------

_ESCAPE = set("\\()[]{}|*+?.^$-")


def _rx_lit(s: str) -> str:
    return "".join("\\" + c if c in _ESCAPE else c for c in s)


def json_schema_to_regex(schema: dict) -> str:
    """Lower a JSON-schema subset to a regex: string / integer /
    number / boolean / null / enum / fixed-order object / array.
    Objects emit every listed property in listing order with no
    whitespace — the strictest (and cheapest) reading of the schema."""
    if "enum" in schema:
        alts = "|".join(_rx_lit(json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"])
        return f"({alts})"
    ty = schema.get("type")
    if ty == "string":
        return '"[^"]*"'
    if ty == "integer":
        return "(0|-?[1-9][0-9]*)"
    if ty == "number":
        return "(0|-?[1-9][0-9]*)(\\.[0-9]+)?"
    if ty == "boolean":
        return "(true|false)"
    if ty == "null":
        return "null"
    if ty == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "null"}))
        return f"(\\[\\]|\\[{item}(,{item})*\\])"
    if ty == "object":
        props = schema.get("properties", {})
        body = ",".join(
            _rx_lit(json.dumps(k) + ":") + json_schema_to_regex(sub)
            for k, sub in props.items())
        return "\\{" + body + "\\}"
    raise ValueError(f"unsupported schema: {schema!r}")


def compile_json_schema(schema: dict, vocab: Sequence[str],
                        eos_id: int) -> TokenDFA:
    return compile_regex(json_schema_to_regex(schema), vocab, eos_id)
