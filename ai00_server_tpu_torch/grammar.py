"""KBNF grammar engine: byte-level Earley recognizer + vocab-trie masking.

Port of ``ai00_server_tpu/grammar.py`` (numpy only; this package's own
copy).  It provides the capability the reference server gets from the
``kbnf`` crate (crates/ai00-core/src/sampler/bnf.rs): compile a KBNF
grammar, then per decode step compute the set of vocabulary tokens whose
bytes keep the output inside the grammar.

Supported KBNF subset (covers formatron/json2kbnf output and the docs'
examples):

* ``name ::= expression ;`` rules; alternation ``|``; grouping ``( )``;
  postfix ``?``, ``*``, ``+``.
* String terminals ``'...'`` / ``"..."`` with escapes
  (``\\n \\t \\r \\\\ \\' \\" \\u{HEX}``), matched as UTF-8 bytes.
* Regex terminals ``#'...'`` / ``#"..."``: char classes ``[...]`` (ranges,
  negation), ``.``, escapes ``\\d \\w \\s``, alternation, grouping and the
  postfix operators; compiled to byte-class NFAs and inlined as rules.

Design: the grammar is lowered so every terminal is a 256-bit *byte
class*; recognition is a standard Earley chart over the generated byte
stream.  The per-step token mask walks the tokenizer's byte trie in DFS,
extending the chart speculatively and pruning on empty item sets.  This
Python engine is the plain version of the C++ one (``native.py``), which
serves non-regular grammars; regular grammars compile to a byte DFA
(``make_dfa_engine``) and to the device token DFA (``token_dfa_table``).

One divergence from the JAX package: ``token_dfa_table`` refuses a table
taller than 128 rows (``max_states + 1 > 128``), whose state ids an int8
entry cannot hold; the JAX package builds it and the ids wrap.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

ANY_BYTE = (1 << 256) - 1


def _bc_single(b: int) -> int:
    return 1 << b


def _bc_range(lo: int, hi: int) -> int:
    return ((1 << (hi + 1)) - 1) ^ ((1 << lo) - 1)


_D = 0
for _c in b"0123456789":
    _D |= _bc_single(_c)
_W = 0
for _c in b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_":
    _W |= _bc_single(_c)
_S = 0
for _c in b" \t\n\r\f\v":
    _S |= _bc_single(_c)


# ---------------------------------------------------------------------------
# Grammar parsing
# ---------------------------------------------------------------------------

# Symbols: ("nt", name) or ("bc", bitmask)


class GrammarError(ValueError):
    pass


class _Parser:
    """Recursive-descent parser for the KBNF subset."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.rules: dict[str, list[list[tuple]]] = {}
        self._gensym = itertools.count()

    def fresh(self, hint="g") -> str:
        return f"__{hint}{next(self._gensym)}"

    def error(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        raise GrammarError(f"grammar parse error at line {line}: {msg}")

    def skip_ws(self):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif self.text.startswith("//", self.pos):
                nl = self.text.find("\n", self.pos)
                self.pos = len(self.text) if nl == -1 else nl + 1
            elif self.text.startswith("/*", self.pos):
                end = self.text.find("*/", self.pos + 2)
                if end == -1:
                    self.error("unterminated block comment")
                self.pos = end + 2
            else:
                return

    def parse(self) -> dict:
        while True:
            self.skip_ws()
            if self.pos >= len(self.text):
                break
            name = self.ident()
            self.skip_ws()
            if not self.text.startswith("::=", self.pos):
                self.error(f"expected '::=' after rule name {name!r}")
            self.pos += 3
            alts = self.expr()
            self.skip_ws()
            if self.pos < len(self.text) and self.text[self.pos] == ";":
                self.pos += 1
            self.rules.setdefault(name, []).extend(alts)
        return self.rules

    def ident(self) -> str:
        self.skip_ws()
        start = self.pos
        while self.pos < len(self.text) and (
                self.text[self.pos].isalnum() or self.text[self.pos] in "_"):
            self.pos += 1
        if start == self.pos:
            self.error("expected identifier")
        return self.text[start: self.pos]

    def expr(self) -> list[list[tuple]]:
        alts = [self.seq()]
        while True:
            self.skip_ws()
            if self.pos < len(self.text) and self.text[self.pos] == "|":
                self.pos += 1
                alts.append(self.seq())
            else:
                return alts

    def seq(self) -> list[tuple]:
        out: list[tuple] = []
        while True:
            self.skip_ws()
            if self.pos >= len(self.text) or self.text[self.pos] in "|);":
                return out
            out.extend(self.term())

    def term(self) -> list[tuple]:
        # Repetitions lower LEFT-recursively (R ::= R x | ...): the loop's
        # Earley items then keep a FIXED origin across iterations, which
        # keeps the engine state canonical form stable inside long
        # repeated content — that is what makes the native engine's
        # per-state token-mask cache hit (see native/grammar_engine.cpp).
        base = self.atom()
        while self.pos < len(self.text) and self.text[self.pos] in "?*+":
            op = self.text[self.pos]
            self.pos += 1
            nt = self.fresh("rep")
            if op == "?":
                self.rules[nt] = [list(base), []]
            elif op == "*":
                self.rules[nt] = [[("nt", nt)] + list(base), []]
            else:  # +
                self.rules[nt] = [[("nt", nt)] + list(base), list(base)]
            base = [("nt", nt)]
        return base

    def atom(self) -> list[tuple]:
        self.skip_ws()
        c = self.text[self.pos]
        if c == "(":
            self.pos += 1
            alts = self.expr()
            self.skip_ws()
            if self.pos >= len(self.text) or self.text[self.pos] != ")":
                self.error("expected ')'")
            self.pos += 1
            nt = self.fresh("grp")
            self.rules[nt] = alts
            return [("nt", nt)]
        if c == "#":
            self.pos += 1
            if self.pos < len(self.text) and self.text[self.pos] in "e":
                self.pos += 1  # kbnf '#e"..."' (early-stop regex): treat same
            if self.pos >= len(self.text) or self.text[self.pos] not in "'\"":
                self.error("expected quote after '#'")
            pattern = self.string_literal(raw=True)
            nt = self.fresh("re")
            _RegexCompiler(self, nt).compile(pattern)
            return [("nt", nt)]
        if c in "'\"":
            s = self.string_literal()
            return [("bc", _bc_single(b)) for b in s]
        return [("nt", self.ident())]

    def string_literal(self, raw: bool = False) -> bytes | str:
        quote = self.text[self.pos]
        self.pos += 1
        out: list[str] = []
        while True:
            if self.pos >= len(self.text):
                self.error("unterminated string")
            c = self.text[self.pos]
            if c == quote:
                self.pos += 1
                break
            if c == "\\" and not raw:
                self.pos += 1
                e = self.text[self.pos]
                self.pos += 1
                if e == "n":
                    out.append("\n")
                elif e == "t":
                    out.append("\t")
                elif e == "r":
                    out.append("\r")
                elif e == "0":
                    out.append("\0")
                elif e == "u" and self.text[self.pos] == "{":
                    end = self.text.find("}", self.pos)
                    out.append(chr(int(self.text[self.pos + 1: end], 16)))
                    self.pos = end + 1
                else:
                    out.append(e)
            elif c == "\\" and raw:
                out.append(c)
                self.pos += 1
                out.append(self.text[self.pos])
                self.pos += 1
            else:
                out.append(c)
                self.pos += 1
        s = "".join(out)
        return s if raw else s.encode("utf-8")


class _RegexCompiler:
    """Tiny byte-level regex -> right-linear grammar rules.

    Supports: literal chars (UTF-8 bytes), ``[...]`` classes with ranges
    and ``^`` negation, ``.``, ``\\d \\w \\s \\D \\W \\S``, ``|``, ``( )``,
    postfix ``? * +``.  Anchors are implicit (whole-match).
    """

    def __init__(self, parser: _Parser, target_nt: str):
        self.p = parser
        self.target = target_nt

    def compile(self, pattern: str) -> None:
        self.s = pattern
        self.i = 0
        alts = self._alts()
        if self.i != len(self.s):
            raise GrammarError(f"regex parse error in {pattern!r}")
        self.p.rules[self.target] = alts

    def _alts(self):
        alts = [self._seq()]
        while self.i < len(self.s) and self.s[self.i] == "|":
            self.i += 1
            alts.append(self._seq())
        return alts

    def _seq(self):
        out = []
        while self.i < len(self.s) and self.s[self.i] not in "|)":
            out.extend(self._term())
        return out

    def _term(self):
        base = self._atom()
        while self.i < len(self.s) and self.s[self.i] in "?*+{":
            op = self.s[self.i]
            if op == "{":
                end = self.s.find("}", self.i)
                if end == -1:
                    raise GrammarError("unterminated {m,n}")
                spec = self.s[self.i + 1: end]
                self.i = end + 1
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(spec)
                out = []
                for _ in range(lo):
                    out.extend(base)
                if hi is None:
                    nt = self.p.fresh("re")
                    self.p.rules[nt] = [[("nt", nt)] + list(base), []]
                    out.append(("nt", nt))
                else:
                    for _ in range(hi - lo):
                        nt = self.p.fresh("re")
                        self.p.rules[nt] = [list(base), []]
                        out.append(("nt", nt))
                base = out
                continue
            self.i += 1
            nt = self.p.fresh("re")
            # Left-recursive repetitions: see _Parser.term.
            if op == "?":
                self.p.rules[nt] = [list(base), []]
            elif op == "*":
                self.p.rules[nt] = [[("nt", nt)] + list(base), []]
            else:
                self.p.rules[nt] = [[("nt", nt)] + list(base), list(base)]
            base = [("nt", nt)]
        return base

    def _atom(self):
        c = self.s[self.i]
        if c == "(":
            self.i += 1
            if self.s.startswith("?:", self.i):
                self.i += 2
            alts = self._alts()
            if self.i >= len(self.s) or self.s[self.i] != ")":
                raise GrammarError("expected ')' in regex")
            self.i += 1
            nt = self.p.fresh("re")
            self.p.rules[nt] = alts
            return [("nt", nt)]
        if c == "[":
            return [("bc", self._char_class())]
        if c == ".":
            self.i += 1
            return [("bc", ANY_BYTE ^ _bc_single(0x0A))]
        if c == "\\":
            self.i += 1
            return [("bc", self._escape_class())]
        self.i += 1
        return [("bc", _bc_single(b)) for b in c.encode("utf-8")]

    def _escape_class(self) -> int:
        e = self.s[self.i]
        self.i += 1
        if e == "d":
            return _D
        if e == "D":
            return ANY_BYTE ^ _D
        if e == "w":
            return _W
        if e == "W":
            return ANY_BYTE ^ _W
        if e == "s":
            return _S
        if e == "S":
            return ANY_BYTE ^ _S
        if e == "n":
            return _bc_single(0x0A)
        if e == "t":
            return _bc_single(0x09)
        if e == "r":
            return _bc_single(0x0D)
        if e == "x":
            v = int(self.s[self.i: self.i + 2], 16)
            self.i += 2
            return _bc_single(v)
        b = e.encode("utf-8")
        if len(b) == 1:
            return _bc_single(b[0])
        raise GrammarError(f"unsupported escape \\{e}")

    def _char_class(self) -> int:
        assert self.s[self.i] == "["
        self.i += 1
        negate = False
        if self.s[self.i] == "^":
            negate = True
            self.i += 1
        mask = 0
        first = True
        while True:
            if self.i >= len(self.s):
                raise GrammarError("unterminated character class")
            c = self.s[self.i]
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                self.i += 1
                mask |= self._escape_class()
                continue
            self.i += 1
            o = ord(c)
            if (self.i + 1 < len(self.s) and self.s[self.i] == "-"
                    and self.s[self.i + 1] != "]"):
                self.i += 1
                hi = ord(self.s[self.i])
                self.i += 1
                if o < 128 and hi < 128:
                    mask |= _bc_range(o, hi)
                else:
                    raise GrammarError("non-ASCII range in char class")
            else:
                enc = c.encode("utf-8")
                if len(enc) == 1:
                    mask |= _bc_single(enc[0])
                else:
                    # Multi-byte char in a class: approximate by its lead
                    # byte sequence is not expressible as one class.
                    raise GrammarError(
                        "multi-byte char in character class unsupported")
        return (ANY_BYTE ^ mask) if negate else mask


# ---------------------------------------------------------------------------
# Earley engine
# ---------------------------------------------------------------------------


def lower_grammar(text: str, start: str = "start"):
    """Serialize a parsed grammar for the native engine (native.py).

    Returns (data int64 list, classes uint64 list (4 per class), start_id).
    Format: [n_nts, per nt: n_alts, per alt: n_syms, syms...]; sym >= 0 is
    a nonterminal id, sym < 0 is -(byteclass_id+1).
    """
    rules = _Parser(text).parse()
    if start not in rules:
        raise GrammarError(f"start nonterminal {start!r} not defined")
    nt_ids = {name: i for i, name in enumerate(rules)}
    class_ids: dict[int, int] = {}
    classes: list[int] = []

    def class_id(mask: int) -> int:
        cid = class_ids.get(mask)
        if cid is None:
            cid = class_ids[mask] = len(class_ids)
            for i in range(4):
                classes.append((mask >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
        return cid

    data = [len(rules)]
    for name in rules:
        alts = rules[name]
        data.append(len(alts))
        for alt in alts:
            data.append(len(alt))
            for sym, val in alt:
                if sym == "nt":
                    if val not in nt_ids:
                        raise GrammarError(f"undefined nonterminal {val!r}")
                    data.append(nt_ids[val])
                else:
                    data.append(-(class_id(val) + 1))
    return data, classes, nt_ids[start]


@dataclass(frozen=True)
class _Item:
    rule: str
    alt: int
    dot: int
    origin: int


class GrammarEngine:
    """Incremental byte-level Earley recognizer."""

    def __init__(self, text: str, start: str = "start"):
        self.rules = _Parser(text).parse()
        if start not in self.rules:
            raise GrammarError(f"start nonterminal {start!r} not defined")
        self.start = start
        # chart[i] = set of items after consuming i bytes
        root = _Item("__root", 0, 0, 0)
        self.rules["__root"] = [[("nt", start)]]
        s0: set[_Item] = set()
        self._closure({root}, s0, 0)
        self.chart: list[set[_Item]] = [s0]
        self.dead = False

    # -- core Earley ops ---------------------------------------------------

    def _closure(self, new: set[_Item], into: set[_Item], pos: int) -> None:
        """Predict + complete until fixpoint; scan is the caller's job.

        Handles the nullable-completion corner (Aycock-Horspool): a rule
        completed with origin == pos immediately advances items added
        *later* that wait on it, via ``completed_here``.
        """
        work = list(new)
        completed_here: set[str] = set()
        while work:
            it = work.pop()
            if it in into:
                continue
            into.add(it)
            body = self.rules[it.rule][it.alt]
            if it.dot < len(body):
                sym, val = body[it.dot]
                if sym == "nt":
                    for alt_i in range(len(self.rules[val])):
                        work.append(_Item(val, alt_i, 0, pos))
                    if val in completed_here:
                        work.append(_Item(it.rule, it.alt, it.dot + 1,
                                          it.origin))
            else:
                # Completed: advance all items waiting on it.rule at origin.
                if it.origin == pos:
                    completed_here.add(it.rule)
                    src = list(into)
                else:
                    src = self.chart[it.origin]
                for parent in src:
                    pbody = self.rules[parent.rule][parent.alt]
                    if (parent.dot < len(pbody)
                            and pbody[parent.dot] == ("nt", it.rule)):
                        work.append(_Item(parent.rule, parent.alt,
                                          parent.dot + 1, parent.origin))

    def _scan(self, frm: set[_Item], byte: int, pos: int) -> set[_Item]:
        """One byte step: returns the new item set (may be empty)."""
        moved = set()
        for it in frm:
            body = self.rules[it.rule][it.alt]
            if it.dot < len(body):
                sym, val = body[it.dot]
                if sym == "bc" and (val >> byte) & 1:
                    moved.add(_Item(it.rule, it.alt, it.dot + 1, it.origin))
        out: set[_Item] = set()
        if moved:
            self._closure(moved, out, pos)
        return out

    # -- public API --------------------------------------------------------

    def advance(self, data: bytes) -> bool:
        """Consume bytes; False if the grammar rejects (engine goes dead)."""
        if self.dead:
            return False
        for b in data:
            new = self._scan(self.chart[-1], b, len(self.chart))
            if not new:
                self.dead = True
                return False
            self.chart.append(new)
        return True

    def can_finish(self) -> bool:
        """Grammar can complete at the current position."""
        return any(it.rule == "__root" and it.dot == 1
                   for it in self.chart[-1])

    def must_finish(self) -> bool:
        """Complete and no byte can extend the match."""
        return self.can_finish() and self.allowed_bytes() == 0

    def allowed_bytes(self) -> int:
        mask = 0
        for it in self.chart[-1]:
            body = self.rules[it.rule][it.alt]
            if it.dot < len(body):
                sym, val = body[it.dot]
                if sym == "bc":
                    mask |= val
        return mask

    def allowed_tokens(self, tokenizer) -> list[int]:
        """Token ids whose full byte string the grammar accepts from here.

        DFS over the tokenizer's byte trie, speculatively extending the
        chart (pushed/popped) and pruning on empty sets.
        """
        if self.dead:
            return []
        out: list[int] = []
        chart = self.chart
        children = tokenizer._children
        accept = tokenizer._accept

        def dfs(trie_node: int):
            for byte, nxt in children[trie_node].items():
                new = self._scan(chart[-1], byte, len(chart))
                if not new:
                    continue
                chart.append(new)
                tid = accept[nxt]
                if tid:
                    out.append(tid)
                dfs(nxt)
                chart.pop()

        dfs(0)
        return out


# ------------------- regular-grammar byte-DFA fast path -------------------
#
# The Earley engine above (and its C++ twin) recomputes the allowed-token
# set per GRAMMAR STATE, and its state cache keys on absolute item
# origins — sound, but a self-recursive region ("text ::= tchar | tchar
# text") creates a fresh state every accepted token, so every mask is a
# ~240 ms first visit (measured, 65529-token vocab on the bench host):
# single-stream BNF decode crawls at ~4 tok/s.
#
# Most practical grammars (the JSON/schema outputs of tools/json2kbnf.py
# included) are REGULAR: recursion only in tail position.  For those the
# grammar compiles to a byte-level DFA whose state count is small and
# closed — the sticky region is ONE DFA state, so the per-state token
# mask is computed once per distinct state, ever, and accept() is a
# table walk.  Non-regular grammars (center recursion) keep the Earley
# engine.  Reference parity: kbnf gets the same effect from its FSM
# compilation + token cache (crates/ai00-core/src/sampler/bnf.rs wraps
# kbnf 0.5.7; BnfOption.enable_bytes_cache, reload.rs:80-86).

_NFA_MAX_STATES = 20000
_DFA_MAX_STATES = 4096


class _NotRegular(Exception):
    pass


def _build_nfa(rules: dict, start: str):
    """Inline the rule graph into a byte-class NFA.

    Each (nonterminal, continuation-state) pair is expanded once
    (memoized); a tail call to an in-progress expansion with the same
    continuation becomes a loop edge (regular recursion).  Recursion in
    any other position raises _NotRegular.  Returns (edges, eps, entry,
    accept) where edges[s] = [(byteclass_mask, dst)], eps[s] = [dst].
    """
    edges: list[list[tuple[int, int]]] = []
    eps: list[list[int]] = []

    def new_state() -> int:
        if len(edges) >= _NFA_MAX_STATES:
            raise _NotRegular("NFA too large")
        edges.append([])
        eps.append([])
        return len(edges) - 1

    accept = new_state()
    memo: dict[tuple[str, int], int] = {}

    def expand(nt: str, cont: int, stack: frozenset) -> int:
        key = (nt, cont)
        got = memo.get(key)
        if got is not None:
            return got
        if nt in stack:
            # Recursive reference with a NEW continuation: the call site
            # is not in tail position of the pending expansion.
            raise _NotRegular(nt)
        entry = new_state()
        memo[key] = entry
        sub_stack = stack | {nt}
        for alt in rules[nt]:
            cur = entry
            if not alt:          # epsilon alternative
                eps[cur].append(cont)
                continue
            for i, (sym, val) in enumerate(alt):
                last = i == len(alt) - 1
                if sym == "bc":
                    nxt = cont if last else new_state()
                    edges[cur].append((val, nxt))
                    cur = nxt
                else:
                    nxt = cont if last else new_state()
                    eps[cur].append(expand(val, nxt, sub_stack))
                    cur = nxt
        return entry

    entry = expand(start, accept, frozenset())
    return edges, eps, entry, accept


def _rewrite_left_recursion(rules: dict) -> dict:
    """A ::= A a | b   =>   A ::= b A'; A' ::= a A' | eps  — direct left
    recursion is regular (the parser lowers '+'/'*' this way); rewriting
    it to a tail loop lets _build_nfa accept it.  Indirect left
    recursion still raises _NotRegular downstream (Earley fallback)."""
    out = dict(rules)
    n = 0
    for nt, alts in rules.items():
        rec = [a[1:] for a in alts if a and a[0] == ("nt", nt)]
        base = [a for a in alts if not (a and a[0] == ("nt", nt))]
        if not rec or not base:
            continue
        star = f"__lrec{n}"
        n += 1
        out[star] = [list(a) + [("nt", star)] for a in rec] + [[]]
        out[nt] = [list(a) + [("nt", star)] for a in base]
    return out


def _dfa_tables(text: str, start: str):
    """(trans (n,256) int32, can_finish (n,) bool, start_idx, dead_idx)
    or None when the grammar is not regular / too large."""
    import numpy as np

    rules = _Parser(text).parse()
    if start not in rules:
        raise GrammarError(f"start nonterminal {start!r} not defined")
    try:
        edges, eps, entry, accept = _build_nfa(
            _rewrite_left_recursion(rules), start)
    except _NotRegular:
        return None
    n = len(edges)

    # Epsilon closures.
    closure: list[frozenset] = [None] * n
    for s in range(n):
        seen = {s}
        work = [s]
        while work:
            for t in eps[work.pop()]:
                if t not in seen:
                    seen.add(t)
                    work.append(t)
        closure[s] = frozenset(seen)

    def close(states) -> frozenset:
        out = set()
        for s in states:
            out |= closure[s]
        return frozenset(out)

    # Byte-alphabet reduction: bytes with identical edge membership share
    # a column.
    masks = sorted({m for es in edges for (m, _) in es})
    groups: dict[tuple, list[int]] = {}
    for b in range(256):
        key = tuple(((m >> b) & 1) for m in masks)
        groups.setdefault(key, []).append(b)

    start_set = close([entry])
    states: dict[frozenset, int] = {}
    order: list[frozenset] = []

    def intern(fs: frozenset) -> int:
        got = states.get(fs)
        if got is None:
            got = states[fs] = len(order)
            order.append(fs)
        return got

    dead = intern(frozenset())
    s0 = intern(start_set)
    trans_rows: list[dict[int, int]] = [dict(), dict()]
    i = 0
    while i < len(order):
        if len(order) > _DFA_MAX_STATES:
            return None
        fs = order[i]
        if i >= len(trans_rows):
            trans_rows.append({})
        row = trans_rows[i]
        if fs:
            for key, bs in groups.items():
                b0 = bs[0]
                nxt = set()
                for s in fs:
                    for m, d in edges[s]:
                        if (m >> b0) & 1:
                            nxt.add(d)
                tgt = intern(close(nxt)) if nxt else dead
                for b in bs:
                    row[b] = tgt
        i += 1

    nstates = len(order)
    trans = np.full((nstates, 256), dead, np.int32)
    for si, row in enumerate(trans_rows[:nstates]):
        for b, t in row.items():
            trans[si, b] = t
    fin = np.array([accept in fs for fs in order], np.bool_)
    return trans, fin, s0, dead


def _token_buckets(tokenizer, vocab: int):
    """Token byte matrices grouped by length, cached on the tokenizer:
    [(ids (n,) int64, bytes (n, L) uint8)] — total work for a mask is
    one table gather per vocab byte."""
    import numpy as np

    cached = getattr(tokenizer, "_dfa_token_buckets", None)
    if cached is not None and cached[0] == vocab:
        return cached[1]
    # Enumerate via the byte trie (same id-per-byte-string semantics as
    # the Earley engines' trie DFS: duplicate byte strings resolve to
    # the trie's accept id).
    by_len: dict[int, list[tuple[int, bytes]]] = {}
    children, accept = tokenizer._children, tokenizer._accept
    stack = [(0, b"")]
    while stack:
        node, path = stack.pop()
        tid = accept[node]
        if tid and tid < vocab:
            by_len.setdefault(len(path), []).append((tid, path))
        for byte, nxt in children[node].items():
            stack.append((nxt, path + bytes([byte])))
    buckets = []
    for L, items in sorted(by_len.items()):
        ids = np.array([t for t, _ in items], np.int64)
        mat = np.frombuffer(b"".join(d for _, d in items),
                            np.uint8).reshape(len(items), L)
        buckets.append((ids, mat))
    tokenizer._dfa_token_buckets = (vocab, buckets)
    return buckets


class DFAGrammarEngine:
    """GrammarEngine-compatible engine over precompiled DFA tables.

    ``advance`` is a table walk; ``allowed_tokens`` vectorizes the walk
    over the whole vocab (one gather per token byte) and caches the
    resulting id array PER DFA STATE in the shared ``mask_cache`` — the
    closed state set means a long generation computes each mask once.
    """

    def __init__(self, trans, fin, s0, dead, mask_cache):
        self.trans = trans
        self.fin = fin
        self.state = int(s0)
        self.dead_state = int(dead)
        self.dead = False
        self._mask_cache = mask_cache

    def advance(self, data: bytes) -> bool:
        if self.dead:
            return False
        s = self.state
        trans = self.trans
        for b in data:
            s = int(trans[s, b])
        if s == self.dead_state:
            self.dead = True
            return False
        self.state = s
        return True

    def can_finish(self) -> bool:
        return bool(self.fin[self.state])

    def must_finish(self) -> bool:
        return (self.can_finish()
                and bool((self.trans[self.state] == self.dead_state)
                         .all()))

    def allowed_tokens(self, tokenizer):
        import numpy as np

        cached = self._mask_cache.get(self.state)
        if cached is not None:
            return cached
        vocab = tokenizer.vocab_len
        out = []
        dead = self.dead_state
        for ids, mat in _token_buckets(tokenizer, vocab):
            states = np.full(len(ids), self.state, np.int32)
            for j in range(mat.shape[1]):
                states = self.trans[states, mat[:, j]]
                # Dead self-loops, so a single final compare suffices —
                # but bail early once everything died.
                if j % 4 == 3 and (states == dead).all():
                    break
            out.append(ids[states != dead])
        ids = np.concatenate(out) if out else np.zeros(0, np.int64)
        self._mask_cache[self.state] = ids
        return ids


def token_dfa_table(text: str, tokenizer, vocab: int,
                    start: str = "start", max_states: int = 63):
    """Token-level DFA table for DEVICE-resident constrained decode.

    Returns ``(table, state_map)`` or ``None`` (grammar not regular, or
    more than ``max_states`` token-reachable states).  ``table`` is an
    ``(max_states + 1, vocab) int8`` array whose one encoding carries
    both the per-state allowed mask and the state advance:

    * ``table[s, t] == -1`` — token ``t`` is DISALLOWED in state ``s``
      (the mask is simply ``table[s] >= 0``);
    * ``table[s, t] == H`` (``H = max_states``, the last row) — token
      ``t`` is allowed and the grammar HALTS after it (grammar complete,
      ``BnfFormatter.accept`` semantics: token 0, or a must-finish
      target state);
    * otherwise — the next token-level state.

    Row ``H`` is the halt state: all entries ``H`` (everything allowed,
    self-loop), so a decode scan that reaches it samples unconstrained
    — the engine freezes halted rows, so those steps never execute.
    Token 0 is allowed exactly when the state can finish
    (``BnfFormatter.allowed_mask`` sets ``mask[0]`` for can-finish and
    as the dead-state fallback).

    With this table the whole BNF hot path runs INSIDE the K-token
    decode scan — exact per-step masks, on-device state advance, no
    host replay mis-speculation and no rollbacks (the reference masks
    logits on the CPU per token, bnf.rs:35-47; this is the TPU-native
    equivalent).  Cost: one ``(S, V)`` table build per (grammar,
    tokenizer), cached, ~few ms per state via the bucketed byte walk.
    """
    import numpy as np

    if not 1 <= max_states <= 127:
        # int8 entries hold the state ids 0..max_states, the halt id H
        # included: a taller table would wrap them.
        raise ValueError(f"max_states {max_states}: the int8 token DFA "
                         "holds 1..127 states (at most 128 rows)")
    key = (text, start, getattr(tokenizer, "fingerprint", id(tokenizer)),
           vocab, max_states)
    cache = token_dfa_table._cache
    if key in cache:
        return cache[key]

    tables = None
    ekey = (text, start)
    got = make_dfa_engine._cache.get(ekey)
    if got is not None:
        tables = got[:4]
    elif ekey not in make_dfa_engine._cache:
        tables = _dfa_tables(text, start)
    result = None
    if tables is not None:
        trans, fin, s0, dead = tables
        # must-finish byte states: can finish and no live outgoing edge.
        mf = fin & (trans == dead).all(axis=1)
        H = max_states
        buckets = _token_buckets(tokenizer, vocab)
        table = np.full((max_states + 1, vocab), -1, np.int8)
        table[H] = H  # halt state: everything allowed, self-loop
        state_map: dict[int, int] = {int(s0): 0}
        work = [int(s0)]
        ok = True
        while work and ok:
            bstate = work.pop()
            ridx = state_map[bstate]
            row = table[ridx]
            if fin[bstate]:
                row[0] = H  # EOS allowed iff the state can finish; halts
            for ids, mat in buckets:
                states = np.full(len(ids), bstate, np.int32)
                for j in range(mat.shape[1]):
                    states = trans[states, mat[:, j]]
                    if j % 4 == 3 and (states == dead).all():
                        break
                alive = states != dead
                tgt = states[alive]
                tids = ids[alive]
                halts = mf[tgt]
                row[tids[halts]] = H
                live_t = tids[~halts]
                live_s = tgt[~halts]
                if not live_s.size:
                    continue
                uniq = np.unique(live_s)
                lut = np.full(int(uniq.max()) + 1, -1, np.int32)
                for s in uniq:
                    si = int(s)
                    idx = state_map.get(si)
                    if idx is None:
                        if len(state_map) >= max_states:
                            ok = False
                            break
                        idx = state_map[si] = len(state_map)
                        work.append(si)
                    lut[si] = idx
                if not ok:
                    break
                row[live_t] = lut[live_s].astype(np.int8)
            if ok and not (row >= 0).any():
                row[0] = H  # dead-state fallback: allow EOS (halt)
        if ok:
            result = (table, state_map)
    cache[key] = result
    if len(cache) > 32:
        cache.pop(next(iter(cache)))
    return result


token_dfa_table._cache = {}


def make_dfa_engine(text: str, start: str = "start"):
    """DFAGrammarEngine for a regular grammar, or None (Earley fallback).
    Tables + per-state mask cache are shared across instances of the
    same (grammar, start)."""
    key = (text, start)
    cache = make_dfa_engine._cache
    if key not in cache:
        tables = _dfa_tables(text, start)
        cache[key] = None if tables is None else (*tables, {})
        if len(cache) > 64:
            cache.pop(next(iter(cache)))
    got = cache[key]
    if got is None:
        return None
    trans, fin, s0, dead, mask_cache = got
    return DFAGrammarEngine(trans, fin, s0, dead, mask_cache)


make_dfa_engine._cache = {}
