"""The port's grammar stack (``ai00_server_tpu_torch/grammar.py``,
``bnf.py``) on the CPU: the cases of ``tests/test_grammar.py`` on the port,
then the port against the JAX package on every schema of those cases (the
same byte sequences give the same allowed bytes, allowed tokens, finish
flags and formatter masks), ``token_dfa_table`` equal to JAX's exactly
(table and state map) on the cases' tiny tokenizer, and the int8 limit of
the table the JAX package lacks."""

import numpy as np
import pytest

from ai00_server_tpu import bnf as jbnf
from ai00_server_tpu import grammar as jgrammar
from ai00_server_tpu.tokenizer import Tokenizer as JTokenizer

from ai00_server_tpu_torch import grammar as tgrammar
from ai00_server_tpu_torch.bnf import BnfFormatter
from ai00_server_tpu_torch.grammar import GrammarEngine, GrammarError
from ai00_server_tpu_torch.tokenizer import Tokenizer


def accepts(g: str, s: str, start="start") -> bool:
    e = GrammarEngine(g, start=start)
    return e.advance(s.encode()) and e.can_finish()


def test_literal_and_alternation():
    g = "start ::= 'ab' | 'cd';"
    assert accepts(g, "ab")
    assert accepts(g, "cd")
    assert not accepts(g, "ad")
    assert not accepts(g, "abc")  # can't finish isn't enough: 'c' rejects
    e = GrammarEngine(g)
    assert e.advance(b"a")
    assert not e.can_finish()
    assert not e.advance(b"d")
    assert e.dead


def test_repetition_ops():
    g = "start ::= 'a'* 'b'+ 'c'?;"
    for s, ok in [("b", True), ("aab", True), ("abbc", True), ("c", False),
                  ("aac", False), ("aabbc", True), ("", False)]:
        assert accepts(g, s) == ok, s


def test_recursion_nesting():
    g = "start ::= expr; expr ::= '(' expr ')' | 'x';"
    for s, ok in [("x", True), ("(x)", True), ("((x))", True),
                  ("((x)", False), ("()", False)]:
        assert accepts(g, s) == ok, s


def test_nullable_rules():
    g = "start ::= a b 'z'; a ::= 'x' | ; b ::= 'y' | ;"
    for s, ok in [("xyz", True), ("yz", True), ("xz", True), ("z", True),
                  ("xy", False)]:
        assert accepts(g, s) == ok, s


def test_regex_terminal():
    g = "start ::= #'[a-c]+[0-9]{2}';"
    for s, ok in [("ab12", True), ("c00", True), ("abc", False),
                  ("1a", False), ("aa1", False)]:
        assert accepts(g, s) == ok, s


def test_regex_alternation_and_escapes():
    g = r"start ::= #'(foo|bar)\d*';"
    for s, ok in [("foo", True), ("bar42", True), ("baz", False)]:
        assert accepts(g, s) == ok, s


def test_json_like_grammar():
    g = r"""
    start ::= object;
    object ::= '{' ws pair (',' ws pair)* ws '}' | '{' ws '}';
    pair ::= string ws ':' ws value;
    value ::= string | number | object | 'true' | 'false' | 'null';
    string ::= '"' #'[a-zA-Z0-9_ ]*' '"';
    number ::= #'-?[0-9]+(\.[0-9]+)?';
    ws ::= #'[ \t\n]*';
    """
    for s, ok in [('{}', True), ('{"a": 1}', True),
                  ('{"a": {"b": "c"}, "d": true}', True),
                  ('{"a" 1}', False), ('{a: 1}', False),
                  ('{"x": -3.5}', True)]:
        assert accepts(g, s) == ok, s


def test_allowed_bytes():
    e = GrammarEngine("start ::= 'a' | 'b';")
    ab = e.allowed_bytes()
    assert (ab >> ord("a")) & 1 and (ab >> ord("b")) & 1
    assert not (ab >> ord("c")) & 1
    e.advance(b"a")
    assert e.allowed_bytes() == 0
    assert e.must_finish()


def test_undefined_start_raises():
    with pytest.raises(GrammarError):
        GrammarEngine("foo ::= 'a';")


@pytest.fixture(scope="module")
def tiny_tokenizer():
    # Vocab: single chars + a few multi-char tokens.
    vocab = {}
    tid = 1
    for ch in "abcdefghij(){}:,\"0123456789 yesno":
        vocab[tid] = ch.encode()
        tid += 1
    for s in ["yes", "no", "ab", "abc", '"a"']:
        vocab[tid] = s.encode()
        tid += 1
    return Tokenizer(vocab)


def test_allowed_tokens(tiny_tokenizer):
    tok = tiny_tokenizer
    e = GrammarEngine("start ::= 'yes' | 'no';")
    allowed = e.allowed_tokens(tok)
    texts = sorted(tok.token_to_bytes(t).decode() for t in allowed)
    # Tokens that are full prefixes of valid continuations: y/n/ye..?
    # Only tokens whose ENTIRE bytes are consumable: 'y', 'n', 'yes', 'no'.
    assert "yes" in texts and "no" in texts
    assert "y" in texts and "n" in texts
    assert "e" not in texts and "a" not in texts


def test_bnf_formatter_drives_to_completion(tiny_tokenizer):
    tok = tiny_tokenizer
    f = BnfFormatter("start ::= 'yes' | 'no';", tok, tok.vocab_len)
    mask = f.allowed_mask()
    allowed_ids = np.nonzero(mask)[0]
    # pick 'yes' token
    yes_id = next(t for t in allowed_ids
                  if tok.token_to_bytes(int(t)) == b"yes")
    halt = f.accept(int(yes_id))
    assert halt  # grammar complete and no extension possible


def test_bnf_formatter_step_by_step(tiny_tokenizer):
    tok = tiny_tokenizer
    f = BnfFormatter("start ::= 'ab' 'c'+;", tok, tok.vocab_len)
    ab = next(t for t in range(tok.vocab_len)
              if tok.token_to_bytes(t) == b"ab")
    c = next(t for t in range(tok.vocab_len)
             if tok.token_to_bytes(t) == b"c")
    assert not f.accept(ab)
    mask = f.allowed_mask()
    assert mask[c]
    # 'c' can repeat forever: EOS allowed once grammar can finish.
    assert not f.accept(c)
    assert f.allowed_mask()[0]  # EOS allowed
    assert f.accept(0)  # EOS halts


# ------------------- DFA fast path (regular grammars) -------------------

JSON_STICKY = (
    "start ::= '{\"name\": \"' text '\", \"value\": ' num '}';\n"
    "text ::= tchar | tchar text;\n"
    "tchar ::= 'a'|'b'|'c'|'d'|'e'|' '|'.'|','|'-';\n"
    "num ::= digit | digit num;\n"
    "digit ::= '0'|'1'|'2'|'3'|'4'|'5'|'6'|'7'|'8'|'9';\n")


def test_dfa_detects_regularity():
    from ai00_server_tpu_torch.grammar import make_dfa_engine

    assert make_dfa_engine(JSON_STICKY) is not None
    assert make_dfa_engine("start ::= 'a' start 'b' | 'c';") is None
    assert make_dfa_engine("start ::= '(' start ')' | 'x';") is None
    # Tail recursion (direct and through another rule) is regular.
    assert make_dfa_engine(
        "start ::= 'a' | 'a' start;") is not None
    assert make_dfa_engine(
        "start ::= 'a' more; more ::= 'b' | 'b' start;") is not None


@pytest.mark.parametrize("schema,drive", [
    ("start ::= 'yes' | 'no';", "yes"),
    ("start ::= 'ab' 'c'+;", "abccc"),
    (JSON_STICKY, '{"name": "abc de", "value": 42}'),
    ("start ::= digit+; digit ::= #'[0-9]';", "0042"),
])
def test_dfa_masks_match_earley(tiny_tokenizer, schema, drive):
    """The DFA engine's allowed-token sets and finish flags match the
    Earley engine byte-for-byte along a real derivation."""
    from ai00_server_tpu_torch.grammar import GrammarEngine, make_dfa_engine

    tok = tiny_tokenizer
    dfa = make_dfa_engine(schema)
    assert dfa is not None
    ear = GrammarEngine(schema)
    data = drive.encode()
    for i in range(len(data) + 1):
        assert sorted(map(int, dfa.allowed_tokens(tok))) == \
            sorted(map(int, ear.allowed_tokens(tok))), f"at byte {i}"
        assert dfa.can_finish() == ear.can_finish(), f"at byte {i}"
        assert dfa.must_finish() == ear.must_finish(), f"at byte {i}"
        if i < len(data):
            assert dfa.advance(data[i:i + 1]) == ear.advance(
                data[i:i + 1])


def test_dfa_mask_cache_shared_and_rejection(tiny_tokenizer):
    from ai00_server_tpu_torch.grammar import make_dfa_engine

    a = make_dfa_engine(JSON_STICKY)
    b = make_dfa_engine(JSON_STICKY)
    assert a.trans is b.trans          # shared tables
    a.allowed_tokens(tiny_tokenizer)
    assert a._mask_cache is b._mask_cache and len(b._mask_cache) >= 1
    assert a.advance(b"{") and not a.advance(b"zzz")  # reject -> dead
    assert a.dead


def test_bnf_formatter_uses_dfa_for_regular(tiny_tokenizer):
    from ai00_server_tpu_torch.grammar import DFAGrammarEngine

    # Literals drawn from the tiny vocab (it has no 'm'/'l'/'u' bytes).
    schema = ('start ::= \'{"a": "\' text \'", "b": \' num \'}\';\n'
              "text ::= tchar | tchar text;\n"
              "tchar ::= 'a'|'b'|'c'|'d'|'e'|' '|'.'|','|'-';\n"
              "num ::= digit | digit num;\n"
              "digit ::= '0'|'1'|'2'|'3'|'4'|'5'|'6'|'7'|'8'|'9';\n")
    f = BnfFormatter(schema, tiny_tokenizer, tiny_tokenizer.vocab_len)
    assert isinstance(f.engine, DFAGrammarEngine)
    # Generate greedily under the mask until the grammar halts; the
    # produced string must be a complete derivation per the Earley
    # engine (any mask-following walk is grammar-exact).
    out, halted = b"", False
    for _ in range(64):
        mask = f.allowed_mask()
        ids = [int(t) for t in np.nonzero(mask)[0]
               if tiny_tokenizer.token_to_bytes(int(t))]
        assert ids, "mask empty before grammar completion"
        by_bytes = {tiny_tokenizer.token_to_bytes(t): t for t in ids}
        # Prefer closers so the unbounded text/num regions terminate.
        pick = by_bytes.get(b"}") or by_bytes.get(b'"') or ids[-1]
        out += tiny_tokenizer.token_to_bytes(pick)
        if f.accept(pick):
            halted = True
            break
    assert halted, out
    ear = GrammarEngine(schema)
    assert ear.advance(out) and ear.can_finish(), out


def test_token_dfa_table_matches_formatter(tiny_tokenizer):
    """The device token-DFA table (grammar.token_dfa_table) is exact:
    along every mask-following walk, the table row's allowed set equals
    the BnfFormatter's host mask, the state advance tracks the
    formatter's byte-DFA state, and a halt entry (H) fires exactly when
    the formatter's accept() reports grammar completion."""
    from ai00_server_tpu_torch.grammar import token_dfa_table

    tok = tiny_tokenizer
    V = tok.vocab_len
    schemas = [
        "start ::= 'yes' | 'no';",
        JSON_STICKY,
        "start ::= digit digit digit; digit ::= #'[0-9]';",
    ]
    for schema in schemas:
        res = token_dfa_table(schema, tok, V, max_states=63)
        assert res is not None, schema
        table, smap = res
        H = table.shape[0] - 1
        # Exhaustive DFS over every token-reachable state: masks match
        # the formatter driven to the same state.
        for bstate, ridx in list(smap.items()):
            f = BnfFormatter(schema, tok, V)
            # Drive the formatter's byte engine directly to bstate.
            f.engine.state = bstate
            row = table[ridx]
            want = f.allowed_mask()
            got = row >= 0
            assert np.array_equal(got, want), (schema, bstate)
        # A mask-following walk: halts exactly when accept() halts.
        f = BnfFormatter(schema, tok, V)
        state = 0
        for _ in range(64):
            row = table[state]
            ids = [t for t in np.nonzero(row >= 0)[0]
                   if t == 0 or tok.token_to_bytes(int(t))]
            assert ids
            pick = int(ids[-1])
            halted = f.accept(pick) if pick else True
            nxt = int(row[pick])
            if nxt == H:
                assert halted or pick == 0, (schema, pick)
                break
            assert not halted, (schema, pick)
            state = nxt
        else:
            pytest.fail(f"walk never halted: {schema}")


# ------------------- the port against the JAX package -------------------

JSON_LIKE = r"""
    start ::= object;
    object ::= '{' ws pair (',' ws pair)* ws '}' | '{' ws '}';
    pair ::= string ws ':' ws value;
    value ::= string | number | object | 'true' | 'false' | 'null';
    string ::= '"' #'[a-zA-Z0-9_ ]*' '"';
    number ::= #'-?[0-9]+(\.[0-9]+)?';
    ws ::= #'[ \t\n]*';
    """

# (schema, byte sequences fed one byte at a time): every schema of the
# cases above, each with the inputs those cases feed it.
SCHEMAS = [
    ("start ::= 'ab' | 'cd';", ["ab", "cd", "ad", "abc"]),
    ("start ::= 'a'* 'b'+ 'c'?;", ["b", "aab", "abbc", "c", "aac", "aabbc"]),
    ("start ::= expr; expr ::= '(' expr ')' | 'x';",
     ["x", "(x)", "((x))", "((x)", "()"]),
    ("start ::= a b 'z'; a ::= 'x' | ; b ::= 'y' | ;",
     ["xyz", "yz", "xz", "z", "xy"]),
    ("start ::= #'[a-c]+[0-9]{2}';", ["ab12", "c00", "abc", "1a", "aa1"]),
    (r"start ::= #'(foo|bar)\d*';", ["foo", "bar42", "baz"]),
    (JSON_LIKE, ['{}', '{"a": 1}', '{"a": {"b": "c"}, "d": true}',
                 '{"a" 1}', '{a: 1}', '{"x": -3.5}']),
    ("start ::= 'a' | 'b';", ["a", "b"]),
    ("start ::= 'yes' | 'no';", ["yes", "no"]),
    ("start ::= 'ab' 'c'+;", ["abccc"]),
    (JSON_STICKY, ['{"name": "abc de", "value": 42}']),
    ("start ::= digit+; digit ::= #'[0-9]';", ["0042"]),
    ("start ::= digit digit digit; digit ::= #'[0-9]';", ["123"]),
    ("start ::= 'a' start 'b' | 'c';", ["aacbb"]),
    ("start ::= '(' start ')' | 'x';", ["((x))"]),
    ("start ::= 'a' | 'a' start;", ["aaa"]),
    ("start ::= 'a' more; more ::= 'b' | 'b' start;", ["ababab"]),
]


@pytest.fixture(scope="module")
def tokenizers():
    """The tiny vocabulary of the cases above, in both packages."""
    vocab = {}
    tid = 1
    for ch in "abcdefghij(){}:,\"0123456789 yesno":
        vocab[tid] = ch.encode()
        tid += 1
    for s in ["yes", "no", "ab", "abc", '"a"']:
        vocab[tid] = s.encode()
        tid += 1
    return JTokenizer(vocab), Tokenizer(vocab)


@pytest.mark.parametrize("schema,inputs", SCHEMAS,
                         ids=[str(i) for i in range(len(SCHEMAS))])
def test_engines_equal_jax_byte_by_byte(tokenizers, schema, inputs):
    """The port's Earley engine and JAX's, fed the same bytes one at a
    time: the same verdicts, allowed bytes, allowed tokens and finish
    flags at every position; the byte DFA of a regular grammar as well."""
    jtok, ttok = tokenizers
    assert (tgrammar.make_dfa_engine(schema) is None) == \
        (jgrammar.make_dfa_engine(schema) is None)
    for s in inputs:
        engines = [(jgrammar.GrammarEngine(schema), GrammarEngine(schema))]
        jdfa = jgrammar.make_dfa_engine(schema)
        if jdfa is not None:
            engines.append((jdfa, tgrammar.make_dfa_engine(schema)))
        for j, t in engines:
            for i in range(len(s) + 1):
                assert sorted(map(int, t.allowed_tokens(ttok))) == \
                    sorted(map(int, j.allowed_tokens(jtok))), (s, i)
                assert t.can_finish() == j.can_finish(), (s, i)
                assert t.must_finish() == j.must_finish(), (s, i)
                if hasattr(j, "allowed_bytes"):
                    assert t.allowed_bytes() == j.allowed_bytes(), (s, i)
                if i < len(s):
                    b = s[i:i + 1].encode()
                    ok = j.advance(b)
                    assert t.advance(b) == ok, (s, i)
                    if not ok:
                        break


@pytest.mark.parametrize("schema,inputs", SCHEMAS,
                         ids=[str(i) for i in range(len(SCHEMAS))])
def test_formatter_masks_equal_jax(tokenizers, schema, inputs):
    """``BnfFormatter``: the same (V,) masks and halt verdicts as JAX's
    along each input, taken token by token through the tiny vocabulary
    (the non-regular schemas through the native Earley engine)."""
    jtok, ttok = tokenizers
    V = ttok.vocab_len
    for s in inputs:
        j = jbnf.BnfFormatter(schema, jtok, V)
        t = BnfFormatter(schema, ttok, V)
        for tok in ttok.encode(s):
            np.testing.assert_array_equal(t.allowed_mask(), j.allowed_mask())
            halted = j.accept(tok)
            assert t.accept(tok) == halted, (s, tok)
            if halted:
                break
        np.testing.assert_array_equal(t.allowed_mask(), j.allowed_mask())


@pytest.mark.parametrize("schema", [sch for sch, _ in SCHEMAS],
                         ids=[str(i) for i in range(len(SCHEMAS))])
def test_token_dfa_table_equals_jax(tokenizers, schema):
    """The device token-DFA table and its state map are JAX's, entry for
    entry, or both packages find the grammar not regular."""
    jtok, ttok = tokenizers
    V = ttok.vocab_len
    for max_states in (63, 3):
        want = jgrammar.token_dfa_table(schema, jtok, V, max_states=max_states)
        got = tgrammar.token_dfa_table(schema, ttok, V, max_states=max_states)
        assert (got is None) == (want is None), (schema, max_states)
        if want is not None:
            assert got[0].dtype == np.int8 and got[0].shape == want[0].shape
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


@pytest.mark.parametrize("max_states", [128, 200, 0])
def test_token_dfa_table_refuses_what_int8_cannot_hold(tokenizers,
                                                       max_states):
    """A table of more than 128 rows cannot hold its state ids in int8
    (the JAX package builds it and the ids wrap); the port refuses it, and
    a table with no state beside the halt row."""
    _, ttok = tokenizers
    with pytest.raises(ValueError, match="max_states"):
        tgrammar.token_dfa_table("start ::= 'yes' | 'no';", ttok,
                                 ttok.vocab_len, max_states=max_states)
    got = tgrammar.token_dfa_table("start ::= 'yes' | 'no';", ttok,
                                   ttok.vocab_len, max_states=127)
    assert got is not None and got[0].shape[0] == 128


def test_tokenizer_vocab_len_and_fingerprint_equal_jax(tokenizers):
    jtok, ttok = tokenizers
    assert ttok.vocab_len == jtok.vocab_len
    assert ttok.fingerprint == jtok.fingerprint
    other = Tokenizer({1: b"a", 2: b"b"})
    assert other.fingerprint != ttok.fingerprint
