"""The port's native (C++) grammar engine (``ai00_server_tpu_torch/
native.py``, ``csrc/grammar_engine.cpp``) on the CPU: the cases of
``tests/test_native_grammar.py`` (the native engine gives the Python
engine's verdicts, finish flags, allowed bytes and allowed tokens), then
its loader: two processes building the library at once into a fresh
directory both load it (each writes a temporary file of its own and
renames it into place), and a build that fails raises with the compiler's
message (the JAX package's loader falls back to Python without a word)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ai00_server_tpu_torch import native
from ai00_server_tpu_torch.grammar import GrammarEngine
from ai00_server_tpu_torch.tokenizer import Tokenizer

REPO = Path(__file__).resolve().parent.parent

GRAMMARS = [
    "start ::= 'ab' | 'cd';",
    "start ::= 'a'* 'b'+ 'c'?;",
    "start ::= expr; expr ::= '(' expr ')' | 'x';",
    "start ::= a b 'z'; a ::= 'x' | ; b ::= 'y' | ;",
    r"start ::= #'[a-c]+[0-9]{2}';",
    r"""
    start ::= object;
    object ::= '{' ws pair (',' ws pair)* ws '}' | '{' ws '}';
    pair ::= string ws ':' ws value;
    value ::= string | number | object | 'true' | 'false' | 'null';
    string ::= '"' #'[a-zA-Z0-9_ ]*' '"';
    number ::= #'-?[0-9]+(\.[0-9]+)?';
    ws ::= #'[ \t\n]*';
    """,
]

INPUTS = [
    "ab", "cd", "ad", "aabbc", "b", "((x))", "((x)", "xyz", "z", "xy",
    "ab12", "c00", "abc", '{"a": 1}', '{"a": {"b": "c"}}', '{"a" 1}', "{}",
]


@pytest.mark.parametrize("g", GRAMMARS, ids=range(len(GRAMMARS)))
def test_advance_and_finish_parity(g):
    for s in INPUTS:
        py = GrammarEngine(g)
        nat = native.NativeGrammarEngine(g)
        data = s.encode()
        ok_py = py.advance(data)
        ok_nat = nat.advance(data)
        assert ok_py == ok_nat, (g, s)
        if ok_py:
            assert py.can_finish() == nat.can_finish(), (g, s)
            assert py.allowed_bytes() == nat.allowed_bytes(), (g, s)
            assert py.must_finish() == nat.must_finish(), (g, s)


@pytest.fixture(scope="module")
def tiny_tokenizer():
    vocab = {}
    tid = 1
    for ch in 'abcdefghij(){}:,"0123456789 xyz':
        vocab[tid] = ch.encode()
        tid += 1
    for s in ["ab", "abc", "true", "null", '"a"', "((", "))"]:
        vocab[tid] = s.encode()
        tid += 1
    return Tokenizer(vocab)


@pytest.mark.parametrize("g", GRAMMARS, ids=range(len(GRAMMARS)))
def test_allowed_tokens_parity(g, tiny_tokenizer):
    """The native masks are the Python engine's, at each prefix and then
    byte by byte along every input the grammar accepts."""
    tok = tiny_tokenizer
    for prefix in ["", "a", "(", '{"a', "x"]:
        py = GrammarEngine(g)
        nat = native.NativeGrammarEngine(g)
        data = prefix.encode()
        if not py.advance(data):
            assert not nat.advance(data)
            continue
        assert nat.advance(data)
        assert sorted(py.allowed_tokens(tok)) == \
            sorted(nat.allowed_tokens(tok)), (g, prefix)
    for s in INPUTS:
        py = GrammarEngine(g)
        nat = native.NativeGrammarEngine(g)
        for b in s.encode():
            if not py.advance(bytes([b])):
                break
            assert nat.advance(bytes([b]))
            assert sorted(py.allowed_tokens(tok)) == \
                sorted(nat.allowed_tokens(tok)), (g, s)


def test_concurrent_builds_into_a_fresh_directory(tmp_path):
    """Two processes build the library at once into an empty directory;
    both load what they built and leave no temporary file behind."""
    code = textwrap.dedent("""
        import ctypes, sys
        from pathlib import Path
        from ai00_server_tpu_torch import native
        path = native.build(build_dir=Path(sys.argv[1]))
        lib = ctypes.CDLL(str(path))
        assert lib.grammar_new
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [f.name for f in tmp_path.iterdir()] == [Path(*paths).name]


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(src=src, build_dir=tmp_path / "out")
    assert "broken.cpp" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*"))


def test_get_lib_raises_when_the_library_cannot_be_built(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: the engine that needs the library raises."""
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.make_grammar_engine("start ::= 'a' start 'b' | 'c';")
