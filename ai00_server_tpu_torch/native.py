"""Build and bind the native (C++) grammar engine through ctypes.

Port of ``ai00_server_tpu/native.py``.  The shared library is compiled on
first use from ``csrc/grammar_engine.cpp`` (host code with a plain C
interface, not a GPU kernel) with ``g++`` into
``ai00_server_tpu_torch/_build/`` (ignored by git), keyed by a hash of the
source and the flags.  Two divergences from the JAX package:

* every build writes a temporary file named after its process and thread
  and ``os.replace``\\ s it into place, so concurrent builders (test
  workers, servers) never clobber one another's half-written output (the
  JAX package's builders share one ``.tmp`` name);
* a build that fails raises with the compiler's stderr.  The JAX package
  falls back to its Python engine without a word; here the Python
  ``grammar.GrammarEngine`` is the plain version the tests hold this engine
  against, and serving never takes it quietly.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
SRC = PKG / "csrc" / "grammar_engine.cpp"
BUILD = PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def build(src: Path = SRC, build_dir: Path = BUILD) -> Path:
    """Compile ``src`` into ``build_dir`` (once per source hash) and return
    the library's path.  Raises RuntimeError with g++'s stderr on failure."""
    src = Path(src)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = Path(build_dir) / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the grammar engine {src} "
                           "builds with a C++ compiler") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded grammar library, built at first use (raises if it cannot
    be built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build(SRC, BUILD)))
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        sigs = {
            "grammar_new": (ctypes.c_void_p, [i64p, ctypes.c_int64, u64p,
                                              ctypes.c_int64, ctypes.c_int64]),
            "grammar_free_grammar": (None, [ctypes.c_void_p]),
            "engine_new": (ctypes.c_void_p, [ctypes.c_void_p]),
            "engine_free": (None, [ctypes.c_void_p]),
            "engine_advance": (ctypes.c_int, [ctypes.c_void_p, u8p,
                                              ctypes.c_int]),
            "engine_can_finish": (ctypes.c_int, [ctypes.c_void_p]),
            "engine_dead": (ctypes.c_int, [ctypes.c_void_p]),
            "engine_allowed_bytes": (None, [ctypes.c_void_p, u8p]),
            "trie_new": (ctypes.c_void_p, [i32p, u8p, i32p, i32p,
                                           ctypes.c_int64, ctypes.c_int64]),
            "trie_free": (None, [ctypes.c_void_p]),
            "engine_allowed_tokens": (ctypes.c_int64, [
                ctypes.c_void_p, ctypes.c_void_p, i32p, ctypes.c_int64]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeTrie:
    """CSR form of a Tokenizer's byte trie, owned by the native library."""

    # Weak-keyed so an entry dies with its tokenizer: an id()-keyed dict
    # can hand back a stale trie once CPython reuses a freed tokenizer's id.
    _cache: "weakref.WeakKeyDictionary" = None  # created at first use
    _cache_lock = threading.Lock()

    def __init__(self, tokenizer):
        lib = get_lib()
        children = tokenizer._children
        n_nodes = len(children)
        edge_start = np.zeros(n_nodes + 1, np.int32)
        bytes_l, targets = [], []
        for i, ch in enumerate(children):
            edge_start[i] = len(bytes_l)
            for b in sorted(ch):
                bytes_l.append(b)
                targets.append(ch[b])
        edge_start[n_nodes] = len(bytes_l)
        # The library keeps pointers into these arrays: they live as long
        # as the trie.
        self._edge_start = edge_start
        self._edge_byte = np.asarray(bytes_l, np.uint8)
        self._edge_target = np.asarray(targets, np.int32)
        self._accept = np.asarray(tokenizer._accept, np.int32)
        self.ptr = lib.trie_new(
            _as_ptr(self._edge_start, ctypes.c_int32),
            _as_ptr(self._edge_byte, ctypes.c_uint8),
            _as_ptr(self._edge_target, ctypes.c_int32),
            _as_ptr(self._accept, ctypes.c_int32),
            n_nodes, len(bytes_l))
        self._lib = lib

    @classmethod
    def for_tokenizer(cls, tokenizer) -> "NativeTrie":
        with cls._cache_lock:
            if cls._cache is None:
                cls._cache = weakref.WeakKeyDictionary()
            t = cls._cache.get(tokenizer)
            if t is None:
                t = cls._cache[tokenizer] = cls(tokenizer)
            return t

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.trie_free(self.ptr)


class NativeGrammarEngine:
    """ctypes twin of ``grammar.GrammarEngine`` (the same interface)."""

    def __init__(self, text: str, start: str = "start"):
        from .grammar import lower_grammar

        lib = get_lib()
        data, classes, start_id = lower_grammar(text, start)
        self._data = np.asarray(data, np.int64)
        self._classes = np.asarray(classes, np.uint64).reshape(-1)
        self._lib = lib
        self._grammar = lib.grammar_new(
            _as_ptr(self._data, ctypes.c_int64), len(self._data),
            _as_ptr(self._classes, ctypes.c_uint64),
            len(self._classes) // 4, start_id)
        self._engine = lib.engine_new(self._grammar)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.engine_free(self._engine)
            lib.grammar_free_grammar(self._grammar)

    @property
    def dead(self) -> bool:
        return bool(self._lib.engine_dead(self._engine))

    def advance(self, data: bytes) -> bool:
        arr = np.frombuffer(data, np.uint8)
        if len(arr) == 0:
            return not self.dead
        return bool(self._lib.engine_advance(
            self._engine, _as_ptr(arr, ctypes.c_uint8), len(arr)))

    def can_finish(self) -> bool:
        return bool(self._lib.engine_can_finish(self._engine))

    def allowed_bytes(self) -> int:
        out = np.zeros(256, np.uint8)
        self._lib.engine_allowed_bytes(
            self._engine, _as_ptr(out, ctypes.c_uint8))
        mask = 0
        for b in np.nonzero(out)[0]:
            mask |= 1 << int(b)
        return mask

    def must_finish(self) -> bool:
        return self.can_finish() and self.allowed_bytes() == 0

    def allowed_tokens(self, tokenizer) -> list[int]:
        trie = NativeTrie.for_tokenizer(tokenizer)
        out = np.zeros(tokenizer.vocab_len + 1, np.int32)
        n = self._lib.engine_allowed_tokens(
            self._engine, trie.ptr, _as_ptr(out, ctypes.c_int32), len(out))
        return out[:n].tolist()


def make_grammar_engine(text: str, start: str = "start"):
    """The native Earley engine (raises if the library cannot be built)."""
    return NativeGrammarEngine(text, start)
