"""RWKV "world" tokenizer: greedy longest-match byte-level trie.

Port of ``ai00_server_tpu/tokenizer.py`` (framework-free; kept as this
package's own copy so the port imports nothing of the JAX package).

Behavioral contract (matches the engine used by the reference server,
see reference call sites crates/ai00-core/src/lib.rs:370-376 and
crates/ai00-core/src/run.rs:856):

* The vocabulary is a JSON object mapping token id (as a string) to either
  a unicode string (encoded as UTF-8 bytes) or a list of raw byte values.
  Ids are 1-based; id 0 is the implicit end-of-text / padding token and maps
  to the empty byte string.
* Encoding walks the input bytes greedily, always taking the longest
  matching token.  Every single byte is a token, so encoding never fails.
* A token decodes to its bytes (``token_to_bytes``); UTF-8 re-assembly
  across token boundaries is :class:`Utf8Buffer`'s job.

The encoder is a flat-array trie (nodes as dicts from next-byte to node id)
built once at load; encode is O(input_bytes * avg_token_len).
"""

from __future__ import annotations

import json
from pathlib import Path


class Tokenizer:
    """Greedy longest-match byte tokenizer over the RWKV world vocab."""

    def __init__(self, vocab: dict[int, bytes]):
        if not vocab:
            raise ValueError("empty vocabulary")
        max_id = max(vocab)
        # Padded so that token ids always index successfully; the model's
        # num_vocab may exceed the number of defined tokens (65529 defined,
        # 65536 logits).
        self._token_bytes: list[bytes] = [b""] * (max_id + 1)
        for tid, bs in vocab.items():
            if tid < 0:
                raise ValueError(f"negative token id {tid}")
            self._token_bytes[tid] = bs

        # Trie: list of dict[byte -> node]; node 0 is the root.
        # _accept[node] is the token id that ends at this node (0 = none).
        self._children: list[dict[int, int]] = [{}]
        self._accept: list[int] = [0]
        for tid, bs in vocab.items():
            if not bs:
                continue
            node = 0
            for b in bs:
                nxt = self._children[node].get(b)
                if nxt is None:
                    nxt = len(self._children)
                    self._children[node][b] = nxt
                    self._children.append({})
                    self._accept.append(0)
                node = nxt
            self._accept[node] = tid

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_file(cls, path: str | Path) -> "Tokenizer":
        text = Path(path).read_text(encoding="utf-8")
        return cls.from_json(text)

    @classmethod
    def from_json(cls, text: str) -> "Tokenizer":
        raw = json.loads(text)
        vocab: dict[int, bytes] = {}
        for key, value in raw.items():
            tid = int(key)
            if isinstance(value, str):
                vocab[tid] = value.encode("utf-8")
            elif isinstance(value, list):
                vocab[tid] = bytes(value)
            else:
                raise ValueError(f"token {key}: unsupported value {type(value)}")
        return cls(vocab)

    # ------------------------------------------------------------------
    # Encode / decode
    # ------------------------------------------------------------------

    @property
    def vocab_len(self) -> int:
        """Number of token slots (max defined id + 1)."""
        return len(self._token_bytes)

    @property
    def fingerprint(self) -> str:
        """Stable content hash of the vocabulary (computed once).

        Cache keys that outlive a tokenizer instance (the grammar token-DFA
        cache across model reloads) use this, not ``id(tokenizer)``: CPython
        reuses addresses, so a freed tokenizer's id can alias another
        vocabulary's."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            import hashlib

            h = hashlib.sha1()
            for bs in self._token_bytes:
                h.update(len(bs).to_bytes(2, "little"))
                h.update(bs)
            fp = self._fingerprint = h.hexdigest()
        return fp

    def token_to_bytes(self, token: int) -> bytes:
        """Bytes for a token id; ids beyond the defined vocab (the model's
        padded logit rows, e.g. 65529..65535) decode to nothing."""
        if 0 <= token < len(self._token_bytes):
            return self._token_bytes[token]
        return b""

    def encode_bytes(self, data: bytes) -> list[int]:
        children = self._children
        accept = self._accept
        out: list[int] = []
        i = 0
        n = len(data)
        while i < n:
            node = children[0].get(data[i])
            if node is None:
                # Byte not in vocabulary at the root: unencodable byte.
                # The world vocab covers all 256 single bytes so this only
                # happens with a custom/truncated vocab; skip the byte.
                i += 1
                continue
            best_tid = accept[node]
            best_end = i + 1
            j = i + 1
            while j < n:
                node = children[node].get(data[j])
                if node is None:
                    break
                j += 1
                if accept[node]:
                    best_tid = accept[node]
                    best_end = j
            if best_tid == 0:
                # No accepting prefix (single byte missing from vocab).
                i += 1
                continue
            out.append(best_tid)
            i = best_end
        return out

    def encode(self, text: str) -> list[int]:
        return self.encode_bytes(text.encode("utf-8"))


class Utf8Buffer:
    """Incremental UTF-8 decoder for streaming token-by-token output.

    Tokens can split multi-byte characters; the reference buffers raw bytes
    and only emits completed characters (run.rs:865-869).  This wraps the
    stdlib incremental decoder with replacement only at stream end.
    """

    def __init__(self):
        self._pending = b""

    def push(self, data: bytes) -> str:
        """Feed bytes, return any completed characters."""
        buf = self._pending + data
        self._pending = b""
        out: list[str] = []
        while buf:
            try:
                out.append(buf.decode("utf-8"))
                buf = b""
            except UnicodeDecodeError as e:
                if e.reason == "unexpected end of data" and e.end == len(buf):
                    # Truncated multi-byte char at the end: hold it back.
                    out.append(buf[: e.start].decode("utf-8"))
                    self._pending = buf[e.start :]
                    buf = b""
                else:
                    # Genuinely invalid byte: emit prefix + replacement.
                    out.append(buf[: e.start].decode("utf-8"))
                    out.append("�")
                    buf = buf[e.start + 1 :]
        return "".join(out)

    def flush(self) -> str:
        """Emit any trailing partial character as replacement chars."""
        tail = self._pending.decode("utf-8", errors="replace")
        self._pending = b""
        return tail
