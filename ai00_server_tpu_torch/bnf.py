"""BNF-constrained generation (reference: crates/ai00-core/src/sampler/bnf.rs).

Port of ``ai00_server_tpu/bnf.py``.  The reference wraps the ``kbnf``
crate: compile a KBNF grammar against the tokenizer vocab, mask logits each
step, advance per accepted token, halt on grammar completion.  Here the
grammar engines are ``grammar.py`` and ``native.py``, exposed through the
same surface:

* ``allowed_mask() -> (V,) bool``: tokens that keep the output inside the
  grammar (bnf.rs:35-38 ``mask_logits``).
* ``accept(token) -> bool``: advance; True = grammar complete, halt
  generation (bnf.rs:40-47 ``update``).
"""

from __future__ import annotations

import numpy as np

from .grammar import make_dfa_engine
from .native import make_grammar_engine


class BnfFormatter:
    def __init__(self, schema: str, tokenizer, vocab: int,
                 start_nonterminal: str = "start"):
        # Regular grammars compile to a byte DFA whose small, closed state
        # set makes every token mask a one-time cost; non-regular ones take
        # the native (C++) Earley engine.
        self.engine = (make_dfa_engine(schema, start=start_nonterminal)
                       or make_grammar_engine(schema,
                                              start=start_nonterminal))
        self.tokenizer = tokenizer
        self.vocab = vocab
        self._finished = False

    def allowed_mask(self) -> np.ndarray:
        if self._finished:
            return np.ones(self.vocab, np.bool_)
        mask = np.zeros(self.vocab, np.bool_)
        ids = np.asarray(self.engine.allowed_tokens(self.tokenizer),
                         np.int64)
        if ids.size:
            mask[ids[ids < self.vocab]] = True
        # End-of-text is allowed once the grammar can complete.
        if self.engine.can_finish():
            mask[0] = True
        if not mask.any():
            # Dead grammar state: allow end-of-text so generation ends.
            mask[0] = True
        return mask

    def accept(self, token: int) -> bool:
        """Advance the grammar; returns True when generation must halt."""
        if self._finished or token == 0:
            self._finished = True
            return True
        data = self.tokenizer.token_to_bytes(token)
        if not self.engine.advance(data) or self.engine.must_finish():
            self._finished = True
            return True
        return False
