"""BNF-constrained generation of the port against the JAX package's, on the
CPU with one tiny f32 RWKV-7 (the JAX params carried across with
``params_from_numpy``) and the char tokenizer of ``tests/test_runtime.py``:

* a regular grammar (the device token DFA) and a non-regular one (the
  native Earley engine and the chunk replay) give the same greedy tokens
  and text in both packages, at ``decode_chunk_size`` 1 and 8;
* the runtime cases of ``tests/test_runtime.py`` on BNF (constrained
  generation, plain streams not slowed, speculation credit, chunked equals
  per-token, mirostat on the device DFA) hold on the port;
* the engine's DFA step: ``decode_chunk`` freezes a row whose grammar
  halted as a spent budget freezes it, reads one table row a row and never
  the whole ``(B, TH, V)`` pool, ``restore_last_chunk`` restores the DFA
  state, and ``AI00_DFA_STATES`` above 128 rows is refused;
* a forced ``dfa_map`` miss in ``_launch_chunk`` takes the row off the
  device DFA before the chunk that follows (the JAX runtime leaves it on).
"""

import asyncio

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax
import jax.numpy as jnp

from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.runtime import GenerateRequest as JRequest
from ai00_server_tpu.runtime import Runtime as JRuntime
from ai00_server_tpu.runtime import SamplerSpec as JSampler
from ai00_server_tpu.testing import make_tiny_model
from ai00_server_tpu.tokenizer import Tokenizer as JTokenizer

from ai00_server_tpu_torch import runtime as truntime
from ai00_server_tpu_torch.engine import Engine
from ai00_server_tpu_torch.grammar import GrammarEngine
from ai00_server_tpu_torch.loader import LoadedModel, params_from_numpy
from ai00_server_tpu_torch.ops import sampling
from ai00_server_tpu_torch.runtime import (GenerateRequest, Runtime,
                                           SamplerSpec)
from ai00_server_tpu_torch.tokenizer import Tokenizer

VOCAB = {i: bytes([64 + i]) for i in range(1, 60)}  # '@'... one char each
# Regular: halts after 6-7 tokens, inside one 8-token chunk.
REGULAR = "start ::= #'[A-F]{5}' ('HI' | 'BYE');"
# Not regular (centre recursion): the mask changes on the way, so the
# chunk replay rolls rows back (5 rollbacks at K = 8 with this model).
NON_REGULAR = "start ::= x start 'E' | 'C'; x ::= #'[A-D]';"


@pytest.fixture(scope="module")
def model():
    """(info, JAX params, port params) of the tiny v7 of test_runtime.py."""
    info, _, params = make_tiny_model(ModelVersion.V7, seed=5,
                                      dtype=np.float32, num_vocab=64)
    return info, params, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def port_engine(model, max_batch=4):
    return Engine(LoadedModel(info=model[0], params=model[2]),
                  max_batch=max_batch, token_chunk_size=8, device="cpu")


def greedy():
    return SamplerSpec(kind=sampling.KIND_GREEDY, presence_penalty=0.0,
                       frequency_penalty=0.0)


async def collect(handle):
    parts, reason, counter = [], None, None
    async for msg in handle:
        if msg[0] == "content":
            parts.append(msg[1])
        elif msg[0] == "stop":
            reason, counter = msg[1], msg[2]
    return "".join(parts), reason, counter


async def idle(rt):
    for _ in range(2000):
        if all(s.ctx is None for s in rt.slots):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("a slot never went idle")


def run_port(model, k, schema, prompt="ABC", n=16, sampler=None):
    async def main():
        rt = Runtime(port_engine(model), Tokenizer(VOCAB),
                     decode_chunk_size=k)
        rt.start()
        text, reason, counter = await collect(await rt.submit(
            GenerateRequest(prompt=prompt, max_tokens=n, bnf_schema=schema,
                            sampler=sampler or greedy())))
        await idle(rt)
        resident = rt.slots[0].resident_tokens
        metrics = dict(rt.metrics)
        await rt.stop()
        return (text, reason.value, counter.completion, resident), metrics

    return asyncio.run(main())


def run_jax(model, k, schema, prompt="ABC", n=16):
    async def main():
        eng = JEngine(JLoaded(info=model[0], params=model[1], init_wkv=None),
                      max_batch=4, token_chunk_size=8,
                      state_dtype=jnp.float32)
        rt = JRuntime(eng, JTokenizer(VOCAB), decode_chunk_size=k)
        rt.start()
        text, reason, counter = await collect(await rt.submit(JRequest(
            prompt=prompt, max_tokens=n, bnf_schema=schema,
            sampler=JSampler(kind=jsampling.KIND_GREEDY,
                             presence_penalty=0.0, frequency_penalty=0.0))))
        await idle(rt)
        resident = rt.slots[0].resident_tokens
        await rt.stop()
        return text, reason.value, counter.completion, resident

    return asyncio.run(main())


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("schema", [REGULAR, NON_REGULAR],
                         ids=["regular", "non_regular"])
def test_bnf_tokens_and_text_equal_jax(model, schema, k):
    """Greedy under a grammar: text, finish reason, completion count and
    the consumed tokens the slot keeps are exactly the JAX runtime's."""
    port, metrics = run_port(model, k, schema)
    assert port == run_jax(model, k, schema)
    g = GrammarEngine(schema)
    assert g.advance(port[0].encode()), port
    if port[1] == "stop":
        assert g.can_finish(), port
    if k > 1:
        dfa = schema == REGULAR
        assert metrics["bnf_dfa_requests"] == int(dfa), metrics
        assert metrics["bnf_replay_requests"] == int(not dfa), metrics
        assert metrics["chunk_launches"] > 0, metrics
        if not dfa:
            assert metrics["rollbacks"] > 0, metrics


# -- tests/test_runtime.py's BNF cases on the port ---------------------------


def test_bnf_constrained_generation(model):
    (text, reason, _, _), _ = run_port(model, 8, "start ::= 'HI' | 'BYE';",
                                       n=10)
    assert text in ("HI", "BYE")
    assert reason == "stop"


def test_bnf_does_not_deoptimize_plain_streams(model):
    """One BNF request leaves the plain streams beside it on the K-token
    chunk, and their text unchanged."""
    plain_prompts = ["ABCAB", "BCABC", "CABCA"]

    async def run(with_bnf):
        rt = Runtime(port_engine(model), Tokenizer(VOCAB))
        rt.start()
        handles = [await rt.submit(GenerateRequest(
            prompt=p, max_tokens=24, sampler=greedy()))
            for p in plain_prompts]
        bnf = (await rt.submit(GenerateRequest(
            prompt="ABC", max_tokens=10,
            bnf_schema="start ::= 'HI' | 'BYE';", sampler=greedy()))
            if with_bnf else None)
        texts = [(await collect(h))[0] for h in handles]
        bnf_text = (await collect(bnf))[0] if bnf else None
        steps = rt.metrics["steps"]
        await rt.stop()
        return texts, bnf_text, steps

    plain_ref, _, _ = asyncio.run(run(False))
    mixed, bnf_text, steps = asyncio.run(run(True))
    assert mixed == plain_ref
    assert bnf_text in ("HI", "BYE")
    # 3 rows x 24 tokens at K = 8: per-token steps would take over 72.
    assert steps < 40, f"too many device steps: {steps}"


def test_bnf_speculation_credit(model, monkeypatch):
    """Replay rows ride the chained successor only after a full-accept
    replay: a sticky grammar earns credit, a shifting one never does and
    parks per-token.  AI00_DFA_STATES=2 makes every table build overflow,
    forcing the replay path; with the device DFA the shifting grammar
    needs no rollback and no fallback."""
    def run(schema, n, dfa_states=None):
        if dfa_states is not None:
            monkeypatch.setenv("AI00_DFA_STATES", str(dfa_states))
        else:
            monkeypatch.delenv("AI00_DFA_STATES", raising=False)
        (text, *_), m = run_port(model, 4, schema, n=n)
        return text, m

    text, m = run("start ::= #'[A-D]{30}';", 30, dfa_states=2)
    assert len(text) == 30
    assert m["chunk_successors"] > 0, m
    assert m["bnf_accepted"] > 0, m

    text, m = run("start ::= #'(AB|CD){8}E';", 20, dfa_states=2)
    assert len(text) == 17, text
    assert m["chunk_successors"] == 0, m
    assert m["bnf_short_chunks"] > 0, m

    text, m = run("start ::= #'(AB|CD){8}E';", 20)
    assert len(text) == 17, text
    assert m["rollbacks"] == 0, m
    assert m["bnf_short_chunks"] == 0, m
    assert m["chunk_successors"] > 0, m


@pytest.mark.parametrize("schema", ["start ::= #'[A-D]{20}';",
                                    "start ::= ('AB' | 'CD')* 'E';"],
                         ids=["sticky", "shifting"])
def test_bnf_chunked_equals_per_token(model, schema):
    """Chunked BNF rows give what per-token steps give, and a plain request
    after them on the same runtime is unaffected."""
    async def run(k):
        rt = Runtime(port_engine(model), Tokenizer(VOCAB),
                     decode_chunk_size=k)
        rt.start()
        text, reason, _ = await collect(await rt.submit(GenerateRequest(
            prompt="ABC", max_tokens=24, bnf_schema=schema,
            sampler=greedy())))
        text2, *_ = await collect(await rt.submit(GenerateRequest(
            prompt="ABC", max_tokens=6, sampler=greedy())))
        await rt.flush_cache_stores()
        await rt.stop()
        return text, reason, text2

    assert asyncio.run(run(4)) == asyncio.run(run(1))


def test_bnf_mirostat_rides_device_dfa(model):
    """Mirostat with a regular grammar chunks on the device DFA (no
    mis-speculation, so no host rebuild of its adaptive state) and the
    output follows the grammar."""
    schema = ("start ::= '{' text '}';\n"
              "text ::= tchar | tchar text;\n"
              "tchar ::= 'A'|'B'|'C'|'D';\n")
    miro = SamplerSpec(kind=sampling.KIND_MIROSTAT, presence_penalty=0.0,
                       frequency_penalty=0.0)
    (text, reason, _, _), m = run_port(model, 4, schema, n=24, sampler=miro)
    assert m["chunk_launches"] > 0, m
    assert m["rollbacks"] == 0, m
    assert m["bnf_fallbacks"] == 0, m
    e = GrammarEngine(schema)
    assert text.startswith("{"), text
    assert e.advance(text.encode()), text
    if reason == "stop":
        assert e.can_finish() or text.endswith("}"), text


@pytest.mark.parametrize("k", [1, 8])
def test_start_nonterminal_from_the_bnf_option(model, k):
    """The ``[bnf]`` option's ``start_nonterminal`` names the rule that
    schemas start from, on the replay and the device-DFA paths."""
    async def main():
        rt = Runtime(port_engine(model), Tokenizer(VOCAB),
                     decode_chunk_size=k,
                     bnf_option={"start_nonterminal": "answer"})
        rt.start()
        out = await collect(await rt.submit(GenerateRequest(
            prompt="ABC", max_tokens=10, sampler=greedy(),
            bnf_schema="answer ::= 'HI' | 'BYE' | 'A' answer;")))
        await rt.stop()
        return out

    text, reason, _ = asyncio.run(main())
    assert text.lstrip("A") in ("HI", "BYE") or reason.value == "length", \
        text
    assert GrammarEngine("answer ::= 'HI' | 'BYE' | 'A' answer;",
                         start="answer").advance(text.encode())


def test_one_table_build_for_a_burst_of_one_grammar(model):
    """Requests of one grammar submitted together share one token-DFA
    build (the JAX runtime starts one a request)."""
    async def main():
        rt = Runtime(port_engine(model), Tokenizer(VOCAB),
                     decode_chunk_size=4)
        rt.start()
        handles = [await rt.submit(GenerateRequest(
            prompt=p, max_tokens=8, bnf_schema=REGULAR, sampler=greedy()))
            for p in ("ABC", "BCA", "CAB")]
        texts = [(await collect(h))[0] for h in handles]
        metrics = dict(rt.metrics)
        await rt.stop()
        return texts, metrics

    texts, m = asyncio.run(main())
    assert m["bnf_table_builds"] == 1 and m["bnf_dfa_requests"] == 3, m
    assert all(GrammarEngine(REGULAR).advance(t.encode()) for t in texts)


# -- the engine's DFA step ---------------------------------------------------


def halting_table(V: int) -> np.ndarray:
    """State 0: any token but end-of-text, to state 1; state 1: any token,
    and the grammar halts (row 2, the halt row)."""
    t = np.full((3, V), 1, np.int8)
    t[0, 0] = -1
    t[1] = 2
    t[2] = 2
    return t


def greedy_rows(eng):
    for b in range(eng.max_batch):
        eng.set_row_sampler(b, {"kind": sampling.KIND_GREEDY,
                                "presence": 0.0, "frequency": 0.0})


def test_decode_chunk_freezes_halted_row(model):
    """A row whose grammar halts after two tokens ends the chunk exactly as
    a row with a budget of two: the same tokens (the halting one repeated),
    model state and sampler state; the row beside it runs on."""
    V = model[0].num_vocab
    first = np.array([3, 7], np.int32)
    active = np.ones(2, np.bool_)
    dfa = port_engine(model, 2)
    ref = port_engine(model, 2)
    for e in (dfa, ref):
        greedy_rows(e)
    dfa.set_row_dfa(0, halting_table(V), 0)
    # The reference samples row 0's first token under the same mask.
    allowed = np.ones(V, np.bool_)
    allowed[0] = False
    ref.set_row_mask(0, allowed)
    toks, _ = dfa.decode_chunk(first, active, 5)
    want, _ = ref.decode_chunk(first, active, 5,
                               budget=np.array([2, 5], np.int32))
    np.testing.assert_array_equal(toks, want)
    assert toks[0, 0] != 0 and (toks[2:, 0] == toks[1, 0]).all()
    assert int(dfa.dfa_state[0]) == dfa.dfa_height - 1  # halted
    assert int(dfa.dfa_state[1]) == -1
    for k in dfa.state_pool:
        torch.testing.assert_close(dfa.state_pool[k], ref.state_pool[k],
                                   rtol=0, atol=0)
    for k in dfa.sampler_state:
        torch.testing.assert_close(dfa.sampler_state[k],
                                   ref.sampler_state[k], rtol=0, atol=0)


class _PoolReads(TorchDispatchMode):
    """Records every op that reads or writes a tensor on the pool's
    storage, with the shape of its result."""

    def __init__(self, pool):
        super().__init__()
        self.ptr = pool.untyped_storage().data_ptr()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(a, torch.Tensor)
               and a.untyped_storage().data_ptr() == self.ptr
               for a in tree_leaves((args, kwargs))):
            self.ops.append((func, tuple(out.shape)))
        return out


def test_decode_chunk_reads_one_table_row_a_row(model):
    """Each step of a DFA chunk gathers one (V,) row of each slot's table,
    a (B, V) int8 read, and nothing else of the (B, TH, V) pool (the JAX
    scan's ``take_along_axis`` runs over the whole pool)."""
    V = model[0].num_vocab
    eng = port_engine(model, 3)
    greedy_rows(eng)
    eng.set_row_dfa(1, halting_table(V), 0)
    steps = 4
    with _PoolReads(eng.dfa_pool) as reads:
        eng.decode_chunk(np.array([1, 2, 3], np.int32), np.ones(3, np.bool_),
                         steps)
    assert reads.ops == [(torch.ops.aten.index.Tensor, (3, V))] * steps, \
        reads.ops
    # Without a DFA row in the chunk, the pool is not read at all.
    eng.clear_row_dfa(1)
    with _PoolReads(eng.dfa_pool) as reads:
        eng.decode_chunk(np.array([1, 2, 3], np.int32), np.ones(3, np.bool_),
                         steps)
    assert reads.ops == []


def test_restore_last_chunk_restores_dfa_state(model):
    V = model[0].num_vocab
    eng = port_engine(model, 2)
    greedy_rows(eng)
    eng.set_row_dfa(0, halting_table(V), 0)
    eng.decode_chunk(np.array([3, 7], np.int32), np.ones(2, np.bool_), 3)
    before = eng.dfa_state.clone(), eng.dfa_rows.copy()
    eng.decode_chunk(np.array([3, 7], np.int32), np.ones(2, np.bool_), 3)
    eng.clear_row_dfa(0)
    eng.restore_last_chunk()
    torch.testing.assert_close(eng.dfa_state, before[0], rtol=0, atol=0)
    np.testing.assert_array_equal(eng.dfa_rows, before[1])


@pytest.mark.parametrize("value", ["200", "129", "1"])
def test_dfa_states_outside_the_int8_table_refused(model, monkeypatch,
                                                   value):
    """The JAX engine takes any AI00_DFA_STATES, and past 128 rows its
    int8 table wraps the state ids; the port refuses it."""
    monkeypatch.setenv("AI00_DFA_STATES", value)
    with pytest.raises(ValueError, match="AI00_DFA_STATES"):
        port_engine(model)
    monkeypatch.setenv("AI00_DFA_STATES", "128")
    assert port_engine(model).dfa_pool.shape[1] == 128


def test_dfa_map_miss_takes_the_row_off_the_device_dfa(model, monkeypatch):
    """A grammar state missing from ``dfa_map`` at the chunk launch sends
    the row to the replay path: ``clear_row_dfa`` runs before the chunk
    (the JAX runtime skips it and the chunk masks the row with its stale
    table row), and the text is the per-token text."""
    build = truntime._timed_dfa_table

    def empty_map(*args):
        res, seconds = build(*args)
        return (res[0], {}), seconds

    monkeypatch.setattr(truntime, "_timed_dfa_table", empty_map)

    async def main():
        eng = port_engine(model)
        seen = []
        launch = eng.decode_chunk

        def spy(*args, **kw):
            seen.append((int(eng.dfa_state[0]), bool(eng.dfa_rows[0])))
            return launch(*args, **kw)

        eng.decode_chunk = spy
        rt = Runtime(eng, Tokenizer(VOCAB), decode_chunk_size=4)
        rt.start()
        text, reason, _ = await collect(await rt.submit(GenerateRequest(
            prompt="ABC", max_tokens=16, bnf_schema=REGULAR,
            sampler=greedy())))
        metrics = dict(rt.metrics)
        await rt.stop()
        return text, reason.value, seen, metrics

    text, reason, seen, metrics = asyncio.run(main())
    assert metrics["bnf_dfa_requests"] == 1, metrics
    assert seen and all(s == (-1, False) for s in seen), seen
    (ref, ref_reason, _, _), _ = run_port(model, 1, REGULAR)
    assert (text, reason) == (ref, ref_reason)
