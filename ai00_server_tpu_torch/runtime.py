"""Batched generation runtime: slots, prefix cache, generation loop.

Port of ``ai00_server_tpu/runtime.py`` for completion and chat requests
(BNF-constrained ones included), choose (perplexity ranking) and pooled
state requests (embeddings); custom initial states are a later ROADMAP
item:

* Continuous batching over ``max_batch`` slots: ONE async drive loop
  gathers the runnable slots each iteration, builds a merged fixed-shape
  ``(B, T)`` step (prefill chunks and per-token decode) and dispatches it
  to the Engine on a dedicated worker thread.
* Steady-state decode rows advance K tokens per :meth:`Engine.decode_chunk`
  launch; the successor chunk is launched speculatively from the previous
  chunk's device-resident last tokens BEFORE the host reads its tokens.
* Slot selection Continue > Empty > Back: prefer a slot whose resident
  state already matches a strict prompt prefix, then an empty slot, then
  the least-recently-used idle slot.
* Prompt-prefix state cache: a token trie of host-RAM state snapshots
  (plus prompt-end logits for the exact-hit fast path) with LRU eviction
  at 256 items and a >=32-token insert threshold, and in-flight futures so
  concurrent identical prompts await one prefill.
* Per-token post-processing: UTF-8-safe streaming, incremental stop-word
  hold-back, max_tokens / EOS handling, token/duration accounting.
* BNF rows (``GenerateRequest.bnf_schema``, ``bnf.BnfFormatter``).  A
  regular grammar gets the device token DFA (``grammar.token_dfa_table``,
  built off the loop at submit): its rows ride the K-token chunk with
  exact per-step masks and halt on the device.  A non-regular grammar
  takes the native Earley engine: its rows sample under the mask of their
  current grammar state (``Engine.mask_pool``), and after each chunk the
  host replays the tokens through the grammar and keeps the prefix sampled
  while the true mask stayed unchanged (rolling the row back past it);
  rows whose mask keeps shifting fall back to per-token steps.
* CHOOSE and STATE requests exit after their prefill: a choose scores each
  choice from a copy of the row's state (``Engine.position_logps``); a
  pooled STATE request returns its embedding, the mean-hidden readout of
  the hidden sums its own prefill accumulated (its whole prompt runs from
  a fresh state: no prefix-cache checkout, no resident continue) or the
  pooled state (``pooling="state"``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

import numpy as np

from .bnf import BnfFormatter
from .engine import Engine, to_host
from .grammar import token_dfa_table
from .ops import sampling
from .tokenizer import Tokenizer, Utf8Buffer

logger = logging.getLogger("ai00_server_tpu_torch")

MAX_CACHE_ITEMS = 256
MIN_PROMPT_CACHE_TOKENS = 32
END_OF_TEXT = 0


# ---------------------------------------------------------------------------
# Request/response types
# ---------------------------------------------------------------------------


class GenerateKind(Enum):
    GENERATE = "generate"
    CHOOSE = "choose"
    STATE = "state"


@dataclass
class SamplerSpec:
    """Host-side sampler config -> engine row params."""
    kind: int = sampling.KIND_NUCLEUS
    top_p: float = 0.5
    top_k: int = 128
    temperature: float = 1.0
    presence_penalty: float = 0.3
    frequency_penalty: float = 0.3
    penalty_decay: float = 0.99654026
    miro_tau: float = 3.0
    miro_rate: float = 0.1

    def row_params(self) -> dict:
        # top_k <= 0 means "no top-k truncation" (the full-vocab bucket).
        return {
            "kind": self.kind,
            "top_p": self.top_p,
            "top_k": max(0, int(self.top_k)),
            "temperature": self.temperature,
            "presence": self.presence_penalty,
            "frequency": self.frequency_penalty,
            "decay": self.penalty_decay,
            "miro_tau": self.miro_tau,
            "miro_rate": self.miro_rate,
        }


@dataclass
class GenerateRequest:
    prompt: str = ""
    model_text: str = ""           # model-authored text for penalty init
    max_tokens: int = 256
    stop: list[str] = field(default_factory=list)
    bias: dict[int, float] = field(default_factory=dict)
    sampler: SamplerSpec = field(default_factory=SamplerSpec)
    kind: GenerateKind = GenerateKind.GENERATE
    choices: list[str] = field(default_factory=list)
    calibrate: bool = False
    # STATE requests: return the pooled embedding vector instead of the
    # full state.
    pooled: bool = False
    # Pooled readout: "mean_hidden" (C dims, the masked mean of the final
    # hidden states; the default) or "state" (3C dims, the pooled state).
    pooling: Optional[str] = None
    bnf_schema: Optional[str] = None  # KBNF grammar the output must follow

    def effective_pooling(self) -> str:
        return self.pooling or "mean_hidden"


class FinishReason(str, Enum):
    STOP = "stop"
    LENGTH = "length"
    ABORT = "abort"
    NULL = "null"


@dataclass
class TokenCounter:
    prompt: int = 0
    completion: int = 0
    duration: float = 0.0

    @property
    def total(self) -> int:
        return self.prompt + self.completion


class GenerateHandle:
    """Per-request message stream.

    Messages: ("start",) ("content", str) ("choose", perplexities)
    ("embed_vec", vector) ("embed", state) ("stop", FinishReason,
    TokenCounter) ("done",)
    """

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.aborted = False

    def cancel(self) -> None:
        self.aborted = True

    async def __aiter__(self):
        while True:
            msg = await self.queue.get()
            yield msg
            if msg[0] == "done":
                return


# ---------------------------------------------------------------------------
# Prompt-prefix trie cache
# ---------------------------------------------------------------------------


class _LazyLogitsRow:
    """One row of a device (B, V) logits tensor, copied to the host at most
    once, off the drive loop's critical path."""

    __slots__ = ("_dev", "_b", "_np")

    def __init__(self, dev, b):
        self._dev = dev
        self._b = b
        self._np = None

    def get(self) -> np.ndarray:
        if self._np is None:
            self._np = to_host(self._dev[self._b])
            self._dev = None
        return self._np


@dataclass
class CachedItem:
    state: Any                 # host batch-1 state dict (numpy)
    logits: np.ndarray | None  # (V,) prompt-end logits (exact-hit fast path)
    tokens: tuple[int, ...]
    instant: float = field(default_factory=time.monotonic)


class _TrieNode:
    __slots__ = ("children", "item")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.item: CachedItem | asyncio.Future | None = None


class StateCache:
    """Token-trie of state snapshots."""

    def __init__(self):
        self.root = _TrieNode()
        self.count = 0

    def longest_prefix(self, tokens: tuple[int, ...], strict: bool = False):
        """Deepest ancestor of ``tokens`` holding an item.  ``strict``
        restricts to proper prefixes.  Returns (prefix_len, item) or
        (0, None)."""
        node = self.root
        best = (0, None)
        limit = len(tokens) - 1 if strict else len(tokens)
        for i, t in enumerate(tokens):
            if i >= limit + 1:
                break
            node = node.children.get(t)
            if node is None:
                break
            if node.item is not None and (i + 1) <= limit:
                best = (i + 1, node.item)
        return best

    def insert(self, tokens: tuple[int, ...], item) -> None:
        node = self.root
        for t in tokens:
            nxt = node.children.get(t)
            if nxt is None:
                nxt = _TrieNode()
                node.children[t] = nxt
            node = nxt
        if node.item is None:
            self.count += 1
        node.item = item

    def remove(self, tokens: tuple[int, ...]) -> None:
        node = self.root
        for t in tokens:
            node = node.children.get(t)
            if node is None:
                return
        if node.item is not None:
            node.item = None
            self.count -= 1

    def entries(self):
        out = []

        def walk(node, prefix):
            if node.item is not None:
                out.append((tuple(prefix), node.item))
            for t, child in node.children.items():
                prefix.append(t)
                walk(child, prefix)
                prefix.pop()

        walk(self.root, [])
        return out

    def maintain(self) -> None:
        """LRU-evict ready items beyond MAX_CACHE_ITEMS."""
        if self.count <= MAX_CACHE_ITEMS:
            return
        ready = [(k, v) for k, v in self.entries()
                 if isinstance(v, CachedItem)]
        ready.sort(key=lambda kv: kv[1].instant)
        for k, _ in ready[: self.count - MAX_CACHE_ITEMS]:
            self.remove(k)


# ---------------------------------------------------------------------------
# Stop-word incremental matcher
# ---------------------------------------------------------------------------


class StopMatcher:
    """Byte-level hold-back matcher: emits only bytes that can no longer be
    part of a stop word; signals a hit when a stop word completes."""

    def __init__(self, stops: list[str]):
        self.stops = [s.encode("utf-8") for s in stops if s]
        self.held = b""

    def push(self, data: bytes) -> tuple[bytes, bool]:
        """Returns (emittable_bytes, stopped)."""
        if not self.stops:
            return data, False
        buf = self.held + data
        for s in self.stops:
            idx = buf.find(s)
            if idx != -1:
                self.held = b""
                return buf[:idx], True
        # Longest suffix of buf that is a proper prefix of any stop word.
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        self.held = buf[len(buf) - hold:] if hold else b""
        return buf[: len(buf) - hold], False

    def flush(self) -> bytes:
        out, self.held = self.held, b""
        return out


# ---------------------------------------------------------------------------
# BNF helpers (run on executor threads)
# ---------------------------------------------------------------------------


def _timed_dfa_table(schema, tokenizer, vocab, start, max_states):
    """``(grammar.token_dfa_table(...), seconds it took)``."""
    t0 = time.monotonic()
    res = token_dfa_table(schema, tokenizer, vocab, start=start,
                          max_states=max_states)
    return res, time.monotonic() - t0


def _replay(ctx, toks) -> tuple[int, bool, Any]:
    """Advance a BNF row's grammar through the tokens a chunk sampled.
    Returns ``(acc, halted, new_mask)``: the accepted count, whether the
    grammar completed on the last accepted token, and the first mask that
    differs from the one the chunk sampled under (None: none did).  A
    device-DFA row sampled every token under its exact mask, so its walk
    only advances the books and finds the halt."""
    acc, halted, new_mask = 0, False, None
    for t in toks:
        halted = ctx.formatter.accept(int(t))
        acc += 1
        if halted:
            break
        if ctx.dfa_table is not None:
            continue
        m = ctx.formatter.allowed_mask()
        if ctx.bnf_mask is None or not np.array_equal(m, ctx.bnf_mask):
            new_mask = m
            break
    return acc, halted, new_mask


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------


class _SlotPhase(Enum):
    IDLE = "idle"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclass
class _Slot:
    index: int
    phase: _SlotPhase = _SlotPhase.IDLE
    resident_tokens: tuple[int, ...] = ()
    idle_since: float = field(default_factory=time.monotonic)
    ctx: Optional["_ReqCtx"] = None


@dataclass
class _ReqCtx:
    request: GenerateRequest
    handle: GenerateHandle
    prompt_tokens: tuple[int, ...]
    model_tokens: tuple[int, ...]
    remaining: list[int]             # prompt tokens still to feed
    all_tokens: list[int] = field(default_factory=list)
    utf8: Utf8Buffer = field(default_factory=Utf8Buffer)
    stop: StopMatcher | None = None
    formatter: Any = None            # BnfFormatter or None
    counter: TokenCounter = field(default_factory=TokenCounter)
    start_time: float = field(default_factory=time.monotonic)
    cache_future: asyncio.Future | None = None
    prefill_cached: bool = False
    prefill_logits: Any = None
    # Deadline for deferring admission on an in-flight prefix-cache future
    # (0 = not deferring yet).
    defer_deadline: float = 0.0
    # BNF replay rows: the row's uploaded allowed mask (None = not computed
    # yet), dirtied whenever the grammar advances; bnf_misses counts
    # consecutive chunks cut short by a mask change, and two of them park
    # the row in per-token steps (bnf_no_chunk) until two steps under an
    # unchanged mask (bnf_sticky) bring it back.
    bnf_mask: Any = None
    bnf_dirty: bool = True
    bnf_misses: int = 0
    bnf_no_chunk: bool = False
    bnf_sticky: int = 0
    # Speculation credit: True after the row's last replay accepted every
    # token under an unchanged mask.  A row without it decodes at the base
    # chunk size with no chained successor, so a mask change does not waste
    # a 4x chunk in flight.
    bnf_full_accept: bool = False
    # Mask-ahead: the next allowed_mask() of a per-token row, started on
    # the executor the moment the grammar advances.
    bnf_future: Any = None
    # Device token DFA (regular grammars): dfa_future resolves to
    # ((table, state_map) or None, build seconds); dfa_stale marks grammar
    # advances on the host (per-token accepts) that the device state must
    # take before the next chunk.
    dfa_future: Any = None
    dfa_table: Any = None
    dfa_map: Any = None
    dfa_key: Any = None
    dfa_stale: bool = False


class Runtime:
    """The batched runtime for one loaded model."""

    def __init__(self, engine: Engine, tokenizer: Tokenizer,
                 decode_chunk_size: int = 8, bnf_option: dict | None = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.max_batch = engine.max_batch
        self.chunk = engine.token_chunk_size
        # Tokens decoded per device launch when every active slot is in
        # steady-state decode.  1 = per-token stepping.
        self.decode_chunk_size = max(1, int(decode_chunk_size))
        # BnfOption (reload.rs:80-86): the start nonterminal of schemas.
        self.bnf_option = bnf_option or {}
        self.slots = [_Slot(i) for i in range(self.max_batch)]
        self.cache = StateCache()
        self.pending: list[_ReqCtx] = []
        self._wake = asyncio.Event()
        self._stopped = False
        self._task: asyncio.Task | None = None
        self._cache_stores: set = set()
        # In-flight decode chunk (tokens still on the device).
        self._spec = None
        # One worker thread for every engine call on the drive path, so
        # device work is issued in the order the drive loop decided it.
        self._device_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine-drive")
        # (hsum_serial, (B, C) numpy): the coalesced embed readout, only
        # touched from the engine's worker thread.
        self._hsum_snap = None
        # Scheduler counters, touched on the loop only: device steps
        # (merged steps and consumed chunks), chunk launches and chained
        # successors, row rollbacks; the BNF rows' accepted replay tokens,
        # short chunks (acc <= 2), per-token fallbacks and returns to
        # chunks, the requests that took the device DFA or the Earley
        # replay, and the token-DFA table builds and their seconds (a
        # table is built once in flight a grammar, and cached).
        self.metrics = {
            "steps": 0, "chunk_launches": 0, "chunk_successors": 0,
            "rollbacks": 0, "bnf_accepted": 0, "bnf_short_chunks": 0,
            "bnf_fallbacks": 0, "bnf_rehabs": 0, "bnf_dfa_requests": 0,
            "bnf_replay_requests": 0, "bnf_table_builds": 0,
            "bnf_table_s": 0.0,
        }
        self._dfa_builds: dict = {}  # (schema, start) -> in-flight build

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._drive())

    async def stop(self) -> None:
        """Stop the drive loop and drain: every in-flight request's stream
        ends with ABORT and every queued request is failed."""
        self._stopped = True
        self._wake.set()
        if self._task:
            await self._task
        await self._abandon_spec()
        for s in self.slots:
            if s.ctx is not None:
                try:
                    await self._finalize(s, FinishReason.ABORT)
                except Exception:
                    logger.exception("drain: finalize failed")
                    s.phase = _SlotPhase.IDLE
                    s.ctx = None
                    s.resident_tokens = ()
        for ctx in self.pending:
            await ctx.handle.queue.put(
                ("stop", FinishReason.ABORT, ctx.counter))
            await ctx.handle.queue.put(("done",))
        self.pending = []
        await self.flush_cache_stores()
        self._device_pool.shutdown(wait=True)

    async def _abandon_spec(self) -> None:
        """Discard an in-flight speculative chunk (crash recovery /
        shutdown): its device state is rolled back so row states match
        their books."""
        if self._spec is None:
            return
        self._spec = None
        loop = asyncio.get_event_loop()
        try:
            await loop.run_in_executor(self._device_pool,
                                       self.engine.restore_last_chunk)
        except Exception:
            logger.exception("speculative-chunk rollback failed")

    def _dfa_build(self, key) -> asyncio.Future:
        """The future of ``key``'s token-DFA table: one build in flight a
        grammar, however many requests carry it (a burst of one grammar
        would otherwise build its table once a request, all at once)."""
        fut = self._dfa_builds.get(key)
        if fut is not None:
            return fut
        schema, start = key
        fut = asyncio.get_event_loop().run_in_executor(
            None, _timed_dfa_table, schema, self.tokenizer, self.engine.vocab,
            start, self.engine.dfa_height - 1)
        self._dfa_builds[key] = fut

        def done(f):
            del self._dfa_builds[key]
            if not f.cancelled() and f.exception() is None:
                self.metrics["bnf_table_builds"] += 1
                self.metrics["bnf_table_s"] += f.result()[1]

        fut.add_done_callback(done)
        return fut

    async def submit(self, request: GenerateRequest) -> GenerateHandle:
        """Queue a generation; returns the per-request handle."""
        handle = GenerateHandle()
        prompt_tokens = tuple(self.tokenizer.encode(request.prompt)) or (
            END_OF_TEXT,)
        ctx = _ReqCtx(
            request=request,
            handle=handle,
            prompt_tokens=prompt_tokens,
            model_tokens=tuple(self.tokenizer.encode(request.model_text)),
            remaining=list(prompt_tokens),
        )
        ctx.counter.prompt = len(prompt_tokens)
        ctx.stop = StopMatcher(request.stop)
        if request.bnf_schema:
            start_nt = self.bnf_option.get("start_nonterminal", "start")
            ctx.formatter = BnfFormatter(
                request.bnf_schema, self.tokenizer, self.engine.vocab,
                start_nonterminal=start_nt)
            if self.decode_chunk_size > 1:
                # The token-DFA table (cached per grammar) builds off the
                # loop; _install awaits it.  Mirostat rows take it too: the
                # DFA never mis-speculates, so their adaptive state never
                # needs the host rebuild that bars them from the replay.
                ctx.dfa_key = (request.bnf_schema, start_nt)
                ctx.dfa_future = self._dfa_build(ctx.dfa_key)
        self.pending.append(ctx)
        self._wake.set()
        return handle

    # ------------------------------------------------------------------
    # Drive loop
    # ------------------------------------------------------------------

    async def _drive(self) -> None:
        """Top-level drive loop with crash isolation: an exception in one
        iteration fails the affected requests and resets the slots instead
        of killing the loop."""
        fail_streak = 0
        while not self._stopped:
            try:
                await self._drive_once()
                fail_streak = 0
            except asyncio.CancelledError:
                raise
            except Exception:
                fail_streak += 1
                if fail_streak <= 3:
                    logger.exception(
                        "runtime step failed; resetting busy slots")
                elif fail_streak % 100 == 0:
                    logger.error("runtime step still failing (%d in a row)",
                                 fail_streak)
                await asyncio.sleep(min(0.05 * fail_streak, 5.0))
                await self._abandon_spec()
                for s in self.slots:
                    if s.ctx is not None:
                        try:
                            await self._finalize(s, FinishReason.ABORT)
                        except Exception:
                            s.phase = _SlotPhase.IDLE
                            s.ctx = None
                    # After a mid-step failure the pool rows can no longer
                    # be trusted to match the books.
                    s.resident_tokens = ()

    async def _drive_once(self) -> None:
        loop = asyncio.get_event_loop()
        was_idle = all(s.phase == _SlotPhase.IDLE for s in self.slots)
        await self._admit()
        if was_idle and any(s.phase == _SlotPhase.PREFILL
                            for s in self.slots):
            # Admission grace from idle: let the rest of a burst land so
            # every row shares one merged prefill step.
            await asyncio.sleep(0.002)
            await self._admit()
        active = [s for s in self.slots if s.phase != _SlotPhase.IDLE]
        if not active:
            self._wake.clear()
            if self.pending:
                return
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
            return

        # Steady-state decode rows advance K tokens per chunk launch;
        # prefill rows and BNF rows parked per-token take merged steps.
        if self.decode_chunk_size > 1:
            chunkable = [s for s in active if s.phase == _SlotPhase.DECODE
                         and self._can_chunk(s.ctx)]
        else:
            chunkable = []
        rest = [s for s in active if s not in chunkable]
        if self._spec is not None:
            await self._consume_chunk(loop, chunkable)
        elif chunkable:
            self._spec = await self._launch_chunk(
                loop, chunkable, self._pick_k())
        if rest:
            await self._merged_step(loop, rest)

    async def _merged_step(self, loop, rows) -> None:
        """One fixed-shape merged step over ``rows`` (prefill chunks +
        per-token decode); other rows ride along with length 0."""
        B = self.max_batch
        T = 1
        for s in rows:
            if s.phase == _SlotPhase.PREFILL and len(s.ctx.remaining) > 1:
                T = self.chunk
                break
        tokens = np.zeros((B, T), np.int32)
        lengths = np.zeros(B, np.int32)
        sample_mask = np.zeros(B, np.bool_)
        completing = []  # slots whose prefill finishes this step
        for s in rows:
            ctx = s.ctx
            if s.phase == _SlotPhase.PREFILL:
                n = min(len(ctx.remaining), T)
                tokens[s.index, :n] = ctx.remaining[:n]
                lengths[s.index] = n
                if n == len(ctx.remaining):
                    completing.append(s)
                    sample_mask[s.index] = (
                        ctx.request.kind == GenerateKind.GENERATE)
            else:  # DECODE
                tokens[s.index, 0] = ctx.all_tokens[-1]
                lengths[s.index] = 1
                sample_mask[s.index] = True

        # BNF masks are computed on the host and uploaded before the step
        # (recomputed only after the grammar advanced; the mask-ahead of
        # the previous step has usually finished by now).
        bnf_rows = [s for s in rows
                    if s.ctx.formatter is not None and sample_mask[s.index]]
        if bnf_rows:
            await asyncio.gather(*[self._refresh_bnf_mask(loop, s)
                                   for s in bnf_rows])

        result = await loop.run_in_executor(
            self._device_pool, self.engine.step, tokens, lengths,
            sample_mask, bool(completing))
        self.metrics["steps"] += 1

        for s in completing:
            if result.logits is not None:
                s.ctx.prefill_logits = _LazyLogitsRow(result.logits, s.index)

        for s in list(rows):
            await self._advance(s, lengths, sample_mask, result)

    def _can_chunk(self, ctx) -> bool:
        """Whether a decode row joins the K-token chunk.  Device-DFA rows
        always do (exact masks inside the chunk); replay rows unless their
        mask keeps shifting (bnf_no_chunk) or they are mirostat rows, whose
        adaptive state the host cannot rebuild after a mis-speculation."""
        if ctx.formatter is None or ctx.dfa_table is not None:
            return True
        return (not ctx.bnf_no_chunk
                and ctx.request.sampler.kind != sampling.KIND_MIROSTAT)

    async def _refresh_bnf_mask(self, loop, slot) -> None:
        """Bring the row's mask_pool row up to date with its grammar state
        (the mask is computed off the loop)."""
        ctx = slot.ctx
        if ctx.formatter is None:
            return
        # Collect any mask-ahead before the dirty check: nothing may
        # advance the grammar (the chunk replay does, on another thread)
        # while an allowed_mask() is pending; the engines are not
        # thread-safe.
        mask = None
        if ctx.bnf_future is not None:
            mask = await ctx.bnf_future
            ctx.bnf_future = None
        if not ctx.bnf_dirty:
            return
        if mask is None:
            mask = await loop.run_in_executor(None,
                                              ctx.formatter.allowed_mask)
        ctx.bnf_dirty = False
        if ctx.bnf_mask is not None and np.array_equal(mask, ctx.bnf_mask):
            # Unchanged mask: a sticky region.  A row parked per-token by an
            # earlier shifting stretch returns to chunks after two sticky
            # steps: bnf_no_chunk is a property of the region.
            if ctx.bnf_no_chunk:
                ctx.bnf_sticky += 1
                if ctx.bnf_sticky >= 2:
                    ctx.bnf_no_chunk = False
                    ctx.bnf_misses = 0
                    ctx.bnf_sticky = 0
                    self.metrics["bnf_rehabs"] += 1
            return
        ctx.bnf_sticky = 0
        ctx.bnf_mask = mask
        await loop.run_in_executor(self._device_pool, self.engine.set_row_mask,
                                   slot.index, mask)

    def _rebuild_sampler_state(self, b: int, ctx) -> None:
        """Recompute row ``b``'s penalty state on the host from the accepted
        tokens and upload it, after a mis-speculation rolled the row back
        (the device recurrence ``pen = pen * decay; pen[tok] = seen ?
        pen[tok] + frequency : presence`` is a pure function of them)."""
        sp = ctx.request.sampler
        pen, seen = sampling.init_penalties_host(
            list(ctx.model_tokens), self.engine.vocab,
            sp.presence_penalty, sp.frequency_penalty, sp.penalty_decay)
        decay = np.float32(sp.penalty_decay)
        freq = np.float32(sp.frequency_penalty)
        pres = np.float32(sp.presence_penalty)
        for tok in ctx.all_tokens[len(ctx.prompt_tokens):]:
            pen *= decay
            pen[tok] = (pen[tok] + freq) if seen[tok] else pres
            seen[tok] = True
        self.engine.set_row_sampler_state(b, pen, seen)

    async def _sync_bnf_rows(self, loop, active) -> None:
        """Before a chunk launch: a device-DFA row takes the grammar state
        the host reached outside a chunk (its first token, sampled by the
        prefill step); a replay row gets its current mask."""
        for s in active:
            ctx = s.ctx
            if ctx.formatter is None:
                continue
            if ctx.dfa_table is None:
                await self._refresh_bnf_mask(loop, s)
                continue
            if ctx.bnf_future is not None:
                await ctx.bnf_future
                ctx.bnf_future = None
            if not ctx.dfa_stale:
                continue
            st = ctx.dfa_map.get(int(getattr(ctx.formatter.engine, "state",
                                             -1)))
            if st is None:
                # The host grammar state has no table row (every host
                # accept walks the table's transitions from row 0, so this
                # should not happen): take the row off the device DFA
                # before it takes the replay path, or the chunk would
                # still sample it under the stale table row.
                await loop.run_in_executor(
                    self._device_pool, self.engine.clear_row_dfa, s.index)
                ctx.dfa_table = None
                await self._refresh_bnf_mask(loop, s)
                continue
            await loop.run_in_executor(
                self._device_pool, self.engine.set_row_dfa_state, s.index,
                st)
            ctx.dfa_stale = False

    async def _launch_chunk(self, loop, active, K, first_device=None,
                            consumed=None):
        """Launch a decode chunk WITHOUT downloading its tokens.

        Returns the in-flight record.  ``first_device`` chains a
        speculative chunk from the previous chunk's device-resident last
        tokens; rows not in its covering set supply their first token from
        the host, as do the rows whose device tokens a BNF mis-speculation
        made stale (``first_device["dead"]``).  Each row gets a token
        BUDGET = its remaining max_tokens (minus what the chunk being
        consumed delivers, ``consumed``); rows whose budget would be zero
        are left out."""
        B = self.max_batch
        consumed = consumed or {}
        budgets = {}
        for s in active:
            rem = (s.ctx.request.max_tokens - s.ctx.counter.completion
                   - consumed.get(s.index, 0))
            if rem > 0:
                budgets[s.index] = min(rem, K)
        active = [s for s in active if s.index in budgets]
        if not active:
            return None
        await self._sync_bnf_rows(loop, active)
        mask = np.zeros(B, np.bool_)
        budget = np.zeros(B, np.int32)
        for s in active:
            mask[s.index] = True
            budget[s.index] = budgets[s.index]
        host_first = None
        if first_device is None:
            first = np.zeros(B, np.int32)
            for s in active:
                first[s.index] = s.ctx.all_tokens[-1]
        else:
            first = first_device["toks"]
            joining = [s for s in active
                       if s.index not in first_device["rows"]
                       or s.index in first_device["dead"]]
            if joining:
                hmask = np.zeros(B, np.bool_)
                hvals = np.zeros(B, np.int32)
                for s in joining:
                    hmask[s.index] = True
                    hvals[s.index] = s.ctx.all_tokens[-1]
                host_first = (hmask, hvals)
        toks_seq, _sp = await loop.run_in_executor(
            self._device_pool, lambda: self.engine.decode_chunk(
                first, mask, K, sync=False, host_first=host_first,
                budget=budget))
        self.metrics["chunk_launches"] += 1
        if first_device is not None:
            self.metrics["chunk_successors"] += 1
        return {"toks": toks_seq,
                "entries": [(s, s.ctx) for s in active],
                "rows": frozenset(s.index for s in active), "K": K,
                "budgets": budgets, "dead": set()}

    def _pick_k(self):
        """Chunk size for the next decode chunk: 4x the base when no
        request is waiting to join (per-row budgets make any size safe) and
        every BNF replay row holds speculation credit, else the base so new
        arrivals join quickly and a mask change wastes little."""
        base = self.decode_chunk_size
        if not self.pending and all(
                s.phase == _SlotPhase.DECODE and self._has_credit(s.ctx)
                for s in self.slots if s.ctx is not None):
            return base * 4
        return base

    @staticmethod
    def _has_credit(ctx) -> bool:
        """Plain and device-DFA rows always hold speculation credit; a
        replay row after its last replay accepted every token."""
        return (ctx.formatter is None or ctx.dfa_table is not None
                or ctx.bnf_full_accept)

    async def _consume_chunk(self, loop, chunkable) -> None:
        """Consume the in-flight decode chunk (pipelined).

        In steady state the successor chunk — over every currently
        chunkable row — launches BEFORE the token download, so the host
        sync overlaps the next chunk's device compute.  A row that stops
        mid-chunk keeps honest books: the tokens the chunk consumed past
        the stop are recorded (unemitted) in ``all_tokens`` so cache keys
        match the device state; if the successor already advanced the row,
        the row is restored to its post-chunk state.

        BNF rows are replayed through their grammars off the loop first
        (:meth:`_consume_bnf_row` reads the verdicts).  Only rows with
        speculation credit ride the successor, which launches before the
        replay can rule on them.
        """
        spec = self._spec
        self._spec = None
        live = [(s, c) for (s, c) in spec["entries"] if s.ctx is c]
        dead = spec["dead"]
        newspec = None
        chunkable = [s for s in chunkable if self._has_credit(s.ctx)]
        if chunkable and len(live) == len(spec["entries"]) \
                and spec["rows"].issubset(
                    frozenset(s.index for s in chunkable)):
            newspec = await self._launch_chunk(
                loop, chunkable, self._pick_k(),
                first_device={"toks": spec["toks"][-1],
                              "rows": spec["rows"],
                              "dead": frozenset(dead)},
                consumed={b: k for b, k in spec["budgets"].items()
                          if b not in dead})
            # Record it NOW so a crash mid-processing rolls it back.
            self._spec = newspec
        toks_seq = await loop.run_in_executor(
            self._device_pool, to_host, spec["toks"])
        self.metrics["steps"] += 1

        # The BNF replay, off the loop and in parallel over rows: advance
        # each grammar through its sampled tokens; the accepted prefix is
        # where the true mask matched the one the chunk sampled under.
        bnf_live = [(s, c) for s, c in live
                    if c.formatter is not None and s.index not in dead
                    and not c.handle.aborted]
        replays = {}
        if bnf_live:
            for _, c in bnf_live:  # no replay beside a pending mask
                if c.bnf_future is not None:
                    await c.bnf_future
                    c.bnf_future = None
            rs = await asyncio.gather(*[
                loop.run_in_executor(
                    None, _replay, c, toks_seq[:spec["budgets"][s.index],
                                               s.index])
                for s, c in bnf_live])
            replays = {s.index: r for (s, _), r in zip(bnf_live, rs)}

        for s, ctx in live:
            b = s.index
            if b in dead:
                continue  # invalidated by a BNF mis-speculation last consume
            kb = spec["budgets"][b]
            row = [int(t) for t in toks_seq[:kb, b]]
            in_successor = newspec is not None and b in newspec["rows"]
            if b in replays:
                await self._consume_bnf_row(loop, s, ctx, row, kb,
                                            replays[b], newspec)
                continue
            if ctx.handle.aborted:
                ctx.all_tokens.extend(row)
                if in_successor:
                    self.metrics["rollbacks"] += 1
                    await loop.run_in_executor(
                        self._device_pool, self.engine.rollback_row, b, [],
                        -1)
                await self._finalize(s, FinishReason.ABORT)
                continue
            for j, token in enumerate(row):
                reason = await self._postprocess_token(s, token)
                if reason is None:
                    continue
                # Honest books: the over-decoded suffix the chunk consumed
                # but the request never saw (the last sampled token stays
                # un-fed, keeping the _consumed_tokens invariant).
                ctx.all_tokens.extend(row[j + 1:])
                if in_successor:
                    self.metrics["rollbacks"] += 1
                    await loop.run_in_executor(
                        self._device_pool, self.engine.rollback_row, b, [],
                        -1)
                await self._finalize(s, reason)
                break
        self._spec = newspec

    async def _consume_bnf_row(self, loop, s, ctx, row, kb, replay,
                               newspec) -> None:
        """One BNF row's chunk tokens, by its replay verdict ``(acc, halted,
        new_mask)``: the grammar accepted ``row[:acc]``, ``halted`` means it
        completed on the acc-th token, and ``new_mask`` is the changed mask
        (the tokens past ``acc`` were sampled under a stale one and are
        DISCARDED).  Every emitted token was sampled under the true grammar
        mask of its step, so the output follows the distribution of
        per-token steps (bnf.rs:35-47)."""
        b = s.index
        acc, halted, new_mask = replay
        # A device-DFA row froze on the device at its halting token: the
        # tokens past ``acc`` were never fed, so the books end at ``acc``
        # and the successor kept the row frozen too (no rollback).
        dfa_halt = ctx.dfa_table is not None and halted
        if ctx.dfa_table is not None and acc:
            # The replay advanced the host grammar: the host mask (read
            # only by merged per-token steps) is stale.  The device state
            # advanced in lockstep.
            ctx.bnf_dirty = True
        reason = None
        for j in range(acc):
            reason = await self._postprocess_token(
                s, row[j], halted=(halted and j == acc - 1))
            if reason is not None:
                # Honest books for the rest of what the chunk consumed.
                ctx.all_tokens.extend(row[j + 1: acc if dfa_halt
                                          else len(row)])
                break
        if reason is not None:
            if (newspec is not None and b in newspec["rows"]
                    and not dfa_halt):
                newspec["dead"].add(b)
                self.metrics["rollbacks"] += 1
                await loop.run_in_executor(
                    self._device_pool, self.engine.rollback_row, b, [], -1)
            await self._finalize(s, reason)
            return

        self.metrics["bnf_accepted"] += acc
        if new_mask is None:
            # The whole chunk was accepted under an unchanged mask.
            ctx.bnf_misses = 0
            ctx.bnf_full_accept = True
            return

        # Mis-speculation: resume the row at its accepted prefix.
        ctx.bnf_full_accept = False
        self.metrics["rollbacks"] += 1
        if newspec is not None and b in newspec["rows"]:
            newspec["dead"].add(b)
        if acc < kb:
            # The chunk consumed past the prefix: restore this chunk's
            # pre-state (ring depth -2 behind a successor) and re-feed the
            # accepted tokens.
            depth = -2 if newspec is not None else -1
            feed = ctx.all_tokens[-(acc + 1):-1]
            await loop.run_in_executor(
                self._device_pool, self.engine.rollback_row, b, feed, depth)
            await loop.run_in_executor(
                self._device_pool, self._rebuild_sampler_state, b, ctx)
        elif newspec is not None and b in newspec["dead"]:
            # The state is exactly post-chunk but the successor advanced
            # it: restore the post-chunk row and rebuild the sampler state.
            await loop.run_in_executor(
                self._device_pool, self.engine.rollback_row, b, [], -1)
            await loop.run_in_executor(
                self._device_pool, self._rebuild_sampler_state, b, ctx)
        ctx.bnf_mask = new_mask
        ctx.bnf_dirty = False
        ctx.bnf_sticky = 0
        await loop.run_in_executor(self._device_pool, self.engine.set_row_mask,
                                   b, new_mask)
        # Grammars whose mask shifts every token or two gain nothing from
        # chunks (each one is cut almost at once): per-token steps.
        if acc <= 2:
            ctx.bnf_misses += 1
            self.metrics["bnf_short_chunks"] += 1
            if ctx.bnf_misses >= 2:
                if not ctx.bnf_no_chunk:
                    self.metrics["bnf_fallbacks"] += 1
                ctx.bnf_no_chunk = True
        else:
            ctx.bnf_misses = 0

    async def _admit(self) -> None:
        """Assign pending requests to free slots (Continue > Empty > Back)."""
        # Installs await the engine thread: requests submitted meanwhile are
        # appended to this same list, so the loop below reaches them too.
        remaining = []
        for ctx in self.pending:
            if ctx.handle.aborted:
                await ctx.handle.queue.put(
                    ("stop", FinishReason.ABORT, ctx.counter))
                await ctx.handle.queue.put(("done",))
                continue
            slot = self._choose_slot(ctx)
            if slot is None or not await self._install(slot, ctx):
                # No free slot, or deferred on an in-flight prefix-cache
                # future that this same loop must resolve: retry next
                # iteration (never await it here).
                remaining.append(ctx)
        self.pending = remaining

    def _choose_slot(self, ctx: _ReqCtx) -> Optional[_Slot]:
        """Continue > Empty > Back."""
        best_cont, best_len = None, 0
        empty = None
        oldest = None
        for s in self.slots:
            if s.phase != _SlotPhase.IDLE:
                continue
            if not s.resident_tokens and empty is None:
                empty = s
            if (s.resident_tokens
                    and len(s.resident_tokens) < len(ctx.prompt_tokens)
                    and ctx.prompt_tokens[: len(s.resident_tokens)]
                    == s.resident_tokens
                    and len(s.resident_tokens) > best_len):
                best_cont, best_len = s, len(s.resident_tokens)
            if oldest is None or s.idle_since < oldest.idle_since:
                oldest = s
        return best_cont or empty or oldest

    async def _install(self, slot: _Slot, ctx: _ReqCtx) -> bool:
        """Check out the longest cached prefix and configure the engine row.

        Returns False (without touching the slot) when admission should be
        deferred: the best cached prefix is an in-flight future owned by a
        prefill that this same drive loop must execute.
        """
        eng = self.engine
        b = slot.index
        exact_item: CachedItem | None = None
        loop = asyncio.get_event_loop()
        pool = self._device_pool

        # Mean-hidden embeds read the hidden sums step() accumulates for
        # rows loaded with hidden_sums=True, so their whole prompt runs
        # through step() from a fresh state: no resident continue, no
        # prefix-cache checkout.
        mean_hidden = (ctx.request.pooled
                       and ctx.request.kind == GenerateKind.STATE
                       and ctx.request.effective_pooling() == "mean_hidden")

        reused = 0
        if mean_hidden:
            await loop.run_in_executor(
                pool, lambda: eng.load_row_state(b, None, hidden_sums=True))
        elif (slot.resident_tokens
                and len(slot.resident_tokens) < len(ctx.prompt_tokens)
                and ctx.prompt_tokens[: len(slot.resident_tokens)]
                == slot.resident_tokens):
            # Continue in place: resident state is a strict prompt prefix.
            reused = len(slot.resident_tokens)
        else:
            plen, item = self.cache.longest_prefix(ctx.prompt_tokens)
            if isinstance(item, asyncio.Future):
                if item.done():
                    item = item.result()
                else:
                    now = time.monotonic()
                    if ctx.defer_deadline == 0.0:
                        ctx.defer_deadline = now + 60.0
                    if now < ctx.defer_deadline:
                        return False  # re-admit next drive iteration
                    item = None  # gave up waiting: treat as a cache miss
            if (isinstance(item, CachedItem)
                    and plen == len(ctx.prompt_tokens)
                    and item.logits is None
                    and ctx.request.kind != GenerateKind.STATE):
                # Exact hit without prompt-end logits (a Back-cached
                # item): generation samples from them and choose reads its
                # head term from them, so back off to a strict prefix; the
                # last token is re-fed and the logits regenerate.
                plen, item = self.cache.longest_prefix(
                    ctx.prompt_tokens, strict=True)
                if isinstance(item, asyncio.Future):
                    item = item.result() if item.done() else None
                if item is None:
                    plen = 0
            if isinstance(item, CachedItem):
                item.instant = time.monotonic()
                if plen == len(ctx.prompt_tokens) and item.logits is not None:
                    exact_item = item
                await loop.run_in_executor(pool, eng.load_row_state, b,
                                           item.state)
                reused = plen
            else:
                await loop.run_in_executor(pool, eng.load_row_state, b, None)

        ctx.remaining = list(ctx.prompt_tokens[reused:])
        ctx.all_tokens = list(ctx.prompt_tokens)

        # Penalty init from model-authored tokens.
        await loop.run_in_executor(
            pool, lambda: eng.set_row_sampler(
                b, ctx.request.sampler.row_params(),
                prompt_tokens=ctx.model_tokens))
        bias = None
        if ctx.request.bias:
            bias = np.zeros(eng.vocab, np.float32)
            for t, v in ctx.request.bias.items():
                if 0 <= int(t) < eng.vocab:
                    bias[int(t)] = v
        await loop.run_in_executor(pool, eng.set_row_bias, b, bias)
        await loop.run_in_executor(pool, eng.set_row_mask, b, None)
        if ctx.dfa_future is not None:
            res, _ = await ctx.dfa_future
            ctx.dfa_future = None
            if res is not None:
                ctx.dfa_table, ctx.dfa_map = res
        if ctx.dfa_table is not None:
            # The grammar starts at table row 0.  The first token is sampled
            # by the prefill step under the host mask; the device state
            # takes the grammar's state before the first chunk (dfa_stale).
            await loop.run_in_executor(
                pool, lambda: eng.set_row_dfa(b, ctx.dfa_table, 0,
                                              key=ctx.dfa_key))
            ctx.dfa_stale = False
            self.metrics["bnf_dfa_requests"] += 1
        else:
            await loop.run_in_executor(pool, eng.clear_row_dfa, b)
            if ctx.formatter is not None:
                self.metrics["bnf_replay_requests"] += 1

        # In-flight cache future for this prompt.
        if (len(ctx.prompt_tokens) >= MIN_PROMPT_CACHE_TOKENS
                and ctx.request.kind == GenerateKind.GENERATE
                and exact_item is None and ctx.remaining):
            fut = loop.create_future()
            self.cache.insert(ctx.prompt_tokens, fut)
            ctx.cache_future = fut

        slot.ctx = ctx
        await ctx.handle.queue.put(("start",))

        if exact_item is not None:
            # The cached prompt-end logits serve the sample fast path
            # (generate) and the head log-prob term (choose).
            ctx.prefill_logits = exact_item.logits
        if exact_item is not None \
                and ctx.request.kind == GenerateKind.GENERATE:
            # Exact-hit fast path: sample from the cached prompt-end logits.
            slot.phase = _SlotPhase.DECODE
            if ctx.formatter is not None:
                ctx.bnf_mask = await loop.run_in_executor(
                    None, ctx.formatter.allowed_mask)
                ctx.bnf_dirty = False
                await loop.run_in_executor(pool, eng.set_row_mask, b,
                                           ctx.bnf_mask)
            token = await loop.run_in_executor(
                pool, eng.sample_only, b, exact_item.logits)
            await self._accept_token(slot, token)
        elif not ctx.remaining:
            # The state covers the whole prompt: state and choose requests
            # are answered from it; a generation without logits redoes the
            # prompt from a fresh state.
            if ctx.request.kind == GenerateKind.STATE:
                await self._emit_state(slot)
            elif ctx.request.kind == GenerateKind.CHOOSE:
                await self._run_choose(slot)
            else:
                ctx.remaining = list(ctx.prompt_tokens)
                await loop.run_in_executor(pool, eng.load_row_state, b,
                                           None)
                slot.phase = _SlotPhase.PREFILL
        else:
            slot.phase = _SlotPhase.PREFILL
        return True

    async def _advance(self, slot: _Slot, lengths, sample_mask,
                       result) -> None:
        ctx = slot.ctx
        if ctx is None:
            return
        b = slot.index

        # Account for what the engine consumed THIS step before any abort
        # check, so resident_tokens and cache keys match the device state.
        if slot.phase == _SlotPhase.PREFILL:
            del ctx.remaining[:int(lengths[b])]
        elif sample_mask[b] and ctx.handle.aborted:
            # Decode row: the previous sample was fed this step; the fresh
            # sample was not.  Appending it keeps _consumed_tokens' invariant.
            ctx.all_tokens.append(int(result.tokens[b]))

        if ctx.handle.aborted:
            await self._finalize(slot, FinishReason.ABORT)
            return

        if slot.phase == _SlotPhase.PREFILL:
            if ctx.remaining:
                return  # still prefilling
            if ctx.cache_future is not None and not ctx.prefill_cached:
                await self._store_prefill(slot, ctx)
            if ctx.request.kind == GenerateKind.STATE:
                await self._emit_state(slot)
                return
            if ctx.request.kind == GenerateKind.CHOOSE:
                await self._run_choose(slot)
                return
            slot.phase = _SlotPhase.DECODE

        await self._accept_token(slot, int(result.tokens[b]))

    async def _store_prefill(self, slot: _Slot, ctx: _ReqCtx) -> None:
        """Cache the prompt state without blocking the drive loop: the
        device row copy is taken now (before any later pool write), the
        device->host transfer runs in a worker thread and the trie insert
        lands via a loop callback."""
        ctx.prefill_cached = True
        loop = asyncio.get_event_loop()
        row = await loop.run_in_executor(
            self._device_pool, self.engine.read_row_state_device, slot.index)
        lazy = ctx.prefill_logits

        def _materialize(r=row, lg=lazy):
            return to_host(r), (lg.get() if lg is not None else None)

        fut = loop.run_in_executor(None, _materialize)
        self._cache_stores.add(fut)
        cf = ctx.cache_future
        key = ctx.prompt_tokens

        def _store(f):
            self._cache_stores.discard(f)
            try:
                state_np, logits_np = f.result()
                item = CachedItem(state=state_np, logits=logits_np,
                                  tokens=key)
                self.cache.insert(key, item)
                self.cache.maintain()
                if not cf.done():
                    cf.set_result(item)
            except Exception:
                logger.exception("prefill cache store failed")
                if not cf.done():
                    cf.set_result(None)

        fut.add_done_callback(_store)

    async def _postprocess_token(self, slot: _Slot, token: int,
                                 halted: bool | None = None
                                 ) -> FinishReason | None:
        """Append + stream one sampled token; detect stop conditions.
        Returns the finish reason (without finalizing) or None.  ``halted``
        is the grammar's verdict when a chunk replay already advanced the
        formatter; None advances it here."""
        ctx = slot.ctx
        ctx.all_tokens.append(token)
        ctx.counter.completion += 1

        if halted is None:
            halted = False
            if ctx.formatter is not None:
                if ctx.bnf_future is not None:
                    # Never advance the grammar beside a pending mask.
                    await ctx.bnf_future
                    ctx.bnf_future = None
                halted = ctx.formatter.accept(token)
                ctx.bnf_dirty = True
                ctx.dfa_stale = True  # the host advanced outside a chunk
                if not halted and ctx.dfa_table is None:
                    # Mask-ahead: the next mask is computed while the rest
                    # of this step's host work runs (device-DFA rows take
                    # no more per-token masked steps after this one).
                    ctx.bnf_future = asyncio.get_event_loop() \
                        .run_in_executor(None, ctx.formatter.allowed_mask)

        if token == END_OF_TEXT:
            await self._emit_bytes(ctx, b"", final=True)
            return FinishReason.STOP
        if await self._emit_bytes(ctx, self.tokenizer.token_to_bytes(token)):
            return FinishReason.STOP
        if halted:
            await self._emit_bytes(ctx, b"", final=True)
            return FinishReason.STOP
        if ctx.counter.completion >= ctx.request.max_tokens:
            await self._emit_bytes(ctx, b"", final=True)
            return FinishReason.LENGTH
        slot.phase = _SlotPhase.DECODE
        return None

    async def _accept_token(self, slot: _Slot, token: int) -> bool:
        """Post-process one sampled token; finalize on a stop condition.
        Returns True when the slot finished."""
        reason = await self._postprocess_token(slot, token)
        if reason is not None:
            await self._finalize(slot, reason)
            return True
        return False

    async def _emit_bytes(self, ctx: _ReqCtx, data: bytes,
                          final: bool = False) -> bool:
        emit, stopped = ctx.stop.push(data)
        if final:
            emit += ctx.stop.flush()
        text = ctx.utf8.push(emit)
        if final:
            text += ctx.utf8.flush()
        if text:
            await ctx.handle.queue.put(("content", text))
        return stopped

    def _consumed_tokens(self, ctx: _ReqCtx) -> tuple[int, ...]:
        """Tokens the engine state has actually consumed: every decode path
        leaves exactly ONE pending token (the freshly sampled one is fed on
        the next step); mid-prefill aborts consumed only a prompt prefix."""
        if ctx.remaining:  # aborted mid-prefill
            n = len(ctx.prompt_tokens) - len(ctx.remaining)
            return ctx.prompt_tokens[:n]
        if len(ctx.all_tokens) > len(ctx.prompt_tokens):
            return tuple(ctx.all_tokens[:-1])  # last sample not yet fed
        return tuple(ctx.all_tokens)

    async def _finalize(self, slot: _Slot, reason: FinishReason) -> None:
        ctx = slot.ctx
        b = slot.index
        ctx.counter.duration = time.monotonic() - ctx.start_time

        if ctx.cache_future is not None and not ctx.cache_future.done():
            ctx.cache_future.set_result(None)
            if not ctx.prefill_cached:
                self.cache.remove(ctx.prompt_tokens)

        consumed = self._consumed_tokens(ctx)
        loop = asyncio.get_event_loop()

        # Back: cache the final state keyed by the consumed tokens.
        if (ctx.request.kind == GenerateKind.GENERATE
                and reason in (FinishReason.STOP, FinishReason.LENGTH)
                and len(consumed) >= MIN_PROMPT_CACHE_TOKENS):
            row = await loop.run_in_executor(
                self._device_pool, self.engine.read_row_state_device, b)
            fut = loop.run_in_executor(None, to_host, row)
            self._cache_stores.add(fut)

            def _store(f, consumed=consumed):
                self._cache_stores.discard(f)
                try:
                    self.cache.insert(consumed, CachedItem(
                        state=f.result(), logits=None, tokens=consumed))
                    self.cache.maintain()
                except Exception:  # the cache store is best-effort
                    logger.exception("back-cache store failed")

            fut.add_done_callback(_store)

        if ctx.bnf_future is not None:
            await ctx.bnf_future  # read it: nothing else will
            ctx.bnf_future = None
        await ctx.handle.queue.put(("stop", reason, ctx.counter))
        await ctx.handle.queue.put(("done",))
        # Idle rows' kind/top_k return to the defaults so a finished
        # top_k=0 or mirostat request does not slow the rows still running;
        # a finished BNF row drops its mask and leaves the DFA, so the rows
        # still running sample without the mask's work.
        await loop.run_in_executor(self._device_pool,
                                   self.engine.reset_row_sampler_key, b)
        if ctx.formatter is not None:
            await loop.run_in_executor(self._device_pool,
                                       self.engine.set_row_mask, b, None)
            await loop.run_in_executor(self._device_pool,
                                       self.engine.clear_row_dfa, b)
        slot.resident_tokens = consumed
        slot.idle_since = time.monotonic()
        slot.phase = _SlotPhase.IDLE
        slot.ctx = None
        self._wake.set()

    async def _emit_state(self, slot: _Slot) -> None:
        """Answer a STATE request after its prefill and finish it."""
        ctx = slot.ctx
        loop = asyncio.get_event_loop()
        if not ctx.request.pooled:
            state = await loop.run_in_executor(
                self._device_pool, self.engine.read_row_state, slot.index)
            await ctx.handle.queue.put(("embed", state))
        elif ctx.request.effective_pooling() == "mean_hidden":
            # The mean of the hidden sums this row's own prefill added (the
            # install forced a fresh-state, whole-prompt prefill).  Rows
            # finishing in the same step share one whole-pool read, keyed
            # by the engine's hsum_serial.
            def _mean(b=slot.index, n=len(ctx.prompt_tokens)):
                snap = self._hsum_snap
                serial = self.engine.hsum_serial
                if snap is None or snap[0] != serial:
                    snap = (serial, self.engine.read_hidden_sums())
                    self._hsum_snap = snap
                v = (snap[1][b] / max(n, 1)).astype(np.float64)
                return (v / max(float(np.linalg.norm(v)), 1e-12)).astype(
                    np.float32)

            vec = await loop.run_in_executor(self._device_pool, _mean)
            await ctx.handle.queue.put(("embed_vec", vec))
        else:
            vec = await loop.run_in_executor(
                self._device_pool, self.engine.read_row_embed, slot.index)
            await ctx.handle.queue.put(("embed_vec", vec))
        await self._finalize(slot, FinishReason.STOP)

    async def _run_choose(self, slot: _Slot) -> None:
        """Perplexity of each choice after the prompt: ``-(ln p(first token
        | prompt) + sum ln p(next | ...)) / len(choice)``, scored from a
        copy of the row's state.  ``calibrate`` adds each choice's mean
        log-prob from the initial state after an end-of-text token."""
        loop = asyncio.get_event_loop()
        eng = self.engine
        ctx = slot.ctx
        b = slot.index
        choices_tokens = [tuple(self.tokenizer.encode(c))
                          for c in ctx.request.choices]
        ppl = [float("inf")] * len(choices_tokens)

        if ctx.request.calibrate:
            init = await loop.run_in_executor(self._device_pool,
                                              eng.fresh_row_state)
            for i, toks in enumerate(choices_tokens):
                if not toks:
                    continue
                fed = (END_OF_TEXT,) + toks
                lp = await loop.run_in_executor(
                    self._device_pool, lambda f=fed: eng.position_logps(
                        list(f), state=init))
                ppl[i] = float(np.sum(lp)) / len(fed)

        head_logp = None
        if ctx.prefill_logits is not None:
            raw = ctx.prefill_logits
            if isinstance(raw, _LazyLogitsRow):
                raw = await loop.run_in_executor(None, raw.get)
            x = np.asarray(raw, np.float64)
            x = x - x.max()
            head_logp = x - np.log(np.exp(x).sum())

        for i, toks in enumerate(choices_tokens):
            if not toks:
                continue
            lp = await loop.run_in_executor(
                self._device_pool, lambda t=toks: eng.position_logps(
                    list(t), b=b))
            h = float(head_logp[toks[0]]) if head_logp is not None else 0.0
            p = -(h + float(np.sum(lp))) / len(toks)
            ppl[i] = (ppl[i] + p) if ctx.request.calibrate else p

        await ctx.handle.queue.put(("choose", ppl))
        await self._finalize(slot, FinishReason.STOP)

    async def flush_cache_stores(self) -> None:
        """Await all in-flight cache-store transfers."""
        while self._cache_stores:
            await asyncio.gather(*list(self._cache_stores),
                                 return_exceptions=True)
            await asyncio.sleep(0)  # let the done-callbacks run
