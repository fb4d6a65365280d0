"""Batched inference engine: merged steps and K-token decode over a state
pool on one device.

Port of ``ai00_server_tpu/engine.py`` for RWKV-7, -6, -5 and -4, plain or
quantized (int8, nf4, sf4, int4):

* All ``max_batch`` request slots live in ONE state pool on the device,
  leading axes ``(L, B, ...)``.  Where the JAX engine replaces its pool
  with each step's result, this one allocates the pool once and updates it
  IN PLACE, so its tensors keep their addresses for the engine's lifetime:
  the fused decode path writes into it, a prefill chunk's new state is
  copied into it, and snapshots are clones that are copied back.
* At construction the engine installs the fused decode layout of the
  model's version (``ops/fused_decode.module_for``: ``ops/v7_decode``,
  ``v6_decode``, ``v5_decode`` or ``v4_decode``, ``make_fused_layout``)
  where the model allows it, and
  on a CUDA device captures the whole T=1 layer stack once in a CUDA graph
  that every decode step replays; the LM head and sampling run eagerly
  after it.  The stack is ``ops/fused_decode.stack_for(version, params,
  max_batch)``'s: above 8 rows the phased one (``ops/v7_phased``,
  ``ops/v56_phased``: every weight read once for up to 64 rows) where the
  weights are plain, int8 or int4, else the fused one.  A model whose
  layers are only partly quantized keeps to the layer-by-layer path and
  gets no graph.
  4-bit models decode from their packed codes (the reference's int8
  surrogate of them is not carried over).
* A model with any quantized layer, in whatever mode, also stores the LM
  head int8
  (``_head_q``, per-128-row-block scales, quantized on the device at
  construction; the plain head leaves the device and is kept on the host in
  ``model.host_params`` for a prefab export) and takes its logits through
  ``ops/quant_matmul.matmul_int8`` with the f32 sums un-rounded.
* A state-tuned model's embedded ``init_wkv`` is the WKV of every fresh
  row (built once on the device); custom initial states come in through
  :meth:`Engine.load_row_state`.
* :meth:`Engine.step` consumes a ``(B, T)`` token block (T = 1 for
  per-token decode, T = ``token_chunk_size`` when a row prefills);
  :meth:`Engine.decode_chunk` runs K decode steps with sampling on the
  device, feeding each sampled token back in, and only the ``(K, B)``
  tokens cross to the host.
* Per-row logit bias and BNF allow-masks are device pools updated only
  when they change.
* The device token DFA of regular grammars (``grammar.token_dfa_table``):
  each row owns a ``(TH, V)`` int8 table in ``dfa_pool`` (entry -1 =
  token disallowed, ``TH - 1`` = the grammar halts, else the next state)
  and its state in ``dfa_state`` (-1 = the row is not DFA-constrained).
  :meth:`Engine.decode_chunk` reads each row's current table row at every
  step (one ``(B, V)`` gather, never the whole pool), masks the sample
  with it, advances the state by the sampled token and freezes a row
  whose grammar halted, as it freezes a row whose budget is spent.
* Sampling uniforms come from a ``torch.Generator`` on the device.
* A ring of pre-chunk snapshots backs :meth:`rollback_row` and
  :meth:`restore_last_chunk`.
* Embedding and scoring reads: :meth:`Engine.step` adds the masked final
  hidden states of the rows loaded with ``hidden_sums=True`` into
  ``hsum_pool`` (the mean-hidden ``/embeddings`` readout, zeroed when a
  row is loaded; other traffic adds nothing, and a step with no such row
  runs no extra work; ``decode_chunk`` does not add, as in the JAX
  engine), :meth:`read_row_embed` pools a
  row's state, :meth:`mean_hidden_embed` is the offline recipe, and
  :meth:`position_logps` scores tokens from a copy of a row's state
  (``/chooses``) without advancing the pool.

Every method that reads or writes a pool holds the engine's lock (row
reads included).  The scheduler (runtime.py) calls the engine from one
worker thread; the engine itself is synchronous.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device
from .loader import LoadedModel
from .models import get_version_module
from .models.common import masked_select, take_last_valid
from .ops import fused_decode, quant, sampling
from .ops.quant_matmul import matmul_int8


def head_logits(params, x):
    """``x @ head -> (B, V) f32 logits``.

    An int8 head (``_head_q``) goes through the dequant-in-matmul kernel at
    decode shapes and is dequantized once at score shapes.  A plain head
    has its operands in the activation dtype, products summed in f32 (a
    bf16 x bf16 product is exact in f32) and an f32 result; on the card a
    bf16 head goes to one product with an f32 output type, so the head is
    read once as bf16 and never converted."""
    hq = params.get("_head_q")
    if hq is not None:
        if x.shape[0] <= quant.KERNEL_ROWS:
            # Decode shapes: the dequant-in-matmul kernel streams the int8
            # codes once per 64 rows; operands in x's dtype, f32 sums
            # returned as they are.
            return matmul_int8(x, hq.q, hq.scale, out_dtype=torch.float32)
        # Score shapes: dequantize once, one large product.
        w = hq.dequant(torch.bfloat16)
        if x.device.type == "cuda":
            return torch.mm(x.bfloat16(), w, out_dtype=torch.float32)
        return torch.matmul(x.bfloat16().float(), w.float())
    head = params["head"]
    if x.dtype == torch.float32 and head.dtype == torch.float32:
        return torch.matmul(x, head)
    if x.device.type == "cuda":
        return torch.mm(x, head.to(x.dtype), out_dtype=torch.float32)
    return torch.matmul(x.float(), head.to(x.dtype).float())


def dfa_height() -> int:
    """Rows of each slot's token-DFA table: ``AI00_DFA_STATES`` (default
    64), the last one the halt row.  The table is int8, so more than 128
    rows cannot be addressed (the JAX engine takes any value and its state
    ids wrap); fewer than 2 leave no room for a state beside the halt row."""
    th = int(os.environ.get("AI00_DFA_STATES", "64"))
    if not 2 <= th <= 128:
        raise ValueError(f"AI00_DFA_STATES={th}: the int8 token DFA takes "
                         "2..128 rows")
    return th


def dfa_mask(pool, rows, ds, on, mask_pool):
    """The DFA half of a decode step's mask.  ``ds`` (B,) int64 states, -1
    for a row off the DFA, and ``on = ds >= 0``.  Returns each row's current
    table row ``pool[b, ds[b]]`` (one (V,) int8 row a row, never the whole
    pool) and the (B, V) allowed mask: the table row's ``>= 0`` where the
    row is on the DFA, else its ``mask_pool`` row."""
    srow = pool[rows, torch.clamp(ds, min=0)]
    return srow, torch.where(on[:, None], srow >= 0, mask_pool)


def dfa_advance(ds, on, srow, toks, act):
    """The DFA states after the sampled ``toks``: the table entry of each
    active row on the DFA, the state unchanged elsewhere."""
    nxt = torch.gather(srow, 1, toks[:, None].long())[:, 0]
    return torch.where(act & on, nxt, ds)


@dataclass
class StepResult:
    tokens: np.ndarray          # (B,) int32, valid where sample_mask
    logits: torch.Tensor | None  # (B, V) f32 on the device (want_logits)


def to_host(tree):
    """Tensor or dict of tensors -> numpy (a device->host copy)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


class Engine:
    """Owner of the device-resident pools for one loaded model."""

    def __init__(self, model: LoadedModel, max_batch: int = 8,
                 token_chunk_size: int = 128, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.info = model.info
        self.module = get_version_module(model.info.version)
        self.max_batch = int(max_batch)
        self.token_chunk_size = int(token_chunk_size)
        self.vocab = model.info.num_vocab
        first = model.params["emb"]
        if first.device != self.device:
            raise ValueError(f"params are on {first.device}, engine on "
                             f"{self.device}")

        B, V = self.max_batch, self.vocab
        self.state_pool = self.module.init_state(self.info, B,
                                                 device=self.device)
        self._fresh_row = self._initial_row_state()
        self._install_head_q()
        version = model.info.version.value
        fd = fused_decode.module_for(version)
        stack = fused_decode.stack_for(version, model.params, B)
        if stack is not None and not fd.supports(model.params):
            model.params[fd.FUSED_KEY] = fd.make_fused_layout(model.params)
        self._graph = None
        if self.device.type == "cuda" and stack is not None:
            self._graph = stack.DecodeGraph(model.params, self.state_pool, B)
        self.sampler_state = sampling.init_sampler_state(B, V, self.device)
        self.sampler_params_host = sampling.make_params(B)
        self.bias_pool = torch.zeros((B, V), dtype=torch.float32,
                                     device=self.device)
        self.bias_active = np.zeros(B, np.bool_)
        self.mask_pool = torch.ones((B, V), dtype=torch.bool,
                                    device=self.device)
        self.mask_active = np.zeros(B, np.bool_)  # rows with a BNF mask
        # The device token DFA (regular grammars): a (TH, V) int8 table a
        # row, its state (-1 = not DFA-constrained), and on the host which
        # rows are on and which grammar each row's table holds (a slot
        # reused with the same grammar skips the table upload).
        TH = self.dfa_height = dfa_height()
        self.dfa_pool = torch.full((B, TH, V), -1, dtype=torch.int8,
                                   device=self.device)
        self.dfa_state = torch.full((B,), -1, dtype=torch.int32,
                                    device=self.device)
        self.dfa_rows = np.zeros(B, np.bool_)
        self._dfa_row_key: list = [None] * B
        self._rows = torch.arange(B, device=self.device)
        # Per-row running sum of the final hidden states over every valid
        # position fed through step() since the row was loaded, for the
        # rows loaded with hidden_sums=True (hsum_rows): the mean-hidden
        # embedding is one prefill, not prefill + re-forward.  hsum_serial
        # counts its changes (coalesced whole-pool reads).
        self.hsum_pool = torch.zeros((B, self.info.num_emb),
                                     dtype=torch.float32, device=self.device)
        self.hsum_rows = np.zeros(B, np.bool_)
        self.hsum_serial = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.seed()
        self._lock = threading.Lock()
        # Ring of (state, sampler state, DFA state, DFA rows) pre-chunk
        # snapshots: [-1] is the most recent chunk's pre-state
        # (rollback_row), [-2] survives one speculative chunk
        # (restore_last_chunk).
        self._chunk_snaps: list = []
        self._sparams_device = None

    def _install_head_q(self) -> None:
        """Quantized models store the LM head int8 too: it is the largest
        single stream of a decode step outside the layers.  Only where the
        head's ``in`` dim is a multiple of the block; else it stays plain.
        The plain head moves to ``model.host_params`` (host memory), so a
        prefab exported from the model is as good as its source."""
        params = self.model.params
        if "_head_q" in params or "head" not in params \
                or params["head"].shape[0] % quant.INT8_BLOCK:
            return
        if any(quant.is_quantized(leaf) for p in params["layers"]
               for part in ("att", "ffn") for leaf in p[part].values()):
            head = params.pop("head")
            params["_head_q"] = quant.quantize_int8(head)
            if self.model.host_params is None:
                self.model.host_params = {}
            self.model.host_params.setdefault("head", head.cpu())

    # ------------------------------------------------------------------
    # State pool row management
    # ------------------------------------------------------------------

    def _initial_row_state(self) -> dict:
        """The model's own batch-1 initial state on the device: zeros, with
        a state-tuned checkpoint's ``init_wkv`` as the WKV (``(k, v)`` on
        disk, transposed for v7, whose state is ``(v, k)``)."""
        s = self.module.init_state(self.info, 1, device=self.device)
        init = self.model.init_wkv
        if init is not None and "wkv" in s:
            wkv = torch.as_tensor(np.asarray(init, np.float32),
                                  device=self.device)
            if self.info.version.value == "V7":
                wkv = wkv.transpose(-1, -2)
            s["wkv"].copy_(wkv[:, None])
        return s

    def fresh_row_state(self) -> dict:
        """A copy of the model's batch-1 initial state on the device (a
        copy: a forward may update the state it is given in place)."""
        return {k: v.clone() for k, v in self._fresh_row.items()}

    def _forward(self, tokens, lengths):
        """Forward a (B, T) token block; the pool is updated in place.
        Returns hidden (B, T, C).  A T=1 block replays the decode graph
        where there is one (its hidden buffer is overwritten by the next
        replay)."""
        if tokens.shape[1] == 1 and self._graph is not None:
            return self._graph.replay(tokens[:, 0], lengths)[:, None]
        hidden, new = self.module.forward(self.model.params, self.state_pool,
                                          tokens, lengths)
        if new is not self.state_pool:
            for k, p in self.state_pool.items():
                p.copy_(new[k])
        return hidden

    def _write_row(self, row: dict, b: int) -> None:
        for k, p in self.state_pool.items():
            p[:, b] = torch.as_tensor(row[k], device=self.device)[:, 0].to(
                p.dtype)

    def _read_row(self, pool: dict, b: int) -> dict:
        return {k: p[:, b:b + 1].clone() for k, p in pool.items()}

    def load_row_state(self, b: int, row_state=None,
                       hidden_sums: bool = False) -> None:
        """Install a batch-1 state (tensors or numpy) in row b, or a fresh
        initial state.  Zeroes the row's hidden sums; with ``hidden_sums``
        step() adds the row's hidden states to them until the row is loaded
        again."""
        with self._lock:
            self._write_row(row_state if row_state is not None
                            else self._fresh_row, b)
            self.hsum_pool[b] = 0.0
            self.hsum_rows[b] = hidden_sums
            self.hsum_serial += 1

    def read_row_state(self, b: int) -> dict:
        """Device->host copy of row b's state as a batch-1 numpy dict."""
        return to_host(self.read_row_state_device(b))

    def read_row_state_device(self, b: int) -> dict:
        """Row b's state as a device copy, taken under the lock (later pool
        writes cannot race it); the caller moves it to the host."""
        with self._lock:
            return self._read_row(self.state_pool, b)

    # ------------------------------------------------------------------
    # Embedding reads
    # ------------------------------------------------------------------

    def read_row_hidden_sum(self, b: int) -> np.ndarray:
        """Row b's masked hidden-state sum (f32, C) accumulated by step()
        since ``load_row_state(b, ..., hidden_sums=True)``; divided by the
        fed token count it is the mean-hidden embedding.  Valid when the
        row's whole prompt went through step() from a fresh state (the
        runtime ensures that for pooled embed requests)."""
        with self._lock:
            return to_host(self.hsum_pool[b])

    def read_hidden_sums(self) -> np.ndarray:
        """The whole (B, C) hidden-sum pool in one device->host copy, read
        under the lock (the JAX engine reads it outside its lock)."""
        with self._lock:
            return to_host(self.hsum_pool)

    def read_row_embed(self, b: int) -> np.ndarray:
        """Row b's pooled state embedding (``pooling="state"``): the means
        over layers of ``att_x`` and ``ffn_x``, and where the state has a
        ``wkv``, its uniform-query readout ``sum_k S[.., v, k]`` meaned over
        layers; each part unit-normalized, the concatenation again."""
        with self._lock:
            pool = self.state_pool
            parts = [pool["att_x"][:, b].float().mean(0),
                     pool["ffn_x"][:, b].float().mean(0)]
            if "wkv" in pool:
                parts.append(pool["wkv"][:, b].float().sum(-1).mean(0)
                             .reshape(-1))
            vec = torch.cat([p / torch.clamp(torch.linalg.vector_norm(p),
                                              min=1e-12) for p in parts])
            vec = vec / torch.clamp(torch.linalg.vector_norm(vec), min=1e-12)
            return to_host(vec)

    def mean_hidden_embed(self, token_ids, chunk: int | None = None
                          ) -> np.ndarray:
        """Masked mean over all positions of the final (post-``ln_out``)
        hidden states, L2-normalized: the reference recipe of the
        mean-hidden embedding, as a batch-1 chunked forward from a fresh
        state off the pool.  The serving path reads ``hsum_pool`` instead
        (one prefill per embed, batched across rows)."""
        chunk = int(chunk or self.token_chunk_size)
        dev = self.device
        acc = np.zeros(self.info.num_emb, np.float64)
        cnt = 0
        with self._lock:
            state = self.fresh_row_state()
            for off in range(0, max(len(token_ids), 1), chunk):
                part = list(token_ids[off:off + chunk])
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :len(part)] = part
                h, state = self.module.forward(
                    self.model.params, state,
                    torch.as_tensor(toks, device=dev),
                    torch.tensor([len(part)], dtype=torch.int32, device=dev))
                mask = (torch.arange(chunk, device=dev) < len(part))[None, :,
                                                                     None]
                acc += to_host((h.float() * mask).sum(1)[0]).astype(
                    np.float64)
                cnt += len(part)
        v = acc / max(cnt, 1)
        return (v / max(float(np.linalg.norm(v)), 1e-12)).astype(np.float32)

    def position_logps(self, tokens: list[int], b: int | None = None,
                       state=None) -> np.ndarray:
        """``ln p(tokens[i] | tokens[:i])`` for i in 1..n-1: log-softmax of
        the raw logits at every position (no sampler transforms), fed from a
        copy of row ``b``'s state or from an explicit batch-1 ``state``
        (tensors or numpy).  The pool is never advanced."""
        dev = self.device
        with self._lock:
            if state is None:
                state = self._read_row(self.state_pool, b)
            else:
                state = {k: torch.as_tensor(
                    state[k] if isinstance(state[k], torch.Tensor)
                    else np.array(state[k]), device=dev).to(p.dtype).clone()
                    for k, p in self.state_pool.items()}
            t = torch.as_tensor(np.asarray(tokens, np.int32)[None],
                                device=dev)
            hidden, _ = self.module.forward(
                self.model.params, state, t,
                torch.tensor([len(tokens)], dtype=torch.int32, device=dev))
            logp = torch.log_softmax(
                head_logits(self.model.params, hidden[0]), dim=-1)
            lp = torch.gather(logp[:-1], 1, t[0, 1:, None].long())[:, 0]
            return to_host(lp)

    # ------------------------------------------------------------------
    # Sampler / bias row management
    # ------------------------------------------------------------------

    def _set_sampler_row(self, b, pen, seen, ms0) -> None:
        ss = self.sampler_state
        ss["penalties"][b] = torch.as_tensor(pen, device=self.device)
        ss["seen"][b] = torch.as_tensor(seen, device=self.device)
        ss["max_surprise"][b] = ms0

    def set_row_sampler(self, b: int, params: dict, prompt_tokens=()) -> None:
        """Configure row b's sampler params + penalty init from the
        model-authored prompt tokens."""
        with self._lock:
            for k, v in params.items():
                self.sampler_params_host[k][b] = v
            self._sparams_device = None
            hp = self.sampler_params_host
            pen, seen = sampling.init_penalties_host(
                list(prompt_tokens), self.vocab, float(hp["presence"][b]),
                float(hp["frequency"][b]), float(hp["decay"][b]))
            self._set_sampler_row(b, pen, seen,
                                  2.0 * float(hp["miro_tau"][b]))

    def reset_row_sampler_key(self, b: int) -> None:
        """Reset row b's kind and top_k to the pool defaults after its
        request finishes, so an idle row's values never widen the sampler
        branches or the top-k width of the rows still running."""
        with self._lock:
            defaults = sampling.make_params(1)
            self.sampler_params_host["kind"][b] = defaults["kind"][0]
            self.sampler_params_host["top_k"][b] = defaults["top_k"][0]
            self._sparams_device = None

    def set_row_sampler_state(self, b: int, pen: np.ndarray,
                              seen: np.ndarray) -> None:
        """Overwrite row ``b``'s penalty and seen state, rebuilt on the host
        after a BNF mask mis-speculation (the penalty recurrence is a pure
        function of the accepted tokens).  ``max_surprise`` returns to its
        initial value (mirostat rows never take the replay path)."""
        with self._lock:
            self._set_sampler_row(
                b, pen, seen,
                2.0 * float(self.sampler_params_host["miro_tau"][b]))

    def set_row_bias(self, b: int, bias: np.ndarray | None) -> None:
        with self._lock:
            if bias is None:
                if not self.bias_active[b]:
                    return  # row already zero: skip the (V,) upload
                self.bias_active[b] = False
                self.bias_pool[b] = 0.0
                return
            self.bias_active[b] = True
            self.bias_pool[b] = torch.as_tensor(bias, dtype=torch.float32,
                                                device=self.device)

    def set_row_mask(self, b: int, allowed: np.ndarray | None) -> None:
        """Row ``b``'s allowed-token mask (V,) bool, or None for none."""
        with self._lock:
            if allowed is None:
                if not self.mask_active[b]:
                    return  # row already all-ones: skip the (V,) upload
                self.mask_active[b] = False
                self.mask_pool[b] = True
                return
            self.mask_active[b] = True
            self.mask_pool[b] = torch.as_tensor(
                np.asarray(allowed, np.bool_), device=self.device)

    def set_row_dfa(self, b: int, table: np.ndarray, state0: int,
                    key=None) -> None:
        """Install a grammar's token DFA for row ``b``, in state ``state0``.

        ``table`` is ``(S, V) int8`` from ``grammar.token_dfa_table`` with
        ``S <= dfa_height`` and the halt row LAST; a shorter table is padded
        so that the halt row lands at ``dfa_height - 1``.  When ``key``
        matches the grammar of the row's current table, the upload is
        skipped and only the state is set."""
        TH, S = self.dfa_height, table.shape[0]
        if S > TH:
            raise ValueError(f"DFA table height {S} > pool {TH}")
        with self._lock:
            if key is None or self._dfa_row_key[b] != key:
                if S < TH:
                    pad = np.full((TH, self.vocab), -1, np.int8)
                    pad[:S - 1] = table[:-1]
                    pad[TH - 1] = TH - 1  # halt row: allow-all self-loop
                    body = pad[:S - 1]    # halt targets move to TH - 1
                    body[body == S - 1] = TH - 1
                    table = pad
                self.dfa_pool[b] = torch.as_tensor(
                    np.asarray(table, np.int8), device=self.device)
                self._dfa_row_key[b] = key
            self.dfa_state[b] = int(state0)
            self.dfa_rows[b] = True

    def set_row_dfa_state(self, b: int, state: int) -> None:
        with self._lock:
            self.dfa_state[b] = int(state)

    def clear_row_dfa(self, b: int) -> None:
        """Take row ``b`` off the DFA (state -1: its mask comes from
        ``mask_pool``); the table stays for a reuse with the same key."""
        with self._lock:
            self.dfa_state[b] = -1
            self.dfa_rows[b] = False

    def _sampler_key(self):
        """(kinds present, top-k width) of the whole pool."""
        hp = self.sampler_params_host
        return (sampling.kinds_key(hp["kind"]),
                sampling.k_cap_key(hp["top_k"], self.vocab))

    def _sparams(self) -> dict:
        if self._sparams_device is None:
            self._sparams_device = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.sampler_params_host.items()}
        return self._sparams_device

    def _host_mask(self):
        """``mask_pool`` where a row has a BNF mask, else None (no work)."""
        return self.mask_pool if self.mask_active.any() else None

    def _sample(self, logits, active, allowed=None):
        """Sample every row under the ``allowed`` (B, V) mask (None: no
        mask); rows outside ``active`` keep their sampler state.  Returns
        (tokens, probs)."""
        kinds, k_cap = self._sampler_key()
        rand = torch.rand(logits.shape[0], generator=self._gen,
                          device=self.device)
        toks, sp, new_ss = sampling.sample_with_rand(
            rand, logits, self._sparams(), self.sampler_state,
            bias=self.bias_pool, allowed_mask=allowed, kinds=kinds,
            k_cap=k_cap)
        old = self.sampler_state
        self.sampler_state = {k: masked_select(active, v, old[k])
                              for k, v in new_ss.items()}
        return toks, sp

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def step(self, tokens: np.ndarray, lengths: np.ndarray,
             sample_mask: np.ndarray, want_logits: bool = False) -> StepResult:
        """Run one merged batch step.

        tokens: (B, T) int32 (suffix-padded); lengths: (B,) valid counts
        (0 = idle row); sample_mask: (B,) bool — rows that draw a token this
        step (decode rows + prefill rows on their final chunk).
        ``want_logits`` also returns the (B, V) raw logits on the device.
        """
        with self._lock:
            B, T = tokens.shape
            if B != self.max_batch:
                raise ValueError(f"batch {B} != max_batch {self.max_batch}")
            dev = self.device
            lengths_t = torch.as_tensor(lengths, dtype=torch.int32,
                                        device=dev)
            summed = bool(self.hsum_rows.any())
            if summed:  # copied before the forward is queued: no stall
                n = torch.as_tensor(np.where(self.hsum_rows, lengths, 0),
                                    dtype=torch.int32, device=dev)
            hidden = self._forward(
                torch.as_tensor(tokens, dtype=torch.int32, device=dev),
                lengths_t)
            if summed:
                # Masked hidden sums of the tracked rows (idle rows have
                # length 0), read before a graph replay overwrites the
                # hidden buffer.
                pos = torch.arange(T, device=dev)[None, :, None]
                self.hsum_pool += (hidden.float()
                                   * (pos < n[:, None, None])).sum(1)
                self.hsum_serial += 1
            logits = head_logits(self.model.params,
                                 take_last_valid(hidden, lengths_t))
            toks, _ = self._sample(
                logits, torch.as_tensor(sample_mask, device=dev),
                self._host_mask())
            return StepResult(tokens=toks.cpu().numpy(),
                              logits=logits if want_logits else None)

    # ------------------------------------------------------------------
    # Multi-token decode: K tokens per host round-trip
    # ------------------------------------------------------------------

    def decode_chunk(self, first_tokens, active: np.ndarray, steps: int,
                     sync: bool = True, host_first: tuple | None = None,
                     budget: np.ndarray | None = None):
        """Decode ``steps`` tokens for all ``active`` rows, feeding each
        sampled token back in, with no host round-trip inside the chunk.

        Inactive rows keep their state and sampler state frozen.  Returns
        (tokens (steps, B), probs (steps, B)).  The pre-chunk state is
        snapshotted on the device for :meth:`rollback_row`.

        ``sync=False`` returns the tokens as a DEVICE tensor: a caller that
        feeds ``tokens[-1]`` into the next chunk keeps the device busy
        across chunks.  ``host_first=(mask, values)`` merges host-provided
        first tokens into a device-resident ``first_tokens`` where ``mask``
        is set.
        ``budget`` (B,) freezes each row after it has drawn that many
        tokens this chunk, so a LENGTH stop never over-consumes state.

        A row with a token DFA (``dfa_state >= 0``) samples under its
        current table row at every step, its state advances by the sampled
        token, and the row freezes (model state, sampler state, DFA state)
        once the grammar halts, so a grammar stop needs no rollback.  The
        step reads one (V,) table row a row, ``dfa_pool[b, dfa_state[b]]``,
        never the whole pool.  It runs only when an active row is on the
        DFA.
        """
        with self._lock:
            dev = self.device
            B = self.max_batch
            if budget is None:
                budget = np.full(B, steps, np.int32)
            if isinstance(first_tokens, torch.Tensor):
                toks = first_tokens.to(device=dev, dtype=torch.int32)
            else:
                toks = torch.as_tensor(np.asarray(first_tokens, np.int32),
                                       device=dev)
            if host_first is not None:
                hmask, hvals = host_first
                toks = torch.where(
                    torch.as_tensor(np.asarray(hmask, np.bool_), device=dev),
                    torch.as_tensor(np.asarray(hvals, np.int32), device=dev),
                    toks)
            active_t = torch.as_tensor(np.asarray(active, np.bool_),
                                       device=dev)
            budget_t = torch.as_tensor(np.asarray(budget, np.int32),
                                       device=dev)
            if steps > 1:
                self._chunk_snaps.append((
                    {k: v.clone() for k, v in self.state_pool.items()},
                    {k: v.clone() for k, v in self.sampler_state.items()},
                    self.dfa_state.clone(), self.dfa_rows.copy()))
                del self._chunk_snaps[:-2]
            dfa = bool(self.dfa_rows[np.asarray(active, np.bool_)].any())
            mask = self._host_mask()
            if dfa:
                # A chunk never takes a row on or off the DFA: ``on`` holds
                # for every step.  Off rows' -1 never equals the halt row.
                ds = self.dfa_state.long()
                on, halt = ds >= 0, self.dfa_height - 1
            toks_seq, sp_seq = [], []
            for i in range(steps):
                act = active_t & (i < budget_t)
                if dfa:
                    srow, mask = dfa_mask(self.dfa_pool, self._rows, ds, on,
                                          self.mask_pool)
                    act = act & (ds != halt)
                hidden = self._forward(toks[:, None], act.to(torch.int32))
                logits = head_logits(self.model.params, hidden[:, 0])
                t2, sp = self._sample(logits, act, mask)
                toks = torch.where(act, t2, toks)
                if dfa:
                    ds = dfa_advance(ds, on, srow, toks, act)
                toks_seq.append(toks)
                sp_seq.append(sp)
            if dfa:
                self.dfa_state.copy_(ds)
            toks_seq = torch.stack(toks_seq)
            sp_seq = torch.stack(sp_seq)
            return (toks_seq.cpu().numpy() if sync else toks_seq), sp_seq

    def restore_last_chunk(self) -> None:
        """Discard the most recent decode chunk entirely: the state pool,
        sampler state and DFA state return to their pre-chunk snapshots."""
        with self._lock:
            if not self._chunk_snaps:
                raise RuntimeError("no chunk snapshot")
            state, self.sampler_state, ds, rows = self._chunk_snaps.pop()
            for k, p in self.state_pool.items():
                p.copy_(state[k])
            self.dfa_state.copy_(ds)
            self.dfa_rows[:] = rows

    def rollback_row(self, b: int, feed_tokens: list[int],
                     depth: int = -1) -> None:
        """Undo a row's over-decoded chunk suffix: restore row ``b`` from
        the pre-chunk snapshot at ring position ``depth`` (-1 = most recent
        launch, -2 = the chunk before it), then re-feed ``feed_tokens``
        with a forward-only masked step.  Device-to-device only."""
        with self._lock:
            if not self._chunk_snaps:
                raise RuntimeError("no chunk snapshot")
            self._write_row(self._read_row(self._chunk_snaps[depth][0], b), b)
        B, T = self.max_batch, self.token_chunk_size
        no_sample = np.zeros(B, np.bool_)
        for i in range(0, len(feed_tokens), T):
            part = feed_tokens[i: i + T]
            toks = np.zeros((B, T), np.int32)
            toks[b, : len(part)] = part
            lengths = np.zeros(B, np.int32)
            lengths[b] = len(part)
            self.step(toks, lengths, no_sample, False)

    def sample_only(self, b: int, logits: np.ndarray) -> int:
        """Sample row ``b`` from externally-provided logits (the exact-hit
        prefix-cache fast path) under its BNF mask, if any.  Updates row b's
        sampler state only."""
        with self._lock:
            B = self.max_batch
            full = torch.zeros((B, self.vocab), dtype=torch.float32,
                               device=self.device)
            full[b] = torch.as_tensor(np.asarray(logits, np.float32),
                                      device=self.device)
            mask = torch.zeros(B, dtype=torch.bool, device=self.device)
            mask[b] = True
            toks, _ = self._sample(full, mask, self._host_mask())
            return int(toks[b].item())
