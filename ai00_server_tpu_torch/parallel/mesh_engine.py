"""The engine on a (dp, tp) mesh of places, for one controller.

Port of the mesh half of ``ai00_server_tpu/engine.py`` (``Engine(mesh=)``,
its ``local_batch`` and ``_mesh_forward``).  ``Engine(model, max_batch,
token_chunk_size, mesh=mesh)`` returns a :class:`MeshEngine`: the runtime,
middleware and server go on calling one engine of ``max_batch`` rows, and
it owns one engine per dp rank.

* Row ``b`` lives in dp rank ``b // (max_batch / dp)`` at its local row
  ``b % (max_batch / dp)``.  Every row method goes to that rank's engine;
  ``step`` and ``decode_chunk`` split their rows over the ranks and gather
  the tokens (and the logits, the probabilities) on the mesh's first place.
* At tp = 1 a rank's engine is the single-device :class:`Engine` on its
  place, at the local batch: its own pools, sampler, snapshot ring and, on
  a card, its own decode graph of ``ops/fused_decode.stack_for(version,
  params, max_batch / dp)``'s stack (the fused one at 8 rows a rank, where
  the whole batch would take the phased one).  Ranks on one device share
  one params tree, so the fused layout is installed once per weight.
* At tp > 1 (every version: the JAX package's tp path is the generic
  layer path) a rank's engine is a :class:`TPShard`: the weights split over
  its tp places (``parallel/sharding.shard_params``), the WKV state on its
  heads (RWKV-4's on its channels), and the version's layer path
  ``models/v*.forward_tp`` (``wkv7_chunk`` / ``wkv7_t1``, ``wkv56_chunk``
  / ``wkv56_t1`` on H / tp heads, ``wkv4_chunk`` on C / tp channels, the
  quantized products on sliced codes); the LM head runs on each place's
  vocabulary slice and is gathered on the rank's first place.  No fused or
  phased stack, no graph.
* A quantized model gets the int8 LM head here as on one device (split on
  the vocabulary at tp > 1); the JAX engine skips it on a mesh.
* Each dp rank samples from its own generator: a sharded run equals the
  unsharded one under greedy sampling or given uniforms
  (``sampling.sample_with_rand``), not under seeded random draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import (Engine, StepResult, head_logits, install_head_q,
                      run_prewarm)
from ..loader import LoadedModel
from ..models import get_version_module
from . import sharding
from .collectives import all_gather, broadcast


class TPShard(Engine):
    """One dp rank's engine at tp > 1: the :class:`Engine` with its state
    pool split over the rank's tp places (one dict each, the WKV on its
    heads or channels, ``att_x`` / ``ffn_x`` whole on every place) and the
    forward of the version's ``forward_tp``.  Its sampler, bias, mask,
    DFA and hidden-sum pools live on the first place.  Row reads gather
    the heads (channels) into one row on the first place; row writes split
    them."""

    def __init__(self, model: LoadedModel, params: list, max_batch: int,
                 token_chunk_size: int, places):
        self.places = list(places)
        self.part_params = params
        self._tp_mesh = sharding.Mesh((tuple(self.places),))
        super().__init__(
            LoadedModel(info=model.info, params=params[0],
                        init_wkv=model.init_wkv,
                        host_params=model.host_params),
            max_batch, token_chunk_size, device=self.places[0])

    def _new_pool(self, B: int) -> list:
        whole = self.module.init_state(self.info, B, device=self.device)
        return sharding.shard_state(whole, self._tp_mesh)[0]

    def _decode_stack(self, B: int):
        return None

    def _forward(self, tokens, lengths):
        hidden, new = self.module.forward_tp(self.part_params,
                                             self.state_pool, tokens, lengths)
        for pool, part in zip(self.state_pool, new):
            for k, p in pool.items():
                p.copy_(part[k])
        return hidden

    def _forward_state(self, state: dict, tokens, lengths):
        parts = sharding.shard_state(state, self._tp_mesh)[0]
        hidden, new = self.module.forward_tp(self.part_params, parts, tokens,
                                             lengths)
        return hidden, sharding.unshard_state([new], self.device)

    def _logits(self, x):
        parts = [head_logits(p, xj) for p, xj in
                 zip(self.part_params, broadcast(x, self.places))]
        return all_gather(parts, -1, self.device)

    def _write_row(self, row: dict, b: int) -> None:
        whole = {k: torch.as_tensor(v, device=self.device)
                 for k, v in row.items()}
        parts = sharding.shard_state(whole, self._tp_mesh)[0]
        for pool, part in zip(self.state_pool, parts):
            for k, p in pool.items():
                p[:, b] = part[k][:, 0].to(p.dtype)

    def _read_row(self, pool: list, b: int) -> dict:
        return sharding.unshard_state(
            [[{k: p[:, b:b + 1] for k, p in part.items()} for part in pool]],
            self.device)

    def _snap_pool(self):
        return [{k: v.clone() for k, v in part.items()}
                for part in self.state_pool]

    def _restore_pool(self, snap) -> None:
        for pool, part in zip(self.state_pool, snap):
            for k, p in pool.items():
                p.copy_(part[k])


class MeshEngine:
    """:class:`Engine`'s methods over ``max_batch`` rows, on a mesh: one
    engine per dp rank in :attr:`shards` (module docstring)."""

    def __init__(self, model: LoadedModel, max_batch: int = 8,
                 token_chunk_size: int = 128, device=None, *, mesh):
        """``device`` is not read: the mesh's places are the devices."""
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        if max_batch % dp:
            raise ValueError(f"max_batch {max_batch} not divisible by "
                             f"dp={dp}")
        self.mesh = mesh
        self.model, self.info = model, model.info
        self.module = get_version_module(model.info.version)
        self.max_batch = int(max_batch)
        self.local_batch = self.max_batch // dp
        self.token_chunk_size = int(token_chunk_size)
        self.vocab = model.info.num_vocab
        self.device = mesh.devices[0][0]
        install_head_q(model)
        self._grid = sharding.shard_params(model.params, mesh)
        # The weights live in the places' trees now: unsharded_params()
        # gathers a whole copy.
        model.params = None
        self.shards = []
        for row, places in zip(self._grid, mesh.devices):
            if tp == 1:
                sub = LoadedModel(info=model.info, params=row[0],
                                  init_wkv=model.init_wkv,
                                  host_params=model.host_params)
                self.shards.append(Engine(sub, self.local_batch,
                                          token_chunk_size,
                                          device=places[0]))
            else:
                self.shards.append(TPShard(model, row, self.local_batch,
                                           token_chunk_size, places))
        self.dfa_height = self.shards[0].dfa_height

    def _at(self, b: int):
        d, lb = divmod(int(b), self.local_batch)
        return self.shards[d], lb

    def _rows(self):
        n = self.local_batch
        return [slice(d * n, (d + 1) * n) for d in range(len(self.shards))]

    def unsharded_params(self, device="cpu") -> dict:
        """The whole params gathered on ``device`` (a prefab export)."""
        return sharding.unshard_params(self._grid, device)

    # -- rows ------------------------------------------------------------

    @property
    def hsum_serial(self) -> int:
        return sum(s.hsum_serial for s in self.shards)

    def fresh_row_state(self) -> dict:
        return self.shards[0].fresh_row_state()

    def load_row_state(self, b: int, row_state=None,
                       hidden_sums: bool = False) -> None:
        s, lb = self._at(b)
        s.load_row_state(lb, row_state, hidden_sums)

    def read_row_state(self, b: int) -> dict:
        s, lb = self._at(b)
        return s.read_row_state(lb)

    def read_row_state_device(self, b: int) -> dict:
        s, lb = self._at(b)
        return s.read_row_state_device(lb)

    def read_row_hidden_sum(self, b: int) -> np.ndarray:
        s, lb = self._at(b)
        return s.read_row_hidden_sum(lb)

    def read_hidden_sums(self) -> np.ndarray:
        return np.concatenate([s.read_hidden_sums() for s in self.shards])

    def read_row_embed(self, b: int) -> np.ndarray:
        s, lb = self._at(b)
        return s.read_row_embed(lb)

    def mean_hidden_embed(self, token_ids, chunk: int | None = None
                          ) -> np.ndarray:
        return self.shards[0].mean_hidden_embed(token_ids, chunk)

    def position_logps(self, tokens: list[int], b: int | None = None,
                       state=None) -> np.ndarray:
        if state is not None:
            return self.shards[0].position_logps(tokens, state=state)
        s, lb = self._at(b)
        return s.position_logps(tokens, b=lb)

    def set_row_sampler(self, b: int, params: dict, prompt_tokens=()) -> None:
        s, lb = self._at(b)
        s.set_row_sampler(lb, params, prompt_tokens)

    def reset_row_sampler_key(self, b: int) -> None:
        s, lb = self._at(b)
        s.reset_row_sampler_key(lb)

    def set_row_sampler_state(self, b: int, pen, seen) -> None:
        s, lb = self._at(b)
        s.set_row_sampler_state(lb, pen, seen)

    def set_row_bias(self, b: int, bias) -> None:
        s, lb = self._at(b)
        s.set_row_bias(lb, bias)

    def set_row_mask(self, b: int, allowed) -> None:
        s, lb = self._at(b)
        s.set_row_mask(lb, allowed)

    def set_row_dfa(self, b: int, table, state0: int, key=None) -> None:
        s, lb = self._at(b)
        s.set_row_dfa(lb, table, state0, key)

    def set_row_dfa_state(self, b: int, state: int) -> None:
        s, lb = self._at(b)
        s.set_row_dfa_state(lb, state)

    def clear_row_dfa(self, b: int) -> None:
        s, lb = self._at(b)
        s.clear_row_dfa(lb)

    def sample_only(self, b: int, logits) -> int:
        s, lb = self._at(b)
        return s.sample_only(lb, logits)

    def rollback_row(self, b: int, feed_tokens: list[int],
                     depth: int = -1) -> None:
        s, lb = self._at(b)
        s.rollback_row(lb, feed_tokens, depth)

    # -- batches ---------------------------------------------------------

    def step(self, tokens: np.ndarray, lengths: np.ndarray,
             sample_mask: np.ndarray, want_logits: bool = False):
        """:meth:`Engine.step` over every rank's rows; the tokens and the
        logits gathered on the mesh's first place."""
        if tokens.shape[0] != self.max_batch:
            raise ValueError(f"batch {tokens.shape[0]} != max_batch "
                             f"{self.max_batch}")
        outs = [s.step_device(tokens[r], lengths[r], sample_mask[r])
                for s, r in zip(self.shards, self._rows())]
        toks = all_gather([t for t, _ in outs], 0, self.device)
        logits = (all_gather([lg for _, lg in outs], 0, self.device)
                  if want_logits else None)
        return StepResult(tokens=toks.cpu().numpy(), logits=logits)

    def decode_chunk(self, first_tokens, active: np.ndarray, steps: int,
                     sync: bool = True, snapshot: bool = True,
                     host_first: tuple | None = None,
                     budget: np.ndarray | None = None):
        """:meth:`Engine.decode_chunk` over every rank's rows.  Device
        ``first_tokens`` (the previous chunk's, on the first place) are
        split over the ranks; the (steps, B) tokens and probabilities come
        back gathered on the first place.  ``snapshot`` goes to every
        rank."""
        if budget is None:
            budget = np.full(self.max_batch, steps, np.int32)
        if not isinstance(first_tokens, torch.Tensor):
            first_tokens = np.asarray(first_tokens, np.int32)
        active = np.asarray(active, np.bool_)
        outs = []
        for s, r in zip(self.shards, self._rows()):
            hf = None if host_first is None else (
                np.asarray(host_first[0])[r], np.asarray(host_first[1])[r])
            outs.append(s.decode_chunk(first_tokens[r], active[r], steps,
                                       sync=False, snapshot=snapshot,
                                       host_first=hf,
                                       budget=np.asarray(budget)[r]))
        toks = all_gather([t for t, _ in outs], 1, self.device)
        sp = all_gather([p for _, p in outs], 1, self.device)
        return (toks.cpu().numpy() if sync else toks), sp

    def restore_last_chunk(self) -> None:
        for s in self.shards:
            s.restore_last_chunk()

    def cancel_prewarm(self) -> None:
        """:meth:`Engine.cancel_prewarm`."""
        self._prewarm_cancelled = True

    def prewarm(self, decode_chunk_size: int = 8) -> None:
        """:meth:`Engine.prewarm` over the mesh: the same buckets through
        :meth:`step` and :meth:`decode_chunk`, so every rank runs them."""
        run_prewarm(self, decode_chunk_size)
