"""Model lifecycle: load and unload one model environment.

Port of ``ai00_server_tpu/middleware.py`` for RWKV-7, -6, -5 and -4
checkpoints (``.st``, ``.pth`` / ``.pt`` or a ``.prefab``), plain or with
the first ``quant`` layers quantized (``quant_type = "Int8"``, ``"NF4"``,
``"SF4"`` or ``"Int4"``):

* ``reload(ReloadRequest)`` — read the checkpoint onto the device (a prefab
  as it was saved; otherwise with the ``lora`` entries blended in before
  quantization), read the ``state`` entries (``.state`` files: the
  registered initial states, one of them perhaps the ``default``), load
  the tokenizer, build the kernels and the grammar engine, start the
  engine and the runtime (with the ``bnf`` options: the start
  nonterminal of BNF schemas).
* ``unload()`` — drain the runtime and drop the environment.
* ``save(path)`` — export the loaded model as a prefab (``prefab.py``).
* ``info()`` — RuntimeInfo for ``/api/models/info``, the states included.

A device mesh raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import asyncio
import os
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .device import resolve_device
from .engine import Engine
from .loader import LoadedModel, load_model
from .models import packing
from .ops.quant import MODES as QUANT_MODES
from .runtime import NIL_STATE_ID, Runtime
from .tokenizer import Tokenizer

DEFAULT_TOKENIZER = "assets/tokenizer/rwkv_vocab_v20230424.json"
MAX_TOKENS = 2**31  # the reference's usize::MAX, i.e. unbounded


@dataclass
class StateEntry:
    name: str
    id: str
    default: bool = False


@dataclass
class ReloadRequest:
    """The JAX package's ReloadRequest."""
    model_path: str = ""
    lora: list[dict] = field(default_factory=list)      # {path, alpha}
    state: list[dict] = field(default_factory=list)     # {path, name, id, default}
    quant: int = 0
    quant_type: str = "Int8"
    precision: str = "Fp16"                             # Fp16 | Fp32
    token_chunk_size: int = 128
    max_batch: int = 8
    tokenizer_path: str = DEFAULT_TOKENIZER
    bnf: dict = field(default_factory=dict)
    adapter: Any = "Auto"
    decode_chunk_size: int = 16
    mesh: Optional[list] = None

    @classmethod
    def from_json(cls, obj: dict) -> "ReloadRequest":
        r = cls()
        for k in obj:
            if hasattr(r, k):
                setattr(r, k, obj[k])
        return r

    def to_json(self) -> dict:
        return {
            "model_path": self.model_path,
            "lora": self.lora,
            "state": self.state,
            "quant": self.quant,
            "quant_type": self.quant_type,
            "precision": self.precision,
            "token_chunk_size": self.token_chunk_size,
            "max_batch": self.max_batch,
            "tokenizer_path": self.tokenizer_path,
            "bnf": self.bnf,
            "adapter": self.adapter,
            "decode_chunk_size": self.decode_chunk_size,
            "mesh": self.mesh,
        }

    def quant_map(self) -> dict | None:
        """{layer index: mode} for the first ``quant`` layers, or None.
        An unknown ``quant_type`` raises: loading the model unquantized
        instead would silently take several times the memory asked for."""
        if self.quant <= 0:
            return None
        mode = self.quant_type.lower()
        if mode not in QUANT_MODES:
            raise ValueError(
                f"quant_type {self.quant_type!r}: one of Int8, NF4, SF4, "
                "Int4")
        return {i: mode for i in range(self.quant)}

    def check_supported(self) -> None:
        """Raise for what the port does not serve: a device mesh (not yet),
        and a prefab with LoRA entries (a prefab loads as it was saved;
        serving it unblended would silently drop the LoRA)."""
        self.quant_map()  # an unknown quant_type
        if self.model_path.endswith(".prefab") and self.lora:
            raise ValueError(
                f"{self.model_path}: a prefab loads as it was saved and "
                "cannot blend [[lora]] entries; blend them into the "
                "checkpoint and export a new prefab")
        if self.mesh and any(int(x) > 1 for x in self.mesh):
            raise NotImplementedError(
                "a device mesh is the ROADMAP multi-device item")


@dataclass
class Environment:
    reload: ReloadRequest
    model: LoadedModel
    engine: Engine
    runtime: Runtime
    tokenizer: Tokenizer
    states: list[StateEntry] = field(default_factory=list)


class Middleware:
    """Owner of the (single) loaded model environment on one device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.env: Optional[Environment] = None
        self._lock = asyncio.Lock()

    def info(self) -> Optional[dict]:
        """RuntimeInfo equivalent."""
        if self.env is None:
            return None
        info = self.env.model.info
        return {
            "reload": self.env.reload.to_json(),
            "model": {
                "version": info.version.value,
                "num_layer": info.num_layer,
                "num_emb": info.num_emb,
                "num_hidden": info.num_hidden,
                "num_vocab": info.num_vocab,
                "num_head": info.num_head,
                "head_size": info.head_size,
            },
            "states": [{"name": s.name, "id": s.id, "default": s.default}
                       for s in self.env.states],
            "tokenizer": self.env.reload.tokenizer_path,
            "device": str(self.device),
        }

    async def reload(self, request: ReloadRequest) -> None:
        request.check_supported()
        async with self._lock:
            await self._unload_locked()
            loop = asyncio.get_event_loop()
            dtype = (torch.float32 if request.precision == "Fp32"
                     else torch.bfloat16)
            model = await loop.run_in_executor(None, self._load, request,
                                               dtype)
            entries, state_map = await loop.run_in_executor(
                None, self._load_states, request, model)
            tokenizer = await loop.run_in_executor(
                None, Tokenizer.from_file, request.tokenizer_path)
            if self.device.type == "cuda":
                from . import native
                from .ops import _build

                # Build the kernels and the grammar engine now, not inside
                # the first request.
                await loop.run_in_executor(None, _build.build_all)
                await loop.run_in_executor(None, native.get_lib)
            engine = Engine(model, max_batch=request.max_batch,
                            token_chunk_size=request.token_chunk_size,
                            device=self.device)
            runtime = Runtime(engine, tokenizer, states=state_map,
                              decode_chunk_size=request.decode_chunk_size,
                              bnf_option=request.bnf
                              if isinstance(request.bnf, dict) else None)
            runtime.start()
            self.env = Environment(reload=request, model=model,
                                   engine=engine, runtime=runtime,
                                   tokenizer=tokenizer, states=entries)

    def _load(self, request: ReloadRequest, dtype) -> LoadedModel:
        """A prefab as it was saved (its own dtypes and codes), else the
        checkpoint with the LoRA entries blended in and then quantized."""
        if request.model_path.endswith(".prefab"):
            from . import prefab

            return prefab.load_prefab(request.model_path, self.device)
        loras = [(entry["path"], float(entry.get("alpha", 1.0)))
                 for entry in request.lora]
        return load_model(request.model_path, dtype=dtype,
                          device=self.device, quant=request.quant_map(),
                          loras=loras)

    @staticmethod
    def _load_states(request: ReloadRequest, model: LoadedModel):
        """The ``state`` entries as StateEntry records and the runtime's
        registry: each id (a fresh uuid4 where none is given) to its host
        state, ``"default"`` to the entry marked default (else the model's
        own state) and the nil UUID to the model's own state."""
        entries, state_map = [], {}
        for st in request.state:
            sid = str(st.get("id") or uuid.uuid4())
            data = packing.load_state_file(model.info, st["path"])
            state_map[sid] = data
            entries.append(StateEntry(
                name=st.get("name") or os.path.basename(st["path"]),
                id=sid, default=bool(st.get("default"))))
            if entries[-1].default:
                state_map["default"] = data
        state_map[NIL_STATE_ID] = None
        return entries, state_map

    async def save(self, path: str) -> None:
        """Export the loaded model as a prefab at ``path``: its params (codes
        as they are, the lossless head where the engine keeps an int8 one),
        its embedded initial state, its info and the reload request."""
        if self.env is None:
            raise RuntimeError("no model loaded")
        from . import prefab

        env = self.env
        await asyncio.get_event_loop().run_in_executor(
            None, prefab.save_prefab, path, env.model, env.reload.to_json())

    async def unload(self) -> None:
        async with self._lock:
            await self._unload_locked()

    async def _unload_locked(self) -> None:
        if self.env is not None:
            env, self.env = self.env, None
            await env.runtime.stop()
