"""Model lifecycle: load and unload one model environment.

Port of ``ai00_server_tpu/middleware.py`` for ``.st`` RWKV-7, -6, -5 and -4
checkpoints, plain or with the first ``quant`` layers quantized
(``quant_type = "Int8"``, ``"NF4"``, ``"SF4"`` or ``"Int4"``):

* ``reload(ReloadRequest)`` — read the checkpoint onto the device, load
  the tokenizer, build the kernels and the grammar engine, start the
  engine and the runtime (with the ``bnf`` options: the start
  nonterminal of BNF schemas).
* ``unload()`` — drain the runtime and drop the environment.
* ``info()`` — RuntimeInfo for ``/api/models/info``.

Request fields for later slices (LoRA, ``.state`` files, a device mesh)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .device import resolve_device
from .engine import Engine
from .loader import LoadedModel, load_model
from .ops.quant import MODES as QUANT_MODES
from .runtime import Runtime
from .tokenizer import Tokenizer

DEFAULT_TOKENIZER = "assets/tokenizer/rwkv_vocab_v20230424.json"
MAX_TOKENS = 2**31  # the reference's usize::MAX, i.e. unbounded


@dataclass
class ReloadRequest:
    """The JAX package's ReloadRequest, fields for this slice."""
    model_path: str = ""
    lora: list[dict] = field(default_factory=list)
    state: list[dict] = field(default_factory=list)
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
        """Raise for what this slice does not serve yet."""
        self.quant_map()  # an unknown quant_type
        if self.lora or self.state:
            raise NotImplementedError(
                "LoRA and .state files are the ROADMAP '.state files, LoRA "
                "and prefab' item")
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
            "states": [],
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
            model = await loop.run_in_executor(
                None, lambda: load_model(request.model_path, dtype=dtype,
                                         device=self.device,
                                         quant=request.quant_map()))
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
            runtime = Runtime(engine, tokenizer,
                              decode_chunk_size=request.decode_chunk_size,
                              bnf_option=request.bnf
                              if isinstance(request.bnf, dict) else None)
            runtime.start()
            self.env = Environment(reload=request, model=model,
                                   engine=engine, runtime=runtime,
                                   tokenizer=tokenizer)

    async def unload(self) -> None:
        async with self._lock:
            await self._unload_locked()

    async def _unload_locked(self) -> None:
        if self.env is not None:
            env, self.env = self.env, None
            await env.runtime.stop()
