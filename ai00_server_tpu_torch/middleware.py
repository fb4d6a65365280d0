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
  With ``prewarm`` (the default) the engine then runs its serving buckets
  once in the background (``Engine.prewarm`` on the default executor;
  ``Environment.prewarm_future``), so the first request pays no first-call
  set-up; a prewarm that raises is logged with its traceback.
* ``unload()`` — cancel a prewarm in flight and wait for it at most
  ``AI00_PREWARM_DRAIN_S`` seconds (default 120; past that, warn and go
  on), then drain the runtime and drop the environment.
* ``save(path)`` — export the loaded model as a prefab (``prefab.py``).
* ``info()`` — RuntimeInfo for ``/api/models/info``, the states and the
  serving mesh included.

``mesh = [dp, tp]`` serves on a (dp, tp) mesh (``parallel/``): on a card
the distinct cards ``cuda:0 .. cuda:{dp * tp - 1}``, on the CPU the CPU
standing for every place.  tp > 1 serves every version (each tp place
holds H / tp heads, RWKV-4 C / tp channels, and the slices of the
projections).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .device import resolve_device
from .engine import Engine
from .loader import LoadedModel, load_model, read_info
from .models import packing
from .models.info import ModelVersion
from .ops.quant import MODES as QUANT_MODES
from .runtime import NIL_STATE_ID, Runtime
from .tokenizer import Tokenizer

DEFAULT_TOKENIZER = "assets/tokenizer/rwkv_vocab_v20230424.json"
MAX_TOKENS = 2**31  # the reference's usize::MAX, i.e. unbounded

logger = logging.getLogger(__name__)


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
    prewarm: bool = True                                # Engine.prewarm at load

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
            "prewarm": self.prewarm,
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
        """Raise for what the port does not serve: a prefab with LoRA
        entries (a prefab loads as it was saved; serving it unblended would
        silently drop the LoRA), and a mesh that is not ``[dp, tp]`` of
        positive sizes."""
        self.quant_map()  # an unknown quant_type
        if self.model_path.endswith(".prefab") and self.lora:
            raise ValueError(
                f"{self.model_path}: a prefab loads as it was saved and "
                "cannot blend [[lora]] entries; blend them into the "
                "checkpoint and export a new prefab")
        if self.mesh and (len(self.mesh) > 2
                          or any(int(x) < 1 for x in self.mesh)):
            raise ValueError(f"mesh {self.mesh}: one [dp, tp] of positive "
                             "sizes")

    def mesh_shape(self) -> tuple[int, int] | None:
        """(dp, tp), or None for one device."""
        if not self.mesh:
            return None
        dp, tp = (list(self.mesh) + [1, 1])[:2]
        return (int(dp), int(tp)) if int(dp) * int(tp) > 1 else None


@dataclass
class Environment:
    reload: ReloadRequest
    model: LoadedModel
    engine: Engine
    runtime: Runtime
    tokenizer: Tokenizer
    states: list[StateEntry] = field(default_factory=list)
    prewarm_future: Any = None  # the background Engine.prewarm, None if off


def _log_prewarm_failure(future) -> None:
    """Done-callback of a prewarm future: log its exception, if any."""
    if not future.cancelled() and future.exception() is not None:
        logger.error("prewarm failed", exc_info=future.exception())


class Middleware:
    """Owner of the (single) loaded model environment on one device."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.env: Optional[Environment] = None
        self._lock = asyncio.Lock()

    @property
    def loaded(self) -> bool:
        return self.env is not None

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
            # The serving mesh, None on one device (the JAX package's key).
            "mesh": (
                {"dp": mesh.shape["dp"], "tp": mesh.shape["tp"],
                 "devices": mesh.size}
                if (mesh := self.env.engine.mesh) is not None else None),
        }

    def _mesh(self, request: ReloadRequest):
        """The request's serving mesh, or None.  On a card its places are
        the distinct cards; on the CPU the CPU stands for every place (the
        "needs N devices" check then holds only in ``make_mesh``)."""
        shape = request.mesh_shape()
        if shape is None:
            return None
        from .parallel import make_mesh

        dp, tp = shape
        if self.device.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [self.device] * (dp * tp)
        if dp * tp > len(devices):
            raise ValueError(f"mesh [{dp}, {tp}] needs {dp * tp} devices, "
                             f"have {len(devices)}")
        if request.max_batch % dp:
            raise ValueError(f"max_batch {request.max_batch} not divisible "
                             f"by dp={dp}")
        return make_mesh(dp=dp, tp=tp, devices=devices[:dp * tp])

    def _head_size(self, request: ReloadRequest) -> int | None:
        """On a card, the head size whose WKV kernels the model needs (the
        default set for RWKV-4, whose WKV is per channel); None elsewhere.
        A v5 / v6 / v7 model of a head size the kernels are not built for
        (``N % 8 == 0``, ``8 <= N <= 128``) is refused here, from the
        checkpoint's header, before the model in service is unloaded."""
        if self.device.type != "cuda":
            return None
        from .ops import _build

        info = read_info(request.model_path)
        if info.version == ModelVersion.V4:
            return _build.DEFAULT_HEAD
        _build.check_head_size(info.head_size)
        return info.head_size

    async def reload(self, request: ReloadRequest) -> None:
        request.check_supported()
        mesh = self._mesh(request)
        head = self._head_size(request)
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
                # the first request, whatever ``prewarm`` says: the decode
                # graph captured in Engine() needs the kernels, and a build
                # that fails must fail the load.
                await loop.run_in_executor(
                    None, functools.partial(_build.build_all, heads=(head,)))
                await loop.run_in_executor(None, native.get_lib)
            engine = Engine(model, max_batch=request.max_batch,
                            token_chunk_size=request.token_chunk_size,
                            device=self.device, mesh=mesh)
            runtime = Runtime(engine, tokenizer, states=state_map,
                              decode_chunk_size=request.decode_chunk_size,
                              bnf_option=request.bnf
                              if isinstance(request.bnf, dict) else None)
            runtime.start()
            self.env = Environment(reload=request, model=model,
                                   engine=engine, runtime=runtime,
                                   tokenizer=tokenizer, states=entries)
            if request.prewarm:
                future = loop.run_in_executor(None, engine.prewarm,
                                              request.decode_chunk_size)
                future.add_done_callback(_log_prewarm_failure)
                self.env.prewarm_future = future

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

        def save():
            model = env.model
            if env.engine.mesh is not None:  # gather the shards first
                model = LoadedModel(
                    info=model.info,
                    params=env.engine.unsharded_params("cpu"),
                    init_wkv=model.init_wkv, host_params=model.host_params)
            prefab.save_prefab(path, model, env.reload.to_json())

        await asyncio.get_event_loop().run_in_executor(None, save)

    async def unload(self) -> None:
        async with self._lock:
            await self._unload_locked()

    async def _unload_locked(self) -> None:
        if self.env is not None:
            env, self.env = self.env, None
            if env.prewarm_future is not None:
                # The prewarm stops between buckets; a bucket in flight
                # runs to its end.  Wait for it, boundedly: past the bound
                # the reload goes on and the old params stay on the device
                # until the bucket ends.
                env.engine.cancel_prewarm()
                drain_s = float(os.environ.get("AI00_PREWARM_DRAIN_S", "120"))
                t0 = time.monotonic()
                try:
                    await asyncio.wait_for(asyncio.shield(env.prewarm_future),
                                           timeout=drain_s)
                except asyncio.TimeoutError:
                    logger.warning(
                        "unload: prewarm still running after %.1f s of "
                        "drain; proceeding (the old model stays resident "
                        "until it ends)", time.monotonic() - t0)
                except Exception:
                    pass  # logged by _log_prewarm_failure
            await env.runtime.stop()
