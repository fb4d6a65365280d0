"""aiohttp application: the OpenAI-compatible completion surface.

Port of ``ai00_server_tpu/server/app.py`` for this slice:

  POST /api/oai/[v1/]chat/completions   chat, stream + non-stream, with
                                        retrieval-augmented context
  POST /api/oai/[v1/]completions        completions, stream + non-stream
  POST /api/oai/[v1/]chooses            perplexity ranking
  POST /api/oai/[v1/]embeddings         model-derived embeddings
  POST /api/oai/[v1/]embeds             the ``[embed]`` sidecar encoder
  POST /api/retrieval/index|add|search|build|drop, GET /api/retrieval/list
  GET  /api/oai/[v1/]models             current model id
  GET  /api/adapters                    device list (torch.cuda)
  GET  /api/models/info                 RuntimeInfo

Completions and chat take ``bnf_schema`` (a KBNF grammar the output
follows).  Every other route of the JAX server, and every request field
outside the slice (``state``), answers 501 with the ROADMAP item that
brings it.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import re

import numpy as np
import torch
from aiohttp import web

from ..middleware import MAX_TOKENS, Middleware
from ..ops import sampling
from ..retrieval_store import RetrievalStore
from ..runtime import (FinishReason, GenerateKind, GenerateRequest,
                       SamplerSpec)
from .config import Config

_WS_RE = re.compile(r"\n(\s*\n)+")

ROLE_NAMES = {
    "system": "System", "user": "User", "assistant": "Assistant",
    "observation": "Observation", "tool": "Observation",
}

# Routes of the JAX server that later slices bring: (method, path) ->
# ROADMAP item.
LATER_ROUTES = {
    # The raw state (unpooled) is flattened by ``models/packing``.
    ("POST", "/api/oai/states"): ".state files, LoRA and prefab",
    ("POST", "/api/oai/v1/states"): ".state files, LoRA and prefab",
    ("GET", "/api/models/state"): "admin, profile and file routes",
    ("GET", "/api/models/list"): "admin, profile and file routes",
    ("GET", "/api/metrics"): "admin, profile and file routes",
    ("POST", "/api/auth/exchange"): "admin, profile and file routes",
    ("GET", "/admin/models/unload"): "admin, profile and file routes",
    **{("POST", p): "admin, profile and file routes" for p in (
        "/admin/models/load", "/admin/models/save", "/admin/files/unzip",
        "/admin/files/dir", "/admin/files/ls", "/admin/files/config/load",
        "/admin/files/config/save", "/admin/profile/start",
        "/admin/profile/stop")},
    ("GET", "/api-docs/openapi.json"): "admin, profile and file routes",
    ("GET", "/api-docs"): "admin, profile and file routes",
    ("GET", "/api-docs/"): "admin, profile and file routes",
    ("GET", "/"): "admin, profile and file routes",
}

# Request fields that later slices bring -> ROADMAP item.
LATER_FIELDS = {
    "state": ".state files, LoRA and prefab",
}


def _array(value) -> list:
    """Reference Array<T>: none | item | vec."""
    if value is None:
        return []
    if isinstance(value, list):
        return value
    return [value]


def _not_in_slice(what: str, item: str) -> web.Response:
    return web.json_response(
        {"error": f"{what} is not served by the PyTorch port yet "
                  f"(ROADMAP: {item})"}, status=501)


def _sampler_from_json(obj: dict | None, top_p=0.5, top_k=128,
                       temperature=1.0) -> SamplerSpec:
    """SamplerParams tagged union or the flat fields."""
    if obj is None:
        return SamplerSpec(kind=sampling.KIND_NUCLEUS, top_p=top_p,
                           top_k=top_k, temperature=temperature)
    typ = str(obj.get("type", "Nucleus")).lower()
    if typ == "mirostat":
        # The reference's mirostat sampler applies no penalties.
        return SamplerSpec(
            kind=sampling.KIND_MIROSTAT,
            miro_tau=float(obj.get("tau", 3.0)),
            miro_rate=float(obj.get("rate", obj.get("learning_rate", 0.1))),
            presence_penalty=0.0,
            frequency_penalty=0.0,
        )
    common = dict(
        top_k=int(obj.get("top_k", 128)),
        temperature=float(obj.get("temperature", 1.0)),
        presence_penalty=float(obj.get("presence_penalty", 0.3)),
        frequency_penalty=float(obj.get("frequency_penalty", 0.3)),
        penalty_decay=float(obj.get("penalty_decay", 0.99654026)),
    )
    if typ == "typical":
        return SamplerSpec(kind=sampling.KIND_TYPICAL,
                           top_p=float(obj.get("tau", 0.5)), **common)
    return SamplerSpec(kind=sampling.KIND_NUCLEUS,
                       top_p=float(obj.get("top_p", 0.5)), **common)


def _generate_request(body: dict, prompt: str, model_text: str = "",
                      default_stop="\n\n") -> GenerateRequest:
    return GenerateRequest(
        prompt=prompt,
        model_text=model_text,
        max_tokens=min(int(body.get("max_tokens", 256)), MAX_TOKENS),
        stop=_array(body.get("stop", default_stop)),
        bias={int(k): float(v) for k, v in
              (body.get("bias") or body.get("logit_bias") or {}).items()},
        sampler=_sampler_from_json(
            body.get("sampler") or body.get("sampler_override"),
            top_p=float(body.get("top_p", 0.5)),
            top_k=int(body.get("top_k", 128)),
            temperature=float(body.get("temperature", 1.0))),
        bnf_schema=body.get("bnf_schema"),
    )


@web.middleware
async def cors_middleware(request: web.Request, handler):
    """Permissive CORS (any origin, GET/POST/DELETE, any headers)."""
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        resp = await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, DELETE"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    return resp


@web.middleware
async def bad_request_middleware(request: web.Request, handler):
    """Malformed request bodies answer 400.  Handlers set
    ``request["parsed"]`` once the request is built; later parse-class
    exceptions are server bugs and propagate as 500s."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except (json.JSONDecodeError, UnicodeDecodeError, KeyError, TypeError,
            ValueError) as e:
        if request.get("parsed"):
            raise
        return web.json_response(
            {"error": f"bad request: {type(e).__name__}: {e}"}, status=400)


class Server:
    def __init__(self, config: Config, device="cuda"):
        self.config = config
        self.middleware = Middleware(device=device)
        self.retrieval = RetrievalStore(device=self.middleware.device)
        self.embedder = None  # the optional [embed] sidecar (server/embed)
        self.app = web.Application(client_max_size=1 << 30,
                                   middlewares=[cors_middleware,
                                                bad_request_middleware])
        self._routes()

    async def _env(self):
        """Wait until a model is loaded."""
        for _ in range(6000):
            if self.middleware.env is not None:
                return self.middleware.env
            await asyncio.sleep(0.05)
        raise web.HTTPServiceUnavailable(text="no model loaded")

    def _model_name(self) -> str:
        env = self.middleware.env
        return env.reload.model_path if env else ""

    def _routes(self):
        r = self.app.router
        for p in ("/api/oai/chat/completions", "/api/oai/v1/chat/completions"):
            r.add_post(p, self.chat_completions)
        for p in ("/api/oai/completions", "/api/oai/v1/completions"):
            r.add_post(p, self.completions)
        for p in ("/api/oai/chooses", "/api/oai/v1/chooses"):
            r.add_post(p, self.chooses)
        for p in ("/api/oai/embeddings", "/api/oai/v1/embeddings"):
            r.add_post(p, self.embeddings)
        for p in ("/api/oai/embeds", "/api/oai/v1/embeds"):
            r.add_post(p, self.embeds)
        r.add_post("/api/retrieval/index", self.retrieval_index)
        r.add_post("/api/retrieval/add", self.retrieval_add)
        r.add_post("/api/retrieval/search", self.retrieval_search)
        r.add_post("/api/retrieval/build", self.retrieval_build)
        r.add_get("/api/retrieval/list", self.retrieval_list)
        r.add_post("/api/retrieval/drop", self.retrieval_drop)
        for p in ("/api/oai/models", "/api/oai/v1/models"):
            r.add_get(p, self.oai_models)
        r.add_get("/api/adapters", self.adapters)
        r.add_get("/api/models/info", self.models_info)
        for (method, path), item in LATER_ROUTES.items():
            r.add_route(method, path, self._later(path, item))

    @staticmethod
    def _later(path: str, item: str):
        async def handler(request: web.Request):
            return _not_in_slice(path, item)
        return handler

    @staticmethod
    def _later_field(body: dict) -> web.Response | None:
        for name, item in LATER_FIELDS.items():
            if body.get(name):
                return _not_in_slice(f"request field {name!r}", item)
        return None

    # -- OpenAI endpoints ----------------------------------------------------

    async def chat_completions(self, request: web.Request):
        body = await request.json()
        refused = self._later_field(body)
        if refused is not None:
            return refused
        env = await self._env()

        messages = _array(body.get("messages"))
        names = body.get("names", {})
        template = body.get("template", {})
        record_tpl = template.get("record", "{role}: {content}")
        prefix_tpl = template.get("prefix", "{assistant}:")
        sep = template.get("sep", "\n\n")

        parts = []
        model_parts = []
        for m in messages:
            role_key = str(m.get("role", "user")).lower()
            role = names.get(role_key, ROLE_NAMES.get(role_key, "User"))
            content = _WS_RE.sub("\n", str(m.get("content", ""))).strip()
            parts.append(record_tpl.replace("{role}", role)
                         .replace("{content}", content))
            if role_key == "assistant":
                model_parts.append(str(m.get("content", "")))
        prefix = prefix_tpl.replace(
            "{assistant}", names.get("assistant", "Assistant")).replace(
            "{user}", names.get("user", "User"))

        # Retrieval-augmented chat: embed the last user turn, search a
        # named index, prepend the hits as a system record.
        rag = body.get("retrieval")
        if rag and messages:
            last_user = next(
                (str(m.get("content", "")) for m in reversed(messages)
                 if str(m.get("role", "")).lower() == "user"), None)
            if last_user:
                q = await self._embed_texts(env, [last_user])
                search = functools.partial(
                    self.retrieval.search, rag["index"], q,
                    top_k=int(rag.get("top_k", 4)),
                    nprobe=int(rag.get("nprobe", 8)))
                _, _, texts = await asyncio.get_event_loop().run_in_executor(
                    None, search)
                docs = [t for t in texts[0] if t]
                if docs:
                    tpl = rag.get("template",
                                  "Relevant information:\n{documents}")
                    block = tpl.replace("{documents}", "\n".join(docs))
                    parts.insert(0, record_tpl
                                 .replace("{role}",
                                          names.get("system", "System"))
                                 .replace("{content}", block))

        req = _generate_request(body, sep.join(parts) + sep + prefix,
                                model_text=sep.join(model_parts))
        request["parsed"] = True
        if body.get("stream", False):
            return await self._stream_response(
                request, env, req, "chat.completion.chunk",
                lambda first, text: {"delta": (
                    {"role": "Assistant"} if first == "role"
                    else {"content": text})})
        handle = await env.runtime.submit(req)
        text, reason, counter = await _collect_text(handle)
        return web.json_response({
            "object": "chat.completion",
            "model": self._model_name(),
            "choices": [{
                "message": {"role": "Assistant", "content": text.strip()},
                "index": 0,
                "finish_reason": reason.value,
            }],
            "usage": _usage(counter),
        })

    async def completions(self, request: web.Request):
        body = await request.json()
        refused = self._later_field(body)
        if refused is not None:
            return refused
        env = await self._env()
        req = _generate_request(body, "".join(_array(body.get("prompt"))))
        request["parsed"] = True
        if body.get("stream", False):
            return await self._stream_response(
                request, env, req, "text_completion",
                lambda first, text: {"text": text})
        handle = await env.runtime.submit(req)
        text, reason, counter = await _collect_text(handle)
        return web.json_response({
            "object": "text_completion",
            "model": self._model_name(),
            "choices": [{
                "text": text, "index": 0, "finish_reason": reason.value,
            }],
            "usage": _usage(counter),
        })

    async def _stream_response(self, request, env, req, object_name,
                               delta_fn):
        handle = await env.runtime.submit(req)
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        await resp.prepare(request)

        def sse(payload: str) -> bytes:
            return f"data: {payload}\n\n".encode()

        model_name = self._model_name()
        first = True
        try:
            async for msg in handle:
                if msg[0] == "start" and object_name.startswith("chat"):
                    chunk = {"object": object_name, "model": model_name,
                             "choices": [{**delta_fn("role", ""),
                                          "index": 0,
                                          "finish_reason": None}]}
                    await resp.write(sse(json.dumps(chunk)))
                elif msg[0] == "content":
                    text = msg[1]
                    if first:
                        text = text.lstrip() if object_name.startswith(
                            "chat") else text
                        if not text:
                            continue
                        first = False
                    chunk = {"object": object_name, "model": model_name,
                             "choices": [{**delta_fn("content", text),
                                          "index": 0,
                                          "finish_reason": None}]}
                    await resp.write(sse(json.dumps(chunk)))
                elif msg[0] == "stop":
                    chunk = {"object": object_name, "model": model_name,
                             "choices": [{"index": 0,
                                          "finish_reason": msg[1].value}],
                             "usage": _usage(msg[2])}
                    await resp.write(sse(json.dumps(chunk)))
                elif msg[0] == "done":
                    await resp.write(sse("[DONE]"))
        except (ConnectionResetError, asyncio.CancelledError):
            handle.cancel()
            raise
        await resp.write_eof()
        return resp

    async def chooses(self, request: web.Request):
        body = await request.json()
        refused = self._later_field(body)
        if refused is not None:
            return refused
        env = await self._env()
        choices = [str(c) for c in _array(body.get("choices"))]
        req = GenerateRequest(
            prompt="".join(_array(body.get("input"))),
            max_tokens=1,
            kind=GenerateKind.CHOOSE,
            choices=choices,
            calibrate=bool(body.get("calibrate", False)),
        )
        request["parsed"] = True
        handle = await env.runtime.submit(req)
        ppls = None
        async for msg in handle:
            if msg[0] == "choose":
                ppls = msg[1]
        if ppls is None:
            return web.json_response({"error": "choose aborted"},
                                     status=500)
        order = sorted(range(len(choices)), key=lambda i: ppls[i])
        data = [{
            "object": "choice",
            "index": i,
            "rank": rank,
            "choice": choices[i],
            "perplexity": ppls[i],
        } for rank, i in enumerate(order)]
        return web.json_response({
            "object": "list", "model": self._model_name(), "data": data,
        })

    async def _embed_texts(self, env, texts: list[str],
                           pooling: str | None = None) -> np.ndarray:
        """Model-derived sentence embeddings, L2-normalized, one pooled
        STATE request a text (batched across slots).

        ``pooling="mean_hidden"`` (the default): the masked mean over all
        positions of the final hidden states (C dims), read from the
        hidden sums the serving prefill accumulates.  ``pooling="state"``:
        the pooled state (3C dims: mean ``att_x`` | mean ``ffn_x`` | the
        ``wkv`` uniform-query readout, each part unit-normalized; 2C for
        RWKV-4).  The two are not comparable."""
        handles = []
        for text in texts:
            req = GenerateRequest(prompt=str(text), max_tokens=1,
                                  kind=GenerateKind.STATE, pooled=True,
                                  pooling=pooling)
            handles.append(await env.runtime.submit(req))
        vecs = []
        for handle in handles:
            vec = None
            async for msg in handle:
                if msg[0] == "embed_vec":
                    vec = np.asarray(msg[1], np.float32)
            if vec is None:
                raise RuntimeError("embedding aborted before its readout")
            vecs.append(vec)
        return np.stack(vecs) if vecs else np.zeros((0, 0), np.float32)

    async def embeddings(self, request: web.Request):
        body = await request.json()
        refused = self._later_field(body)
        if refused is not None:
            return refused
        env = await self._env()
        inputs = [str(t) for t in _array(body.get("input"))]
        pooling = body.get("pooling")
        if pooling is not None and pooling not in ("mean_hidden", "state"):
            return web.json_response(
                {"error": "pooling must be 'mean_hidden' (C dims) or "
                          "'state' (3C dims)"}, status=400)
        request["parsed"] = True
        vecs = await self._embed_texts(env, inputs, pooling=pooling)
        data = [{"object": "embedding", "index": i, "embedding": v.tolist()}
                for i, v in enumerate(vecs)]
        return web.json_response({
            "object": "list", "model": self._model_name(), "data": data,
            # Vectors of the two poolings are not comparable: echo which
            # one (and its dimensionality) this response used.
            "pooling": pooling or "mean_hidden",
            "dimensions": int(vecs.shape[-1]) if len(data) else 0,
            "usage": {"prompt_tokens": 0, "total_tokens": 0},
        })

    async def embeds(self, request: web.Request):
        """The external embedding sidecar: chunk the input by token budget
        and embed each chunk.  Needs the ``[embed]`` model (400 without)."""
        body = await request.json()
        if self.embedder is None:
            return web.json_response(
                {"error": "no [embed] model configured"}, status=400)
        text = str(body.get("input") or "")
        if not text:
            return web.json_response({"error": "empty input"}, status=400)
        max_tokens = int(body.get("max_tokens", 510))
        prefix = str(body.get("prefix", "query:"))
        emb = self.embedder

        def work():
            return [{"chunk": chunk,
                     "embed": emb.embed([prefix + chunk]).tolist()}
                    for chunk in emb.split_chunks(text, max_tokens)]

        chunk_data = await asyncio.get_event_loop().run_in_executor(
            None, work)
        return web.json_response({
            "object": "embeds", "model": emb.name,
            "data": [{"object": "embed", "index": 0, "chunks": chunk_data}],
        })

    # -- retrieval (RAG) -------------------------------------------------------

    async def retrieval_index(self, request: web.Request):
        body = await request.json()
        name = body["name"]
        texts = [str(t) for t in _array(body.get("texts"))]
        vectors = body.get("vectors")
        if vectors is not None:
            vecs = np.asarray(vectors, np.float32)
            self.retrieval.create(name, int(vecs.shape[-1]))
            self.retrieval.add(name, vecs, texts or None)
        elif texts:
            env = await self._env()
            vecs = await self._embed_texts(env, texts)
            self.retrieval.create(name, int(vecs.shape[-1]))
            self.retrieval.add(name, vecs, texts)
        else:
            self.retrieval.create(name, int(body.get("dim", 0)))
        if body.get("nlist"):
            await asyncio.get_event_loop().run_in_executor(
                None, self.retrieval.build_ivf, name, int(body["nlist"]))
        idx = self.retrieval.get(name)
        return web.json_response({"name": name, "size": idx.size,
                                  "dim": idx.dim})

    async def retrieval_add(self, request: web.Request):
        body = await request.json()
        name = body["name"]
        texts = [str(t) for t in _array(body.get("texts"))]
        if body.get("vectors") is not None:
            size = self.retrieval.add(
                name, np.asarray(body["vectors"], np.float32), texts or None)
        else:
            env = await self._env()
            vecs = await self._embed_texts(env, texts)
            size = self.retrieval.add(name, vecs, texts)
        return web.json_response({"name": name, "size": size})

    async def retrieval_build(self, request: web.Request):
        body = await request.json()
        await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.retrieval.build_ivf(
                body["name"], int(body.get("nlist", 64)),
                int(body.get("iters", 10))))
        return web.json_response({"state": "built"})

    async def retrieval_search(self, request: web.Request):
        body = await request.json()
        name = body["name"]
        if body.get("vectors") is not None:
            q = np.asarray(body["vectors"], np.float32)
        else:
            env = await self._env()
            queries = [str(t) for t in
                       _array(body.get("query") or body.get("queries"))]
            q = await self._embed_texts(env, queries)
        scores, ids, texts = await asyncio.get_event_loop().run_in_executor(
            None, lambda: self.retrieval.search(
                name, q, top_k=int(body.get("top_k", 10)),
                nprobe=int(body.get("nprobe", 8)),
                exact=body.get("exact")))
        return web.json_response({
            "object": "list",
            "data": [{
                "index": qi,
                "hits": [{"id": int(i), "score": float(s), "text": t}
                         for i, s, t in zip(ids[qi], scores[qi], texts[qi])
                         if i >= 0],
            } for qi in range(len(ids))],
        })

    async def retrieval_list(self, request: web.Request):
        return web.json_response(self.retrieval.list())

    async def retrieval_drop(self, request: web.Request):
        body = await request.json()
        self.retrieval.drop(body["name"])
        return web.json_response({"state": "dropped"})

    async def oai_models(self, request: web.Request):
        env = await self._env()
        stem = os.path.splitext(os.path.basename(env.reload.model_path))[0]
        return web.json_response(
            {"data": [{"object": "models", "id": stem}]})

    # -- info ------------------------------------------------------------------

    async def adapters(self, request: web.Request):
        devs = [f"{torch.cuda.get_device_name(i)} (cuda)"
                for i in range(torch.cuda.device_count())]
        if self.middleware.device.type == "cpu":
            devs.append("CPU (cpu)")
        return web.json_response(devs)

    async def models_info(self, request: web.Request):
        info = self.middleware.info()
        if info is None:
            return web.json_response({"state": "none"})
        return web.json_response({"state": "loaded", **info})


def _usage(counter) -> dict:
    if counter is None:
        return {"prompt": 0, "completion": 0, "total": 0,
                "duration": {"secs": 0, "nanos": 0}}
    secs = int(counter.duration)
    nanos = int((counter.duration - secs) * 1e9)
    return {
        "prompt": counter.prompt,
        "completion": counter.completion,
        "total": counter.total,
        "duration": {"secs": secs, "nanos": nanos},
    }


async def _collect_text(handle):
    """Drain a generation to completion; cancel it if the client's HTTP
    task is torn down (disconnect -> CancelledError)."""
    parts, reason, counter = [], FinishReason.NULL, None
    try:
        async for msg in handle:
            if msg[0] == "content":
                parts.append(msg[1])
            elif msg[0] == "stop":
                reason, counter = msg[1], msg[2]
    except asyncio.CancelledError:
        handle.cancel()
        raise
    return "".join(parts), reason, counter
