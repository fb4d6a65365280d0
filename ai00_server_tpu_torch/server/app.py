"""aiohttp application: the whole HTTP API.

Port of ``ai00_server_tpu/server/app.py``, with the same route table:

  POST /api/oai/[v1/]chat/completions   chat, stream + non-stream, with
                                        retrieval-augmented context
  POST /api/oai/[v1/]completions        completions, stream + non-stream
  POST /api/oai/[v1/]chooses            perplexity ranking
  POST /api/oai/[v1/]embeddings         model-derived embeddings
  POST /api/oai/[v1/]embeds             the ``[embed]`` sidecar encoder
  POST /api/oai/[v1/]states             the state after a prompt, packed
                                        (``models/packing``)
  POST /api/retrieval/index|add|search|build|drop, GET /api/retrieval/list
  GET  /api/oai/[v1/]models             current model id
  GET  /api/adapters                    device list (torch.cuda)
  GET  /api/models/info                 RuntimeInfo
  GET  /api/models/state                RuntimeInfo as an SSE stream
  GET  /api/models/list                 model files, size and sampled sha
  GET  /api/metrics                     the scheduler's counters
  POST /api/auth/exchange               app key -> JWT
  POST /admin/models/load|save, GET /admin/models/unload         (JWT)
  POST /admin/files/unzip|dir|ls|config/load|config/save         (JWT)
  POST /admin/profile/start|stop        torch.profiler trace     (JWT)
  GET  /api-docs/openapi.json, /api-docs[/]                      OpenAPI
  GET  /                                the WebUI

Completions and chat take ``bnf_schema`` (a KBNF grammar the output
follows).  Completions, chat, chooses, embeddings and states take
``state``, the initial state: a key (a state id string: a ``[[state]]``
entry's, the nil UUID for the model's own state), a value (``{id, data,
shape}``, the packed layout) or a file (``{id, path}``, under the model
directory).  A path a route may not touch answers 403: the model, LoRA,
state and prefab paths of the admin routes under the model directory, the
file routes' under ``files.PERMITTED``.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import re
import tempfile

import numpy as np
import torch
from aiohttp import web

from ..middleware import (DEFAULT_TOKENIZER, MAX_TOKENS, Middleware,
                          ReloadRequest)
from ..models import packing
from ..ops import sampling
from ..retrieval_store import RetrievalStore
from ..runtime import (FinishReason, GenerateKind, GenerateRequest,
                       SamplerSpec)
from . import auth as auth_mod
from . import files as files_mod
from .config import Config, PathNotPermitted, check_path_permitted, dump_toml
from .openapi import SWAGGER_HTML, build_spec
from .webui import WEBUI_HTML

_WS_RE = re.compile(r"\n(\s*\n)+")

ROLE_NAMES = {
    "system": "System", "user": "User", "assistant": "Assistant",
    "observation": "Observation", "tool": "Observation",
}

# /admin/profile/stop writes the trace to <dir>/PROFILE_TRACE; the default
# dir is PROFILE_DIR under the temporary directory.
PROFILE_DIR = "ai00_profile"
PROFILE_TRACE = "trace.json"


def _array(value) -> list:
    """Reference Array<T>: none | item | vec."""
    if value is None:
        return []
    if isinstance(value, list):
        return value
    return [value]


def _permit(path: str, roots: list[str]) -> None:
    """``check_path_permitted``, a refusal answered 403."""
    try:
        check_path_permitted(path, roots)
    except PathNotPermitted as e:
        raise web.HTTPForbidden(text=str(e)) from e


def _profiler(activities):
    """A ``torch.profiler.profile`` over ``activities`` that records the
    host ops of every thread where this PyTorch offers that
    (``profile_all_threads``), else of the thread that starts it only."""
    from torch.profiler import profile

    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=activities)
    return profile(activities=activities, experimental_config=config)


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
                      default_stop="\n\n", **state) -> GenerateRequest:
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
        **state,
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
        self.web_root = None  # the extracted [web] zip (main.py)
        self._openapi_cache = None  # built from the route table on demand
        self._profile = None  # (profile, dir, steps at its start)
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
        for p in ("/api/oai/states", "/api/oai/v1/states"):
            r.add_post(p, self.states)
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
        r.add_get("/api/models/state", self.models_state_sse)
        r.add_get("/api/models/list", self.models_list)
        r.add_post("/api/auth/exchange", self.auth_exchange)
        r.add_post("/admin/models/load", self._admin(self.admin_load))
        r.add_get("/admin/models/unload", self._admin(self.admin_unload))
        r.add_post("/admin/models/save", self._admin(self.admin_save))
        r.add_post("/admin/files/unzip", self._admin(self.admin_unzip))
        r.add_post("/admin/files/dir", self._admin(self.admin_dir))
        r.add_post("/admin/files/ls", self._admin(self.admin_dir))
        r.add_post("/admin/files/config/load",
                   self._admin(self.admin_config_load))
        r.add_post("/admin/files/config/save",
                   self._admin(self.admin_config_save))
        r.add_get("/api/metrics", self.metrics)
        r.add_post("/admin/profile/start", self._admin(self.profile_start))
        r.add_post("/admin/profile/stop", self._admin(self.profile_stop))
        r.add_get("/api-docs/openapi.json", self.openapi_json)
        r.add_get("/api-docs", self.swagger)
        r.add_get("/api-docs/", self.swagger)
        r.add_get("/", self.webui)

    # -- auth ------------------------------------------------------------------

    def _admin(self, handler):
        """``handler`` behind the JWT (the ``Authorization: Bearer`` header
        or ``?admin_token=``), signed with ``listen.slot``; 401 without a
        valid one, unless ``listen.force_pass``."""
        @functools.wraps(handler)  # the docstring feeds the OpenAPI spec
        async def wrapped(request: web.Request):
            listen = self.config.listen
            if not listen.force_pass:
                h = request.headers.get("Authorization", "")
                token = (h[7:] if h.startswith("Bearer ") else None) \
                    or request.query.get("admin_token")
                if not (token and auth_mod.decode_jwt(token, listen.slot)):
                    raise web.HTTPUnauthorized(text="invalid admin token")
            return await handler(request)
        return wrapped

    async def auth_exchange(self, request: web.Request):
        """Exchange an app key for a JWT."""
        body = await request.json()
        app_id = body.get("app_id", "")
        app_secret = body.get("app_secret", "")
        listen = self.config.listen
        for key in listen.app_keys:
            if key.app_id == app_id and key.secret_key == app_secret:
                token = auth_mod.make_token(app_id, listen.slot,
                                            listen.expire_sec)
                return web.json_response(
                    {"token": token, "code": 200, "message": "SUCCESS"})
        return web.json_response(
            {"token": None, "code": 403,
             "message": "NO-Match AppId and SecretKey"}, status=403)

    def _model_file(self, path: str) -> str:
        """``path`` as given where it lies under the model directory, else
        the name joined to it; 403 where that does not lie under it
        either."""
        model_dir = self.config.model.get("path", "assets/models")
        try:
            check_path_permitted(path, [model_dir])
            return path
        except PathNotPermitted:
            candidate = os.path.join(model_dir, path)
        _permit(candidate, [model_dir])
        return candidate

    async def _resolve_state(self, env, field) -> dict:
        """The request's ``state`` field -> ``GenerateRequest`` keywords.

        * a key (a string): a registered state id; the nil UUID is the
          model's own initial state;
        * a value ``{id, data, shape}``: the packed state; with an id it is
          registered under it (an id already registered is served as it
          is), without one it is served to this request alone;
        * a file ``{id, path}``: a ``.state`` file under the model
          directory (another path answers 403), registered as a value is.

        A ``{"id": ...}`` of a registered id alone is that state.  Anything
        else raises ``ValueError`` (answered 400)."""
        if field is None:
            return {}
        rt = env.runtime
        if isinstance(field, str):
            if field not in rt.states:
                raise ValueError(f"unknown state id {field!r}")
            return {"state_id": field}
        if not isinstance(field, dict):
            raise ValueError("state: a state id, {data, shape} or {path}")
        sid = str(field["id"]) if field.get("id") else None
        if sid is not None and sid in rt.states:
            return {"state_id": sid}
        info = env.model.info
        if "data" in field:
            shape = list(packing.state_shape(info))
            if "shape" in field and list(field["shape"]) != shape:
                raise ValueError(f"state shape {field['shape']}: the model's "
                                f"is {shape}")
            data = np.asarray(field["data"], np.float32)
            if data.size != int(np.prod(shape)):
                raise ValueError(f"state data holds {data.size} numbers: the "
                                f"model's state {shape} holds "
                                f"{int(np.prod(shape))}")
            state = packing.unpack_state(info, data)
        elif "path" in field:
            model_dir = self.config.model.get("path", "assets/models")
            path = field["path"]
            if not os.path.isabs(path):
                path = os.path.join(model_dir, path)
            _permit(path, [model_dir])
            state = await asyncio.get_event_loop().run_in_executor(
                None, packing.load_state_file, info, path)
        else:
            raise ValueError(f"unknown state id {sid!r}" if sid else
                            "state: a state id, {data, shape} or {path}")
        if sid is None:
            return {"state": state}
        rt.register_state(sid, state)
        return {"state_id": sid}

    # -- OpenAI endpoints ----------------------------------------------------

    async def chat_completions(self, request: web.Request):
        body = await request.json()
        env = await self._env()
        state = await self._resolve_state(env, body.get("state"))

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
                                model_text=sep.join(model_parts), **state)
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
        env = await self._env()
        state = await self._resolve_state(env, body.get("state"))
        req = _generate_request(body, "".join(_array(body.get("prompt"))),
                                **state)
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
        env = await self._env()
        state = await self._resolve_state(env, body.get("state"))
        choices = [str(c) for c in _array(body.get("choices"))]
        req = GenerateRequest(
            prompt="".join(_array(body.get("input"))),
            max_tokens=1,
            kind=GenerateKind.CHOOSE,
            choices=choices,
            calibrate=bool(body.get("calibrate", False)),
            **state,
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

    async def states(self, request: web.Request):
        """The state after the input, from the request's initial state,
        packed (``models/packing``): ``data`` flat, ``shape`` ``[L, rows,
        C, 1]``."""
        body = await request.json()
        env = await self._env()
        state = await self._resolve_state(env, body.get("state"))
        req = GenerateRequest(prompt="".join(_array(body.get("input"))),
                              max_tokens=1, kind=GenerateKind.STATE, **state)
        request["parsed"] = True
        handle = await env.runtime.submit(req)
        row, counter = None, None
        async for msg in handle:
            if msg[0] == "embed":
                row = msg[1]
            elif msg[0] == "stop":
                counter = msg[2]
        if row is None:
            return web.json_response({"error": "state extraction aborted"},
                                     status=500)
        info = env.model.info
        flat = await asyncio.get_event_loop().run_in_executor(
            None, packing.pack_state, info, row)
        return web.json_response({
            "object": "list",
            "model": self._model_name(),
            "data": [{"object": "states", "index": 0,
                      "data": flat.reshape(-1).tolist(),
                      "shape": list(packing.state_shape(info))}],
            "usage": _usage(counter),
        })

    async def _embed_texts(self, env, texts: list[str],
                           pooling: str | None = None,
                           state: dict | None = None) -> np.ndarray:
        """Model-derived sentence embeddings, L2-normalized, one pooled
        STATE request a text (batched across slots).

        ``pooling="mean_hidden"`` (the default): the masked mean over all
        positions of the final hidden states (C dims), read from the
        hidden sums the serving prefill accumulates.  ``pooling="state"``:
        the pooled state (3C dims: mean ``att_x`` | mean ``ffn_x`` | the
        ``wkv`` uniform-query readout, each part unit-normalized; 2C for
        RWKV-4).  The two are not comparable.  ``state``: the initial state
        keywords of :meth:`_resolve_state` (``pooling`` then defaults to
        ``"state"``)."""
        handles = []
        for text in texts:
            req = GenerateRequest(prompt=str(text), max_tokens=1,
                                  kind=GenerateKind.STATE, pooled=True,
                                  pooling=pooling, **(state or {}))
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
        env = await self._env()
        inputs = [str(t) for t in _array(body.get("input"))]
        state = await self._resolve_state(env, body.get("state"))
        pooling = body.get("pooling")
        if pooling is not None and pooling not in ("mean_hidden", "state"):
            return web.json_response(
                {"error": "pooling must be 'mean_hidden' (C dims) or "
                          "'state' (3C dims)"}, status=400)
        request["parsed"] = True
        vecs = await self._embed_texts(env, inputs, pooling=pooling,
                                       state=state)
        data = [{"object": "embedding", "index": i, "embedding": v.tolist()}
                for i, v in enumerate(vecs)]
        return web.json_response({
            "object": "list", "model": self._model_name(), "data": data,
            # Vectors of the two poolings are not comparable: echo which
            # one (and its dimensionality) this response used.
            "pooling": pooling or ("state" if state else "mean_hidden"),
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

    async def models_state_sse(self, request: web.Request):
        """RuntimeInfo as an SSE stream: the ``/api/models/info`` body once
        a second until the client leaves."""
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        try:
            while True:
                info = self.middleware.info()
                payload = json.dumps(
                    {"state": "loaded", **info} if info else {"state": "none"})
                await resp.write(f"data: {payload}\n\n".encode())
                await asyncio.sleep(1.0)
        except (ConnectionResetError, asyncio.CancelledError, OSError):
            pass
        return resp

    async def metrics(self, request: web.Request):
        """Prometheus text metrics: whether a model is loaded, the
        scheduler's counters (``ai00_runtime_<name>``, ``Runtime.metrics``),
        busy and total slots, and the mean seconds a device step."""
        lines = []
        env = self.middleware.env
        lines.append(f"ai00_model_loaded {int(env is not None)}")
        if env is not None:
            m = env.runtime.metrics
            for k, v in m.items():
                lines.append(f"ai00_runtime_{k} {v}")
            lines.append(f"ai00_slots_busy {env.runtime.busy_count()}")
            lines.append(f"ai00_slots_total {env.runtime.max_batch}")
            steps = max(m["steps"], 1)
            lines.append(
                f"ai00_step_seconds_avg {m['step_seconds'] / steps:.6f}")
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    async def profile_start(self, request: web.Request):
        """Start a torch.profiler trace (admin).  Body: ``{dir}``, where
        ``/admin/profile/stop`` writes the trace (default
        ``ai00_profile`` under the temporary directory, ``/tmp`` unless
        ``TMPDIR`` says otherwise).

        The profile records the host's PyTorch ops and, on a CUDA server,
        the device's activity through CUPTI: every kernel of the process,
        the kernels of CUDA graph replays included, whichever thread
        launched them.  The engine's work runs on the runtime's worker
        thread: its host ops are recorded where this PyTorch can profile
        every thread (``profile_all_threads``; PyTorch 2.11 on an H100
        put 99.8% of a traced completion's host ops there), else only the
        event loop's thread's (which launches no device work).  A CUDA server whose
        PyTorch cannot record CUDA activity answers 501 and starts
        nothing; a trace already running answers 409 and is left as it
        is."""
        from torch.profiler import ProfilerActivity, supported_activities

        body = await request.json() if request.can_read_body else {}
        trace_dir = str(body.get("dir") or os.path.join(
            tempfile.gettempdir(), PROFILE_DIR))
        request["parsed"] = True
        if self._profile is not None:
            return web.json_response(
                {"error": "a trace is already running", "dir":
                 self._profile[1]}, status=409)
        activities = [ProfilerActivity.CPU]
        if self.middleware.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                return web.json_response(
                    {"error": "this PyTorch cannot record CUDA activity: "
                              "no trace started"}, status=501)
            activities.append(ProfilerActivity.CUDA)
        prof = _profiler(activities)
        prof.start()
        self._profile = (prof, trace_dir, self._steps())
        return web.json_response({"state": "tracing", "dir": trace_dir})

    async def profile_stop(self, request: web.Request):
        """Stop the trace (admin) and write it as Chrome trace JSON to
        ``<dir>/trace.json`` (``PROFILE_TRACE``).  No trace running answers
        409.  On a CUDA server, a trace over which the scheduler ran device
        steps but that holds no CUDA event answers 500 (it is written all
        the same)."""
        if self._profile is None:
            return web.json_response({"error": "no trace is running"},
                                     status=409)
        (prof, trace_dir, steps0), self._profile = self._profile, None
        cuda = self.middleware.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.middleware.device)
        prof.stop()

        def write() -> bool:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, PROFILE_TRACE))
            return cuda and any(
                e.device_type() == torch.autograd.DeviceType.CUDA
                for e in prof.profiler.kineto_results.events())

        saw_cuda = await asyncio.get_event_loop().run_in_executor(None, write)
        if cuda and not saw_cuda and self._steps() > steps0:
            return web.json_response(
                {"error": "the trace recorded no CUDA activity while the "
                          "server ran device steps"}, status=500)
        return web.json_response({"state": "stopped"})

    def _steps(self) -> int:
        env = self.middleware.env
        return env.runtime.metrics["steps"] if env is not None else 0

    async def models_list(self, request: web.Request):
        """The model files under the model directory."""
        model_dir = self.config.model.get("path", "assets/models")
        out = await asyncio.get_event_loop().run_in_executor(
            None, files_mod.list_models, model_dir)
        return web.json_response(out)

    async def admin_load(self, request: web.Request):
        """Load or reload a model (admin).  Body: a ReloadRequest; without
        ``tokenizer_path`` the configured tokenizer.  The model path and
        every ``lora`` and ``state`` path lie under the model directory
        (given as such or as a name in it), else 403."""
        body = await request.json()
        if "tokenizer_path" not in body:
            body["tokenizer_path"] = self.config.tokenizer.get(
                "path", DEFAULT_TOKENIZER)
        req = ReloadRequest.from_json(body)
        req.model_path = self._model_file(req.model_path)
        req.lora = [{**e, "path": self._model_file(e["path"])}
                    for e in req.lora]
        req.state = [{**e, "path": self._model_file(e["path"])}
                     for e in req.state]
        request["parsed"] = True
        try:
            await self.middleware.reload(req)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"state": "loaded"})

    async def admin_unload(self, request: web.Request):
        """Unload the model (admin)."""
        await self.middleware.unload()
        return web.json_response({"state": "unloaded"})

    async def admin_save(self, request: web.Request):
        """Save the loaded model as a prefab (admin).  Body: ``{path}``,
        under the model directory (a name is put in it), else 403."""
        body = await request.json()
        path = self._model_file(body.get("path") or body.get("model_path"))
        request["parsed"] = True
        try:
            await self.middleware.save(path)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"state": "saved", "path": path})

    async def admin_unzip(self, request: web.Request):
        """Extract a zip (admin).  Body: ``{zip_path, target_dir}``, both
        under ``files.PERMITTED``, and every member under the target, else
        403."""
        body = await request.json()
        source = body.get("zip_path") or body.get("source")
        target = body.get("target_dir") or body.get("target")
        for p in (source, target):
            _permit(p, files_mod.PERMITTED)
        request["parsed"] = True
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, files_mod.unzip, source, target)
        except PermissionError as e:
            raise web.HTTPForbidden(text=str(e)) from e
        return web.json_response({"state": "ok"})

    async def admin_dir(self, request: web.Request):
        """List a directory under ``files.PERMITTED`` (admin)."""
        body = await request.json()
        path = body.get("path", ".")
        _permit(path, files_mod.PERMITTED)
        out = await asyncio.get_event_loop().run_in_executor(
            None, files_mod.list_dir, path)
        return web.json_response(out)

    async def admin_config_load(self, request: web.Request):
        """Read a config TOML under ``files.PERMITTED`` (admin)."""
        body = await request.json()
        path = body.get("path", "assets/configs/Config.toml")
        _permit(path, files_mod.PERMITTED)
        return web.json_response(Config.from_toml(path).to_dict())

    async def admin_config_save(self, request: web.Request):
        """Write a config TOML under ``files.PERMITTED`` (admin).  Body:
        ``{path, config}``."""
        body = await request.json()
        path = body.get("path", "assets/configs/Config.toml")
        _permit(path, files_mod.PERMITTED)
        cfg = Config.from_dict(body.get("config", {}))
        with open(path, "w") as f:
            f.write(dump_toml(cfg.to_dict()))
        return web.json_response({"state": "saved"})

    # -- docs and the WebUI ----------------------------------------------------

    async def openapi_json(self, request: web.Request):
        if self._openapi_cache is None:
            self._openapi_cache = build_spec(self.app)
        return web.json_response(self._openapi_cache)

    async def swagger(self, request: web.Request):
        return web.Response(text=SWAGGER_HTML, content_type="text/html")

    async def webui(self, request: web.Request):
        """The WebUI: a configured ``[web]`` zip's ``index.html``, else the
        built-in page."""
        if self.web_root is not None:
            index = os.path.join(self.web_root, "index.html")
            if os.path.isfile(index):
                return web.FileResponse(index)
        return web.Response(text=WEBUI_HTML, content_type="text/html")


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
