"""The OpenAPI document and the Swagger UI page at ``/api-docs``.

Port of ``ai00_server_tpu/server/openapi.py``: ``build_spec`` documents
every route of the live route table, with the hand-written request bodies
of ``OPENAPI_SPEC`` where it has them.
"""

from __future__ import annotations


def _op(summary, body=None, tags=None):
    op = {"summary": summary, "responses": {"200": {"description": "OK"}}}
    if body:
        op["requestBody"] = {"content": {"application/json": {
            "schema": body}}}
    if tags:
        op["tags"] = tags
    return op


_SAMPLER_SCHEMA = {
    "type": "object",
    "properties": {
        "type": {"type": "string", "enum": ["Nucleus", "Typical", "Mirostat"]},
        "top_p": {"type": "number", "default": 0.5},
        "top_k": {"type": "integer", "default": 128},
        "temperature": {"type": "number", "default": 1.0},
        "presence_penalty": {"type": "number", "default": 0.3},
        "frequency_penalty": {"type": "number", "default": 0.3},
        "penalty_decay": {"type": "number", "default": 0.99654026},
        "tau": {"type": "number"},
        "rate": {"type": "number"},
    },
}

_CHAT_BODY = {
    "type": "object",
    "properties": {
        "messages": {"type": "array", "items": {"type": "object",
                     "properties": {"role": {"type": "string"},
                                    "content": {"type": "string"}}}},
        "names": {"type": "object"},
        "template": {"type": "object", "properties": {
            "record": {"type": "string"}, "prefix": {"type": "string"},
            "sep": {"type": "string"}}},
        "state": {}, "max_tokens": {"type": "integer", "default": 256},
        "stop": {}, "stream": {"type": "boolean"},
        "bias": {"type": "object"}, "bnf_schema": {"type": "string"},
        "sampler": _SAMPLER_SCHEMA,
        "top_p": {"type": "number"}, "top_k": {"type": "integer"},
        "temperature": {"type": "number"},
    },
}

_COMPLETION_BODY = {
    "type": "object",
    "properties": {
        **{k: v for k, v in _CHAT_BODY["properties"].items()
           if k not in ("messages", "names", "template")},
        "prompt": {},
    },
}

_EMBEDDINGS_BODY = {
    "type": "object",
    "properties": {
        "input": {},
        "state": {},
        "pooling": {"type": "string", "enum": ["mean_hidden", "state"],
                    "description": "mean_hidden: C dims (default without "
                    "a state id); state: 3C dims (default with one). "
                    "Vectors from the two are not comparable."},
    },
}

_RETRIEVAL_ADD_BODY = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "vectors": {"type": "array", "items": {
            "type": "array", "items": {"type": "number"}}},
        "texts": {"type": "array", "items": {"type": "string"},
                  "description": "embedded server-side when no vectors"},
    },
}

OPENAPI_SPEC = {
    "openapi": "3.0.3",
    "info": {
        "title": "ai00_server_tpu_torch",
        "description": "OpenAI-compatible RWKV inference server "
                       "(PyTorch, hand-written CUDA kernels)",
        "version": "0.1.0",
    },
    "paths": {
        "/api/oai/chat/completions": {"post": _op(
            "Generate chat completions with context", _CHAT_BODY, ["oai"])},
        "/api/oai/completions": {"post": _op(
            "Generate text completions", _COMPLETION_BODY, ["oai"])},
        "/api/oai/chooses": {"post": _op(
            "Rank choices by perplexity", {
                "type": "object", "properties": {
                    "input": {}, "choices": {"type": "array",
                                             "items": {"type": "string"}},
                    "calibrate": {"type": "boolean"}, "state": {}}}, ["oai"])},
        "/api/oai/states": {"post": _op(
            "Extract the RWKV state for a text", {
                "type": "object",
                "properties": {"input": {}, "state": {}}}, ["oai"])},
        "/api/oai/embeddings": {"post": _op(
            "Model-derived sentence embeddings", _EMBEDDINGS_BODY,
            ["oai"])},
        "/api/oai/embeds": {"post": _op(
            "Sidecar text embeddings, chunked by token budget", {
                "type": "object", "properties": {
                    "input": {"type": "string"},
                    "max_tokens": {"type": "integer", "default": 510},
                    "prefix": {"type": "string", "default": "query:"}}},
            ["oai"])},
        "/api/retrieval/index": {"post": _op(
            "Create a vector index (optionally seeded + IVF-built)",
            _RETRIEVAL_ADD_BODY, ["retrieval"])},
        "/api/retrieval/add": {"post": _op(
            "Add vectors or texts to an index", _RETRIEVAL_ADD_BODY,
            ["retrieval"])},
        "/api/retrieval/search": {"post": _op(
            "Nearest-neighbor search (exact or IVF)", {
                "type": "object", "properties": {
                    "name": {"type": "string"},
                    "vectors": {"type": "array"},
                    "texts": {"type": "array"},
                    "k": {"type": "integer", "default": 10},
                    "nprobe": {"type": "integer"}}}, ["retrieval"])},
        "/api/retrieval/build": {"post": _op(
            "Build/rebuild the IVF structure for an index", {
                "type": "object", "properties": {
                    "name": {"type": "string"},
                    "nlist": {"type": "integer", "default": 64},
                    "iters": {"type": "integer", "default": 10}}},
            ["retrieval"])},
        "/api/retrieval/list": {"get": _op("List vector indexes",
                                           tags=["retrieval"])},
        "/api/retrieval/drop": {"post": _op(
            "Drop a vector index", {"type": "object", "properties": {
                "name": {"type": "string"}}}, ["retrieval"])},
        "/api/metrics": {"get": _op(
            "Prometheus text-format serving metrics", tags=["api"])},
        "/admin/profile/start": {"post": _op(
            "Start a torch.profiler trace (admin)", {
                "type": "object", "properties": {"dir": {"type": "string"}}},
            ["admin"])},
        "/admin/profile/stop": {"post": _op(
            "Stop the trace and write its Chrome JSON (admin)",
            tags=["admin"])},
        "/api/oai/models": {"get": _op("Current model id", tags=["oai"])},
        "/api/adapters": {"get": _op("List compute devices", tags=["api"])},
        "/api/models/info": {"get": _op("Runtime info", tags=["api"])},
        "/api/models/state": {"get": _op("SSE runtime info stream",
                                         tags=["api"])},
        "/api/models/list": {"get": _op("List model files", tags=["api"])},
        "/api/auth/exchange": {"post": _op(
            "Exchange app key for a JWT", {
                "type": "object", "properties": {
                    "app_id": {"type": "string"},
                    "app_secret": {"type": "string"}}}, ["api"])},
        "/admin/models/load": {"post": _op(
            "Load/reload a model (admin)", {
                "type": "object", "properties": {
                    "model_path": {"type": "string"},
                    "lora": {"type": "array"}, "state": {"type": "array"},
                    "quant": {"type": "integer"},
                    "quant_type": {"type": "string"},
                    "precision": {"type": "string"},
                    "token_chunk_size": {"type": "integer"},
                    "max_batch": {"type": "integer"},
                    "tokenizer_path": {"type": "string"}}}, ["admin"])},
        "/admin/models/unload": {"get": _op("Unload the model (admin)",
                                            tags=["admin"])},
        "/admin/models/save": {"post": _op(
            "Save a prefab (admin)", {"type": "object", "properties": {
                "path": {"type": "string"}}}, ["admin"])},
        "/admin/files/unzip": {"post": _op("Unzip an archive (admin)",
                                           tags=["admin"])},
        "/admin/files/dir": {"post": _op("List a directory (admin)",
                                         tags=["admin"])},
        "/admin/files/config/load": {"post": _op("Load a config (admin)",
                                                 tags=["admin"])},
        "/admin/files/config/save": {"post": _op("Save a config (admin)",
                                                 tags=["admin"])},
    },
}


def build_spec(app) -> dict:
    """The spec of the live route table: every registered route, with the
    hand-written detail of ``OPENAPI_SPEC["paths"]`` where it has some
    (``/api/oai/v1/*`` shares its alias's), else the handler docstring's
    first line as the summary."""
    detail = OPENAPI_SPEC["paths"]
    paths: dict = {}
    for route in app.router.routes():
        method = route.method.lower()
        if method == "head" or route.resource is None:
            continue
        path = route.resource.canonical
        op = detail.get(path, {}).get(method)
        if op is None:
            base = path
            # /api/oai/v1/* aliases share the unaliased detail.
            if "/api/oai/v1/" in path:
                base = path.replace("/api/oai/v1/", "/api/oai/")
            op = detail.get(base, {}).get(method)
        if op is None:
            doc = (getattr(route.handler, "__doc__", None) or "").strip()
            summary = doc.splitlines()[0].rstrip(".") if doc else path
            tags = (["admin"] if path.startswith("/admin")
                    else ["retrieval"] if path.startswith("/api/retrieval")
                    else ["oai"] if path.startswith("/api/oai")
                    else ["api"])
            op = _op(summary, tags=tags)
        paths.setdefault(path, {})[method] = op
    spec = {k: v for k, v in OPENAPI_SPEC.items() if k != "paths"}
    spec["paths"] = paths
    return spec


SWAGGER_HTML = """<!DOCTYPE html>
<html>
<head><title>ai00_server_tpu_torch API docs</title>
<meta charset="utf-8"/>
<link rel="stylesheet"
 href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css"/>
</head>
<body>
<div id="swagger-ui"></div>
<script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js">
</script>
<script>
window.onload = () => SwaggerUIBundle({
  url: "/api-docs/openapi.json", dom_id: "#swagger-ui"});
</script>
</body>
</html>
"""
