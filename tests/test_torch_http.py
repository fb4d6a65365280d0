"""HTTP flow of the port's server on the CPU (``device="cpu"``): the
``tests/test_http.py`` site flow — completions, the v1 alias, greedy
determinism, SSE ending in ``[DONE]``, chat, models and info — plus equal
greedy text from the JAX server on the same model, BNF-constrained
completions and chat, and the routes that once answered 501 (an admin save
and unload with a JWT, the API docs) served.  The admin, file and profile
routes are held in ``test_torch_admin.py``."""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.server.app import Server as JServer
from ai00_server_tpu.server.config import Config as JConfig
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch.grammar import GrammarEngine
from ai00_server_tpu_torch.server.app import Server
from ai00_server_tpu_torch.server.config import Config
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_loader import to_converted_layout
from test_torch_states_runtime import lasting

cpu_test_threads()

GREEDY = {"type": "Nucleus", "top_k": 1}


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    root = tmp_path_factory.mktemp("site")
    models = root / "assets" / "models"
    tok_dir = root / "assets" / "tokenizer"
    cfg_dir = root / "assets" / "configs"
    for d in (models, tok_dir, cfg_dir):
        d.mkdir(parents=True)
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=21, dtype=np.float32,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw),
                             str(models / "tiny.st"), dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (cfg_dir / "Config.toml").write_text(f"""
[model]
name = "tiny.st"
path = "{models}"
max_batch = 4
token_chunk_size = 16
precision = "Fp32"

[tokenizer]
path = "{tok_dir / 'vocab.json'}"

[listen]
port = 0
""")
    return root


async def make_client(site, server_cls=Server, config_cls=Config, **kw):
    config = config_cls.from_toml(str(site / "assets/configs/Config.toml"))
    server = server_cls(config, **kw)
    await server.middleware.reload(config.to_reload_request(sandbox=False))
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, server


async def _complete(client, path="/api/oai/completions", **body):
    r = await client.post(path, json={"prompt": "ABCAB", "max_tokens": 6,
                                      "sampler": GREEDY, **body})
    assert r.status == 200
    return await r.json()


def test_site_flow(site):
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            body = await _complete(client)
            assert body["object"] == "text_completion"
            assert body["choices"][0]["finish_reason"] in ("length", "stop")
            assert body["usage"]["prompt"] == 5
            text1 = body["choices"][0]["text"]
            text2 = (await _complete(client, "/api/oai/v1/completions")
                     )["choices"][0]["text"]
            assert text1 == text2

            # Concurrent identical greedy requests agree with each other.
            many = await asyncio.gather(*[_complete(client)
                                          for _ in range(3)])
            assert {m["choices"][0]["text"] for m in many} == {text1}

            r = await client.get("/api/oai/models")
            assert (await r.json())["data"][0]["id"] == "tiny"
            r = await client.get("/api/models/info")
            info = await r.json()
            assert info["state"] == "loaded"
            assert info["model"]["version"] == "V7"
            assert info["mesh"] is None  # one device
            r = await client.get("/api/adapters")
            assert "CPU (cpu)" in await r.json()
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_streaming_sse_and_chat(site):
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            r = await client.post("/api/oai/completions", json={
                "prompt": "ABC", "max_tokens": 4, "stream": True,
                "sampler": GREEDY})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = [l[6:] for l in (await r.read()).decode().splitlines()
                      if l.startswith("data: ")]
            assert events[-1] == "[DONE]"
            text = "".join(c.get("text", "") for e in events[:-1]
                           for c in json.loads(e)["choices"])
            assert text

            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "ABC"}],
                "max_tokens": 4, "stream": True, "sampler": GREEDY})
            events = [l[6:] for l in (await r.read()).decode().splitlines()
                      if l.startswith("data: ")]
            assert events[-1] == "[DONE]"
            first = json.loads(events[0])["choices"][0]["delta"]
            assert first == {"role": "Assistant"}
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_greedy_text_equals_jax_server(site):
    async def texts(server_cls, config_cls, **kw):
        client, server = await make_client(site, server_cls, config_cls,
                                           **kw)
        try:
            out = [(await _complete(client, prompt=p, max_tokens=8)
                    )["choices"][0]["text"] for p in ("ABCAB", "QRS")]
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "HELLO"}],
                "max_tokens": 8, "sampler": GREEDY})
            out.append((await r.json())["choices"][0]["message"]["content"])
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    port = asyncio.run(texts(Server, Config, device="cpu"))
    ref = asyncio.run(texts(JServer, JConfig))
    assert port == ref
    assert all(port)


def test_staggered_burst_all_complete(site):
    """More requests than slots, arriving while earlier ones are being
    admitted: every one completes, identical prompts agree, and a long
    prompt (several prefill chunks, prefix-cached) matches its twin."""
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            prompts = ["ABCAB", "QRS", "ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 3] * 3

            async def one(i, p):
                await asyncio.sleep(0.003 * i)
                return (await _complete(client, prompt=p, max_tokens=10)
                        )["choices"][0]["text"]

            texts = await asyncio.wait_for(asyncio.gather(
                *[one(i, p) for i, p in enumerate(prompts)]), timeout=120)
            for p in set(prompts):
                assert len({t for q, t in zip(prompts, texts) if q == p}) == 1
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_later_slices_answer_501(site):
    """Once 501s; now served: an admin save (a name lands in the model
    directory) and unload, with a JWT for the default app key."""
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            r = await client.post("/api/auth/exchange", json={
                "app_id": "admin", "app_secret": "ai00_is_good"})
            assert r.status == 200
            hdrs = {"Authorization": f"Bearer {(await r.json())['token']}"}
            r = await client.post("/admin/models/save", headers=hdrs,
                                  json={"path": "x.prefab"})
            assert r.status == 200, await r.text()
            path = (await r.json())["path"]
            assert path == str(site / "assets" / "models" / "x.prefab")
            assert os.path.getsize(path) > 0
            os.remove(path)
            r = await client.get("/admin/models/unload", headers=hdrs)
            assert r.status == 200
            assert server.middleware.env is None
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


@pytest.mark.parametrize("schema", ["start ::= 'HI' | 'BYE';",
                                    "start ::= 'A' start 'B' | 'HI';"],
                         ids=["regular", "non_regular"])
def test_bnf_over_http(site, schema):
    """``bnf_schema`` on completions and chat (``tests/test_http.py``'s
    case, streamed and not): 200, and text the grammar accepts whole when
    the grammar stopped it, else a live prefix."""
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            out = []
            r = await client.post("/api/oai/completions", json={
                "prompt": "ABC", "max_tokens": 8, "bnf_schema": schema})
            assert r.status == 200
            c = (await r.json())["choices"][0]
            out.append((c["text"], c["finish_reason"]))
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "ABC"}],
                "max_tokens": 8, "bnf_schema": schema})
            assert r.status == 200
            c = (await r.json())["choices"][0]
            out.append((c["message"]["content"], c["finish_reason"]))
            for path, key in (("/api/oai/completions", "text"),
                              ("/api/oai/v1/chat/completions", "content")):
                body = {"max_tokens": 8, "bnf_schema": schema,
                        "stream": True, "sampler": GREEDY}
                if key == "text":
                    body["prompt"] = "ABC"
                else:
                    body["messages"] = [{"role": "user", "content": "ABC"}]
                r = await client.post(path, json=body)
                assert r.status == 200
                events = [json.loads(l[6:]) for l in
                          (await r.read()).decode().splitlines()
                          if l.startswith("data: ") and l != "data: [DONE]"]
                text = "".join(
                    ch.get("text", "") or ch.get("delta", {}).get(key, "")
                    for e in events for ch in e["choices"])
                out.append((text, events[-1]["choices"][0]["finish_reason"]))
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    for text, reason in asyncio.run(main()):
        g = GrammarEngine(schema)
        assert text and g.advance(text.encode()), text
        if reason == "stop":
            assert g.can_finish(), text
        else:
            assert reason == "length", reason


# ---------------------------------------------------------------------------
# Int8 models over HTTP: quant = N, quant_type = "Int8" in the model config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quant_site(tmp_path_factory):
    """A 2-layer v7 of width 128 (int8 blocks are 128 rows), head size 64."""
    root = tmp_path_factory.mktemp("qsite")
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=22, dtype=np.float32,
                                num_layer=2, num_emb=128, head_size=64,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw), str(root / "tiny.st"),
                             dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (root / "vocab.json").write_text(json.dumps(vocab))
    return root


def quant_config(root, quant, quant_type="Int8"):
    return Config.from_dict({
        "model": {"name": "tiny.st", "path": str(root), "max_batch": 4,
                  "token_chunk_size": 16, "precision": "Fp32",
                  "quant": quant, "quant_type": quant_type},
        "tokenizer": {"path": str(root / "vocab.json")},
        "listen": {"port": 0}})


@pytest.mark.parametrize("quant", [2, 1])
def test_int8_completion(quant_site, quant):
    """``quant = L``: every layer int8, the fused decode path; ``0 < quant <
    L``: the layer-by-layer path with ``matmul_int8_l`` and ``ffn7_t1_l``."""
    from ai00_server_tpu_torch.ops import quant as tquant
    from ai00_server_tpu_torch.ops import v7_decode as fd

    async def main():
        config = quant_config(quant_site, quant)
        server = Server(config, device="cpu")
        await server.middleware.reload(config.to_reload_request())
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            params = server.middleware.env.model.params
            kinds = [tquant.is_quantized(p["ffn"]["key"])
                     for p in params["layers"]]
            assert kinds == [i < quant for i in range(2)]
            assert fd.supports(params) == (quant == 2)
            assert "_head_q" in params
            texts = [(await _complete(client, max_tokens=8)
                      )["choices"][0]["text"] for _ in range(2)]
            assert texts[0] and texts[0] == texts[1]
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "HELLO"}],
                "max_tokens": 4, "sampler": GREEDY})
            assert r.status == 200
            assert (await r.json())["choices"][0]["message"]["content"]
            info = await (await client.get("/api/models/info")).json()
            assert info["reload"]["quant"] == quant
            assert info["reload"]["quant_type"] == "Int8"
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


@pytest.mark.parametrize("quant_type", ["NF4", "SF4", "Int4"])
def test_4bit_quant_type_names_its_roadmap_item(quant_site, quant_type):
    """The server loads and answers with a 4-bit ``quant_type`` (it used to
    name a ROADMAP item): layer 0 holds packed codes of that mode, the LM
    head is int8, the layer path decodes."""
    from ai00_server_tpu_torch.ops import quant as tquant
    from ai00_server_tpu_torch.ops import v7_decode as fd

    async def main():
        config = quant_config(quant_site, 1, quant_type)
        server = Server(config, device="cpu")
        await server.middleware.reload(config.to_reload_request())
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            params = server.middleware.env.model.params
            key = params["layers"][0]["ffn"]["key"]
            assert tquant.is_quantized(key)
            assert key.mode == quant_type.lower()
            assert key.q.dtype == torch.uint8
            assert not tquant.is_quantized(params["layers"][1]["ffn"]["key"])
            assert params["_head_q"].mode == "int8"
            assert not fd.supports(params)
            texts = [(await _complete(client, max_tokens=6)
                      )["choices"][0]["text"] for _ in range(2)]
            assert texts[0] and texts[0] == texts[1]
            info = await (await client.get("/api/models/info")).json()
            assert info["reload"]["quant_type"] == quant_type
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_nf4_completion_on_the_fused_path(quant_site):
    """``quant = L, quant_type = "NF4"``: every layer 4-bit, the fused decode
    path on packed codes; identical greedy requests give identical text."""
    from ai00_server_tpu_torch.ops import quant as tquant
    from ai00_server_tpu_torch.ops import v7_decode as fd

    async def main():
        config = quant_config(quant_site, 2, "NF4")
        server = Server(config, device="cpu")
        await server.middleware.reload(config.to_reload_request())
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            params = server.middleware.env.model.params
            assert all(p["att"]["output"].mode == "nf4"
                       for p in params["layers"])
            assert fd.supports(params) and "Wo_q" in params[fd.FUSED_KEY]
            assert params[fd.FUSED_KEY]["Wo_q"][0].dtype == torch.uint8
            texts = [(await _complete(client, max_tokens=8)
                      )["choices"][0]["text"] for _ in range(2)]
            assert texts[0] and texts[0] == texts[1]
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "HELLO"}],
                "max_tokens": 4, "sampler": GREEDY})
            assert r.status == 200
            assert (await r.json())["choices"][0]["message"]["content"]
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_unknown_quant_type_is_refused(quant_site):
    """An unknown ``quant_type`` raises instead of loading unquantized."""
    async def main():
        config = quant_config(quant_site, 1, "Fp4")
        server = Server(config, device="cpu")
        with pytest.raises(ValueError, match="Int8, NF4, SF4, Int4"):
            await server.middleware.reload(config.to_reload_request())
        assert server.middleware.env is None
        # quant = 0 asks for no quantization: the type is not looked at.
        assert quant_config(quant_site, 0, "Fp4").to_reload_request() \
            .quant_map() is None

    asyncio.run(main())


# ---------------------------------------------------------------------------
# RWKV-6 over HTTP: the same routes on a v6 checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v6_site(tmp_path_factory):
    """A 2-layer v6 of width 128 with head size 64 (the fused v6 path)."""
    root = tmp_path_factory.mktemp("v6site")
    _, raw, _ = make_tiny_model(ModelVersion.V6, seed=23, dtype=np.float32,
                                num_layer=2, num_emb=128, head_size=64,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw), str(root / "tiny.st"),
                             dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (root / "vocab.json").write_text(json.dumps(vocab))
    return root


async def _v6_client(root, quant=0, quant_type="Int8", server_cls=Server,
                     config_cls=Config, **kw):
    config = config_cls.from_dict({
        "model": {"name": "tiny.st", "path": str(root), "max_batch": 4,
                  "token_chunk_size": 16, "precision": "Fp32",
                  "quant": quant, "quant_type": quant_type},
        "tokenizer": {"path": str(root / "vocab.json")},
        "listen": {"port": 0}})
    server = server_cls(config, **kw)
    await server.middleware.reload(config.to_reload_request())
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, server


def test_v6_completion_and_sse_chat(v6_site):
    from ai00_server_tpu_torch.ops import v6_decode as fd6

    async def main():
        client, server = await _v6_client(v6_site, device="cpu")
        try:
            assert fd6.supports(server.middleware.env.model.params)
            body = await _complete(client, max_tokens=8)
            text = body["choices"][0]["text"]
            assert text and body["usage"]["prompt"] == 5
            assert (await _complete(client, "/api/oai/v1/completions",
                                    max_tokens=8))["choices"][0]["text"] \
                == text
            r = await client.post("/api/oai/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "ABC"}],
                "max_tokens": 4, "stream": True, "sampler": GREEDY})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = [l[6:] for l in (await r.read()).decode().splitlines()
                      if l.startswith("data: ")]
            assert events[-1] == "[DONE]"
            assert json.loads(events[0])["choices"][0]["delta"] == {
                "role": "Assistant"}
            assert "".join(json.loads(e)["choices"][0].get(
                "delta", {}).get("content", "") for e in events[1:-1])
            info = await (await client.get("/api/models/info")).json()
            assert info["model"]["version"] == "V6"
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_v6_greedy_text_equals_jax_server(v6_site):
    async def texts(server_cls, config_cls, **kw):
        client, server = await _v6_client(
            v6_site, server_cls=server_cls, config_cls=config_cls, **kw)
        try:
            out = [(await _complete(client, prompt=p, max_tokens=8)
                    )["choices"][0]["text"] for p in ("ABCAB", "QRS")]
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "HELLO"}],
                "max_tokens": 8, "sampler": GREEDY})
            out.append((await r.json())["choices"][0]["message"]["content"])
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    port = asyncio.run(texts(Server, Config, device="cpu"))
    ref = asyncio.run(texts(JServer, JConfig))
    assert port == ref
    assert all(port)


@pytest.mark.parametrize("quant,quant_type", [(2, "Int8"), (2, "NF4"),
                                              (1, "Int8")])
def test_v6_quantized_completion(v6_site, quant, quant_type):
    """``quant = L``: every layer's eight big projections as codes, the
    fused v6 path; ``quant = 1``: the layer path."""
    from ai00_server_tpu_torch.ops import quant as tquant
    from ai00_server_tpu_torch.ops import v6_decode as fd6

    async def main():
        client, server = await _v6_client(v6_site, quant, quant_type,
                                          device="cpu")
        try:
            params = server.middleware.env.model.params
            kinds = [tquant.is_quantized(p["att"]["gate"])
                     and tquant.is_quantized(p["ffn"]["receptance"])
                     for p in params["layers"]]
            assert kinds == [i < quant for i in range(2)]
            assert params["layers"][0]["att"]["gate"].mode == \
                quant_type.lower()
            assert fd6.supports(params) == (quant == 2)
            assert "_head_q" in params
            texts = [(await _complete(client, max_tokens=8)
                      )["choices"][0]["text"] for _ in range(2)]
            assert texts[0] and texts[0] == texts[1]
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_v5_checkpoint_names_its_roadmap_item(tmp_path):
    """A v5 checkpoint, once refused by name, now loads and answers (at
    head size 16: the layer path)."""
    _, raw, _ = make_tiny_model(ModelVersion.V5, seed=24, dtype=np.float32)
    jloader.save_safetensors(to_converted_layout(raw),
                             str(tmp_path / "tiny.st"), dtype=np.float32)
    (tmp_path / "vocab.json").write_text(json.dumps(
        {str(i): chr(64 + i) for i in range(1, 60)}))

    async def main():
        client, server = await _v6_client(tmp_path, device="cpu")
        try:
            assert server.middleware.env.engine.info.version.value == "V5"
            body = await _complete(client, max_tokens=4)
            assert body["choices"][0]["text"]
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


@pytest.mark.parametrize("path", ["/api-docs", "/api-docs/"])
def test_api_docs_answer_501(site, path):
    """Once 501s; now both forms serve the Swagger page, as the JAX server
    routes both (its server/app.py:232-233)."""
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            r = await client.get(path)
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/html")
            text = await r.text()
            assert "swagger" in text.lower()
            assert "/api-docs/openapi.json" in text
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# RWKV-5 and RWKV-4 over HTTP: the same routes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["V5", "V4"])
def v54_site(request, tmp_path_factory):
    """A 2-layer v5 (head size 64: the fused v5 path) or v4 (the fused v4
    path) of width 128."""
    root = tmp_path_factory.mktemp(request.param)
    _, raw, _ = make_tiny_model(ModelVersion(request.param), seed=25,
                                dtype=np.float32, num_layer=2, num_emb=128,
                                head_size=64, num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw), str(root / "tiny.st"),
                             dtype=np.float32)
    (root / "vocab.json").write_text(json.dumps(
        {str(i): chr(64 + i) for i in range(1, 60)}))
    return request.param, root


def test_v5_v4_completion_and_sse_chat(v54_site):
    from ai00_server_tpu_torch.ops import fused_decode

    version, root = v54_site

    async def main():
        client, server = await _v6_client(root, device="cpu")
        try:
            fd = fused_decode.module_for(version)
            assert fd.supports(server.middleware.env.model.params)
            body = await _complete(client, max_tokens=8)
            text = body["choices"][0]["text"]
            assert text and body["usage"]["prompt"] == 5
            assert (await _complete(client, "/api/oai/v1/completions",
                                    max_tokens=8))["choices"][0]["text"] \
                == text
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "ABC"}],
                "max_tokens": 4, "stream": True, "sampler": GREEDY})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = [l[6:] for l in (await r.read()).decode().splitlines()
                      if l.startswith("data: ")]
            assert events[-1] == "[DONE]"
            assert "".join(json.loads(e)["choices"][0].get(
                "delta", {}).get("content", "") for e in events[1:-1])
            info = await (await client.get("/api/models/info")).json()
            assert info["model"]["version"] == version
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


def test_v5_v4_greedy_text_equals_jax_server(v54_site):
    _, root = v54_site

    async def texts(server_cls, config_cls, **kw):
        client, server = await _v6_client(
            root, server_cls=server_cls, config_cls=config_cls, **kw)
        try:
            out = [(await _complete(client, prompt=p, max_tokens=8)
                    )["choices"][0]["text"] for p in ("ABCAB", "QRS")]
            r = await client.post("/api/oai/chat/completions", json={
                "messages": [{"role": "user", "content": "HELLO"}],
                "max_tokens": 8, "sampler": GREEDY})
            out.append((await r.json())["choices"][0]["message"]["content"])
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    port = asyncio.run(texts(Server, Config, device="cpu"))
    ref = asyncio.run(texts(JServer, JConfig))
    assert port == ref
    assert all(port)


@pytest.mark.parametrize("quant,quant_type", [(2, "Int8"), (1, "NF4")])
def test_v5_v4_quantized_completion(v54_site, quant, quant_type):
    """``quant = L``: the fused path on codes; ``quant = 1``: the layer
    path."""
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import quant as tquant

    version, root = v54_site

    async def main():
        client, server = await _v6_client(root, quant, quant_type,
                                          device="cpu")
        try:
            params = server.middleware.env.model.params
            kinds = [tquant.is_quantized(p["att"]["receptance"])
                     and tquant.is_quantized(p["ffn"]["value"])
                     for p in params["layers"]]
            assert kinds == [i < quant for i in range(2)]
            fd = fused_decode.module_for(version)
            assert fd.supports(params) == (quant == 2)
            assert "_head_q" in params
            texts = [(await _complete(client, max_tokens=8)
                      )["choices"][0]["text"] for _ in range(2)]
            assert texts[0] and texts[0] == texts[1]
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# Initial states over HTTP: /states and the ``state`` field
# ---------------------------------------------------------------------------

SID = "fd7a60ed-7807-449f-8256-bccae3246222"
NIL = "00000000-0000-0000-0000-000000000000"
STATE_PROMPT = "ABCABCABCABCABCABCABCABCABCABCABCABCAB"  # 38 tokens


@pytest.fixture(scope="module")
def state_site(tmp_path_factory):
    """A tiny f32 v7, a state-tuning ``tuned.state`` beside it, the
    vocabulary, and two configs registering the file under ``SID``: as a
    plain entry (``Config.toml``) and as the default (``Default.toml``)."""
    from ai00_server_tpu.testing import make_raw_weights, tiny_info

    root = tmp_path_factory.mktemp("statesite")
    models = root / "models"
    models.mkdir()
    info = tiny_info(ModelVersion.V7, num_vocab=64)
    # An initial state outlasts the 38-token prompt under these weights.
    raw = lasting(make_raw_weights(info, seed=45, dtype=np.float32))
    jloader.save_safetensors(to_converted_layout(raw),
                             str(models / "tiny.st"), dtype=np.float32)
    H, N = info.num_head, info.head_size
    ts = np.random.default_rng(7).standard_normal(
        (info.num_layer, H, N, N)).astype(np.float32) * 0.3
    jloader.save_safetensors(
        {f"blocks.{i}.att.time_state": np.swapaxes(ts[i], -1, -2)
         for i in range(info.num_layer)}, str(models / "tuned.state"),
        dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (root / "vocab.json").write_text(json.dumps(vocab))
    for name, default in (("Config.toml", "false"),
                          ("Default.toml", "true")):
        (root / name).write_text(f"""
[model]
name = "tiny.st"
path = "{models}"
max_batch = 2
token_chunk_size = 8
precision = "Fp32"

[[state]]
path = "{models / 'tuned.state'}"
name = "tuned"
id = "{SID}"
default = {default}

[tokenizer]
path = "{root / 'vocab.json'}"
""")
    return root


def on_state_site(root, script, jax_side=False, toml="Config.toml"):
    async def main():
        config_cls, server_cls = (JConfig, JServer) if jax_side else (
            Config, Server)
        config = config_cls.from_toml(str(root / toml))
        server = (server_cls(config) if jax_side
                  else server_cls(config, device="cpu"))
        await server.middleware.reload(
            config.to_reload_request(sandbox=False))
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            return await script(client, server)
        finally:
            await client.close()
            await server.middleware.unload()

    return asyncio.run(main())


async def _text(client, state=None, prompt=STATE_PROMPT, status=200):
    body = {"prompt": prompt, "max_tokens": 6, "sampler": GREEDY}
    if state is not None:
        body["state"] = state
    r = await client.post("/api/oai/completions", json=body)
    assert r.status == status, await r.text()
    if status != 200:
        return await r.text()
    return (await r.json())["choices"][0]["text"]


@pytest.mark.parametrize("path", ["/api/oai/states", "/api/oai/v1/states"])
def test_states_route_equals_jax(state_site, path):
    """/states returns the packed state after the input from the named
    initial state: its shape, and data equal to the JAX server's (2e-4 of
    scale); the info lists the registered state."""
    async def script(client, server):
        r = await client.get("/api/models/info")
        listed = (await r.json())["states"]
        out = []
        for state in (SID, None):
            body = {"input": "ABCAB"}
            if state:
                body["state"] = state
            r = await client.post(path, json=body)
            assert r.status == 200, await r.text()
            d = (await r.json())["data"][0]
            out.append((d["shape"], np.asarray(d["data"], np.float64)))
        return listed, out

    listed, port = on_state_site(state_site, script)
    jlisted, ref = on_state_site(state_site, script, jax_side=True)
    assert listed == jlisted == [{"name": "tuned", "id": SID,
                                  "default": False}]
    for (shape, data), (jshape, jdata) in zip(port, ref):
        assert shape == jshape == [3, 18, 32, 1]
        scale = float(np.abs(jdata).max())
        assert float(np.abs(data - jdata).max()) <= 2e-4 * scale
    assert not np.allclose(port[0][1], port[1][1])


@pytest.mark.parametrize("route", ["completions", "chat", "chooses",
                                   "embeddings"])
def test_state_field_equals_jax(state_site, route):
    """The ``state`` field (a registered id) on each route gives the JAX
    server's answer, and another answer than the model's own state."""
    async def script(client, server):
        out = []
        for state in (SID, None):
            extra = {"state": state} if state else {}
            if route == "completions":
                out.append(await _text(client, state))
                continue
            if route == "chat":
                r = await client.post("/api/oai/chat/completions", json={
                    "messages": [{"role": "user", "content": STATE_PROMPT}],
                    "max_tokens": 6, "sampler": GREEDY, **extra})
                out.append((await r.json())["choices"][0]["message"][
                    "content"])
                continue
            if route == "chooses":
                r = await client.post("/api/oai/chooses", json={
                    "input": STATE_PROMPT, "choices": ["AB", "CAB", "Q"],
                    **extra})
                out.append({d["choice"]: d["perplexity"]
                            for d in (await r.json())["data"]})
                continue
            r = await client.post("/api/oai/embeddings", json={
                "input": [STATE_PROMPT, "QRS"], **extra})
            body = await r.json()
            out.append((body["pooling"],
                        [d["embedding"] for d in body["data"]]))
        return out

    port = on_state_site(state_site, script)
    ref = on_state_site(state_site, script, jax_side=True)
    if route in ("completions", "chat"):
        assert port == ref and port[0] != port[1] and all(port)
    elif route == "chooses":
        for got, want in zip(port, ref):
            for k in want:
                assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k])
        assert port[0] != port[1]
    else:
        assert [p for p, _ in port] == [p for p, _ in ref] == [
            "state", "mean_hidden"]
        for (_, got), (_, want) in zip(port, ref):
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_state_forms_agree(state_site):
    """A key, a value ``{data, shape}`` with and without an id, and a file
    ``{path}`` under the model directory give the same tokens; a value
    without an id registers nothing (the JAX server registers it under a
    fresh uuid4 on every request)."""
    async def script(client, server):
        r = await client.post("/api/oai/states", json={"input": ""})
        body = (await r.json())["data"][0]
        rt = server.middleware.env.runtime
        keyed = await _text(client, SID)
        value = {"data": body["data"], "shape": body["shape"]}
        states, caches = dict(rt.states), set(rt.caches)
        anonymous = [await _text(client, value) for _ in range(2)]
        assert rt.states == states and set(rt.caches) == caches
        named = await _text(client, {"id": "11111111-2222-3333-4444-"
                                           "555555555555", **value})
        by_path = await _text(client, {"id": "22222222-2222-3333-4444-"
                                             "555555555555",
                                       "path": "tuned.state"})
        return keyed, anonymous, named, by_path

    keyed, anonymous, named, by_path = on_state_site(state_site, script)
    # The empty input's state is the initial state (an empty prompt feeds
    # the end-of-text token, whose step leaves shifts in the packed state:
    # the tokens after it may differ from the key's); the file is the key.
    assert anonymous == [named] * 2
    assert by_path == keyed


def test_nil_uuid_means_the_models_own_state(state_site):
    """Divergence: with a default state configured, the JAX server maps
    the nil UUID string to that default while ``{"id": nil}`` reaches the
    model's own state.  The port gives both forms the documented meaning,
    the model's own initial state (the answer of a config without the
    default), and a request without a state gets the default."""
    async def script(client, server):
        return [await _text(client, s) for s in (None, NIL, {"id": NIL},
                                                 SID)]

    default, nil, nil_obj, keyed = on_state_site(state_site, script,
                                                 toml="Default.toml")

    async def plain(client, server):
        return await _text(client)

    own = on_state_site(state_site, plain)
    assert default == keyed != own
    assert nil == nil_obj == own


def test_state_refusals(state_site):
    """A file outside the model directory answers 403, an unknown id and a
    value of the wrong shape 400."""
    async def script(client, server):
        out = [await _text(client, {"path": str(state_site / "vocab.json")},
                           status=403)]
        out.append(await _text(client, "no-such-id", status=400))
        out.append(await _text(client, {"data": [0.0] * 7, "shape":
                                        [3, 18, 32, 1]}, status=400))
        return out

    forbidden, unknown, shape = on_state_site(state_site, script)
    assert "not in permitted dirs" in forbidden
    assert "unknown state id 'no-such-id'" in unknown
    assert "holds 7 numbers" in shape


def test_default_state_and_embeddings_equal_jax(state_site):
    """With a default state configured: a completion without a state
    starts from it, and a mean-hidden embedding that names no state from
    the model's own state (as the JAX runtime's), equal to the JAX
    server's answers."""
    async def script(client, server):
        text = await _text(client)
        r = await client.post("/api/oai/embeddings", json={
            "input": [STATE_PROMPT]})
        body = await r.json()
        return text, body["pooling"], body["data"][0]["embedding"]

    port = on_state_site(state_site, script, toml="Default.toml")
    ref = on_state_site(state_site, script, jax_side=True,
                        toml="Default.toml")
    plain = on_state_site(state_site, script)
    assert port[:2] == ref[:2] and port[1] == "mean_hidden"
    np.testing.assert_allclose(port[2], ref[2], atol=2e-4, rtol=0)
    np.testing.assert_allclose(port[2], plain[2], atol=2e-4, rtol=0)
    assert port[0] != plain[0]
