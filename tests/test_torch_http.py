"""HTTP flow of the port's server on the CPU (``device="cpu"``): the
``tests/test_http.py`` site flow — completions, the v1 alias, greedy
determinism, SSE ending in ``[DONE]``, chat, models and info — plus equal
greedy text from the JAX server on the same model, BNF-constrained
completions and chat, and 501 answers for what later slices bring."""

import asyncio
import json

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

from test_loader import to_converted_layout

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
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            r = await client.post("/api/oai/states", json={"input": "A"})
            assert r.status == 501
            assert "ROADMAP" in (await r.json())["error"]
            r = await client.get("/admin/models/unload")
            assert r.status == 501
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
    """The reference routes both forms (its server/app.py:232-233)."""
    async def main():
        client, server = await make_client(site, device="cpu")
        try:
            r = await client.get(path)
            assert r.status == 501
            assert "admin, profile and file routes" in (
                await r.json())["error"]
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
