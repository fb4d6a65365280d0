"""Embeddings, /chooses, retrieval and retrieval-augmented chat over HTTP on
the CPU (``device="cpu"``): the port's server against the JAX server on
the same tiny f32 RWKV-7 checkpoint.

Embedding vectors agree to 2e-4 (unit vectors; f32 sums in another order,
the engines' tolerance), perplexities to 2e-4 of their scale with the same
ranking, retrieval hits and RAG chat text (greedy) are equal.  What later
slices bring still answers 501 naming its ROADMAP item.
"""

import asyncio
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.server.app import Server as JServer
from ai00_server_tpu.server.config import Config as JConfig
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch.ops import retrieval as TR
from ai00_server_tpu_torch.server.app import Server
from ai00_server_tpu_torch.server.config import Config

from test_loader import to_converted_layout

TOL = 2e-4
GREEDY = {"type": "Nucleus", "top_k": 1}
DOCS = ["ABBA", "BAAB", "CAB", "DAD", "EDGE", "FACADE", "BEAD", "CEDE"]


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    root = tmp_path_factory.mktemp("ragsite")
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=40, dtype=np.float32,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw), str(root / "tiny.st"),
                             dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (root / "vocab.json").write_text(json.dumps(vocab))
    return root


def config_dict(root):
    return {"model": {"name": "tiny.st", "path": str(root), "max_batch": 4,
                      "token_chunk_size": 8, "precision": "Fp32"},
            "tokenizer": {"path": str(root / "vocab.json")}}


async def started(root, jax_side: bool):
    if jax_side:
        config = JConfig.from_dict(config_dict(root))
        server = JServer(config)
    else:
        config = Config.from_dict(config_dict(root))
        server = Server(config, device="cpu")
    await server.middleware.reload(config.to_reload_request(sandbox=False))
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, server


def on_both(root, script, sides=(True, False)):
    """Run ``script(client)`` against the JAX server, then the port's."""
    async def one(jax_side):
        client, server = await started(root, jax_side)
        try:
            return await script(client)
        finally:
            await client.close()
            await server.middleware.unload()

    return [asyncio.run(one(side)) for side in sides]


def on_port(root, script):
    return on_both(root, script, sides=(False,))[0]


async def post(client, path, status=200, **body):
    r = await client.post(path, json=body)
    assert r.status == status, await r.text()
    return await r.json()


@pytest.mark.parametrize("pooling", [None, "mean_hidden", "state"])
def test_embeddings_equal_jax_server(site, pooling):
    async def script(client):
        body = {"input": ["ABBA", "CAB", "FACADE"]}
        if pooling:
            body["pooling"] = pooling
        out = await post(client, "/api/oai/embeddings", **body)
        again = await post(client, "/api/oai/v1/embeddings",
                           input="CAB", **({"pooling": pooling}
                                           if pooling else {}))
        return out, again

    (j, j1), (t, t1) = on_both(site, script)
    assert t["pooling"] == j["pooling"] == (pooling or "mean_hidden")
    assert t["dimensions"] == j["dimensions"] == (
        32 if pooling != "state" else 3 * 32)
    for a, b in zip(t["data"], j["data"]):
        assert a["index"] == b["index"]
        np.testing.assert_allclose(a["embedding"], b["embedding"], atol=TOL)
    # A text embeds the same alone and beside others (slots batch).
    np.testing.assert_allclose(t1["data"][0]["embedding"],
                               t["data"][1]["embedding"], atol=1e-5)


def test_embeddings_refuse_bad_pooling(site):
    async def script(client):
        return await post(client, "/api/oai/embeddings", 400, input="A",
                          pooling="cls")

    j, t = on_both(site, script)
    assert "pooling" in t["error"] and "pooling" in j["error"]


@pytest.mark.parametrize("calibrate", [False, True])
def test_chooses_equal_jax_server(site, calibrate):
    choices = ["ABC", "XYZ", "QQ", "B"]

    async def script(client):
        out = await post(client, "/api/oai/chooses", input="ABCAB",
                         choices=choices, calibrate=calibrate)
        await post(client, "/api/oai/v1/chooses", input="ABCAB",
                   choices=choices, calibrate=calibrate)
        return out

    j, t = on_both(site, script)
    assert [d["choice"] for d in t["data"]] == [d["choice"]
                                                for d in j["data"]]
    assert [d["rank"] for d in t["data"]] == list(range(len(choices)))
    tp = np.array([d["perplexity"] for d in t["data"]])
    jp = np.array([d["perplexity"] for d in j["data"]])
    np.testing.assert_allclose(tp, jp, atol=TOL * np.abs(jp).max())


def test_embeds_without_sidecar_answers_400(site):
    async def script(client):
        return await post(client, "/api/oai/embeds", 400, input="hello")

    j, t = on_both(site, script)
    assert t == j == {"error": "no [embed] model configured"}


def test_retrieval_routes_equal_jax_server(site):
    """tests/test_retrieval.py's flow on both servers: an index from texts,
    an add, searches (exact; IVF built on the index, probed in full), list
    and drop."""
    async def script(client):
        out = {}
        out["index"] = await post(client, "/api/retrieval/index", name="kb",
                                  texts=DOCS[:3])
        out["add"] = await post(client, "/api/retrieval/add", name="kb",
                                texts=DOCS[3:])
        out["search"] = await post(client, "/api/retrieval/search",
                                   name="kb", query=["ABBA", "EDGE"],
                                   top_k=3)
        out["build"] = await post(client, "/api/retrieval/build", name="kb",
                                  nlist=4)
        r = await client.get("/api/retrieval/list")
        out["list"] = await r.json()
        out["ivf"] = await post(client, "/api/retrieval/search", name="kb",
                                queries="CEDE", top_k=4, nprobe=4)
        out["drop"] = await post(client, "/api/retrieval/drop", name="kb")
        r = await client.get("/api/retrieval/list")
        out["after"] = await r.json()
        return out

    j, t = on_both(site, script)
    for key in ("index", "add", "build", "list", "drop", "after"):
        assert t[key] == j[key], key
    assert t["index"]["size"] == 3 and t["add"]["size"] == len(DOCS)
    assert t["list"] == [{"name": "kb", "dim": 32, "size": len(DOCS),
                          "ivf": True}]
    for key in ("search", "ivf"):
        for a, b in zip(t[key]["data"], j[key]["data"]):
            assert [h["text"] for h in a["hits"]] == [h["text"]
                                                      for h in b["hits"]]
            np.testing.assert_allclose([h["score"] for h in a["hits"]],
                                       [h["score"] for h in b["hits"]],
                                       atol=TOL)
    assert t["search"]["data"][0]["hits"][0]["text"] == "ABBA"
    assert t["search"]["data"][1]["hits"][0]["text"] == "EDGE"
    assert t["ivf"]["data"][0]["hits"][0]["text"] == "CEDE"


def test_retrieval_from_vectors_builds_an_ivf_index(site):
    """Vector routes: a bf16 IVF from ``nlist``, searched on the CPU
    through the kernel's plain version.  A full probe ranks as the f32
    query against the bf16 vectors does (the exact route rounds the query
    to bf16 as well, so its order may differ on close scores)."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((64, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=-1, keepdims=True)

    async def script(client):
        made = await post(client, "/api/retrieval/index", name="v",
                          vectors=vecs.tolist(), nlist=8)
        exact = await post(client, "/api/retrieval/search", name="v",
                           vectors=vecs[:4].tolist(), top_k=3, exact=True)
        ivf = await post(client, "/api/retrieval/search", name="v",
                         vectors=vecs[:4].tolist(), top_k=3, nprobe=8)
        return made, exact, ivf

    before = TR.ivf_score.launches
    made, exact, ivf = on_port(site, script)
    assert TR.ivf_score.launches == before  # CPU: the plain version
    assert made == {"name": "v", "size": 64, "dim": 16}
    bf = vecs.astype(jnp.bfloat16).astype(np.float32)
    want = np.argsort(-(vecs[:4] @ bf.T), axis=1)[:, :3]
    assert [[h["id"] for h in d["hits"]] for d in ivf["data"]] == \
        want.tolist()
    assert [d["hits"][0]["id"] for d in exact["data"]] == [0, 1, 2, 3]


def test_retrieval_refuses_bad_requests(site):
    async def script(client):
        a = await post(client, "/api/retrieval/search", 400,
                       name="missing", vectors=[[0.0, 1.0]])
        b = await post(client, "/api/retrieval/index", 400, texts=["A"])
        return a, b

    (ja, jb), (ta, tb) = on_both(site, script)
    assert "missing" in ta["error"] and "missing" in ja["error"]
    assert "name" in tb["error"] and "name" in jb["error"]


def test_rag_chat_equal_jax_server(site):
    async def script(client):
        await post(client, "/api/retrieval/index", name="kb", texts=DOCS)
        out = await post(client, "/api/oai/chat/completions",
                         messages=[{"role": "user", "content": "ABBA"}],
                         retrieval={"index": "kb", "top_k": 2},
                         max_tokens=6, sampler=GREEDY)
        plain = await post(client, "/api/oai/chat/completions",
                           messages=[{"role": "user", "content": "ABBA"}],
                           max_tokens=6, sampler=GREEDY)
        return out, plain

    (j, jp), (t, tp) = on_both(site, script)
    text = t["choices"][0]["message"]["content"]
    assert text == j["choices"][0]["message"]["content"]
    # The retrieved documents went into the prompt.
    assert t["usage"]["prompt"] == j["usage"]["prompt"] > tp["usage"][
        "prompt"]
    assert tp["choices"][0]["message"]["content"] == jp["choices"][0][
        "message"]["content"]


STILL_501 = {
    "states": ("/api/oai/states", {"input": "A"}),
    "v1-states": ("/api/oai/v1/states", {"input": "A"}),
    "embeddings-state": ("/api/oai/embeddings",
                         {"input": "A", "state": "x", "pooling": "state"}),
    "chooses-state": ("/api/oai/chooses",
                      {"input": "A", "choices": ["B"], "state": "x"}),
    "chat-state": ("/api/oai/chat/completions",
                   {"messages": [{"role": "user", "content": "A"}],
                    "state": "x"}),
}


@pytest.mark.parametrize("case", sorted(STILL_501))
def test_states_and_custom_states_answer_501(site, case):
    path, body = STILL_501[case]

    async def script(client):
        return await post(client, path, 501, **body)

    out = on_port(site, script)
    assert ".state files, LoRA and prefab" in out["error"]


def test_embed_sidecar_copy_equals_jax():
    """The port's own copy of the sidecar's zoo resolves every name as the
    JAX package's, and its config reads the [embed] section."""
    from ai00_server_tpu.server import embed as jembed
    from ai00_server_tpu_torch.server import embed as tembed

    assert tembed.ZOO == jembed.ZOO and len(tembed.ZOO) == 28
    for name in (*jembed.ZOO, "org/custom-model", "assets/models/hf/x"):
        assert tembed.resolve_zoo(name) == jembed.resolve_zoo(name)
    cfg = Config.from_dict({"embed": {"model": "BGESmallENV15"}})
    assert cfg.embed == JConfig.from_dict(
        {"embed": {"model": "BGESmallENV15"}}).embed
    assert Config.from_dict({}).embed is None


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """A tiny random local HF-format encoder for the [embed] sidecar (no
    download: built from a BertConfig)."""
    from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("tiny_bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        list("abcdefghijklmnopqrstuvwxyz") + ["##a", "##b", "hello", "world"]
    (d / "vocab.txt").write_text("\n".join(vocab))
    torch.manual_seed(3)
    BertModel(BertConfig(vocab_size=len(vocab), hidden_size=16,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, max_position_embeddings=64)
              ).save_pretrained(str(d))
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    return d


def test_embedder_runs_on_the_servers_device(tiny_bert):
    """load_embedder puts the encoder on the device it is given (main.py
    gives the server's); on the CPU its vectors equal the JAX package's
    sidecar's (both run the same torch encoder) to 1e-6."""
    from ai00_server_tpu.server import embed as jembed
    from ai00_server_tpu_torch.server import embed as tembed

    server = Server(Config(), device="cpu")
    emb = asyncio.run(tembed.load_embedder({"model": str(tiny_bert)},
                                           device=server.middleware.device))
    assert emb.device == server.middleware.device
    assert {p.device.type for p in emb.model.parameters()} == {"cpu"}
    ref = asyncio.run(jembed.load_embedder({"model": str(tiny_bert)}))
    texts = ["hello world", "abc", "hello hello world world z"]
    got = emb.embed(texts)
    assert got.shape == (3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, ref.embed(texts), atol=1e-6)
    assert emb.split_chunks("hello world " * 9, 4) == ref.split_chunks(
        "hello world " * 9, 4)


def test_embeds_route_equals_jax_sidecar(site, tiny_bert):
    """/api/oai/embeds with an [embed] model: the same chunks as the JAX
    server's and vectors within 1e-6; an empty input answers 400."""
    from ai00_server_tpu.server import embed as jembed
    from ai00_server_tpu_torch.server import embed as tembed

    async def one(jax_side):
        client, server = await started(site, jax_side)
        try:
            server.embedder = await (
                jembed.load_embedder({"model": str(tiny_bert)}) if jax_side
                else tembed.load_embedder({"model": str(tiny_bert)},
                                          device=server.middleware.device))
            await post(client, "/api/oai/embeds", 400, input="")
            return await post(client, "/api/oai/embeds",
                              input="hello world " * 12, max_tokens=8)
        finally:
            await client.close()
            await server.middleware.unload()

    j, t = (asyncio.run(one(side)) for side in (True, False))
    assert t["object"] == j["object"] == "embeds"
    tc, jc = t["data"][0]["chunks"], j["data"][0]["chunks"]
    assert len(tc) > 1 and [c["chunk"] for c in tc] == [c["chunk"]
                                                        for c in jc]
    np.testing.assert_allclose([c["embed"] for c in tc],
                               [c["embed"] for c in jc], atol=1e-6)


def test_only_mean_hidden_embeds_add_hidden_sums(site):
    """A completion leaves the engine's hidden sums untouched (no row is
    tracked, step() adds nothing); a mean-hidden /embeddings request tracks
    the rows it runs on."""
    async def main():
        client, server = await started(site, False)
        try:
            eng = server.middleware.env.engine
            await post(client, "/api/oai/completions", prompt="ABBA",
                       max_tokens=4, sampler=GREEDY)
            assert not eng.hsum_rows.any()
            assert not eng.read_hidden_sums().any()
            await post(client, "/api/oai/embeddings", input=["ABBA", "CAB"])
            assert eng.hsum_rows.sum() == 2
            assert eng.read_hidden_sums().any()
        finally:
            await client.close()
            await server.middleware.unload()

    asyncio.run(main())
