"""The port's HTTP stack on a (dp=4, tp=2) mesh of CPU places, mirroring
``tests/test_http_mesh.py``: ``[model] mesh = [dp, tp]`` in the TOML
reaches ``Middleware.reload``, the engine shards the weights and the pools,
and generation, row reads and writes, the prefix cache and ``/api/oai/
states`` behave as on one device; ``/admin/models/save`` gathers the
shards into a prefab that reloads to the same tokens.

On the CPU the CPU stands for every place, so the middleware cannot be
short of devices there: the "needs N devices" check is held through
``make_mesh`` with a short device list (the JAX test asks its middleware
for 16 of its 8 virtual devices).
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch.middleware import ReloadRequest
from ai00_server_tpu_torch.parallel import make_mesh
from ai00_server_tpu_torch.server.app import Server
from ai00_server_tpu_torch.server.config import Config
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_loader import to_converted_layout

cpu_test_threads()

GREEDY = {"type": "Nucleus", "top_k": 1}


def write_site(root, version=ModelVersion.V7, mesh=(4, 2)):
    models = root / "assets" / "models"
    tok_dir = root / "assets" / "tokenizer"
    cfg_dir = root / "assets" / "configs"
    for d in (models, tok_dir, cfg_dir):
        d.mkdir(parents=True)
    _, raw, _ = make_tiny_model(version, seed=21, dtype=np.float32,
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
mesh = [{mesh[0]}, {mesh[1]}]

[tokenizer]
path = "{tok_dir / 'vocab.json'}"

[listen]
port = 0
""")
    return root


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    return write_site(tmp_path_factory.mktemp("mesh_site"))


@pytest.fixture(scope="module", params=["V6", "V4"])
def family_site(request, tmp_path_factory):
    """A tiny RWKV-6 (2 heads of 16) or RWKV-4 (32 channels) site served on
    ``mesh = [2, 2]``: a tp place holds one head or 16 channels."""
    root = tmp_path_factory.mktemp(f"mesh_site_{request.param.lower()}")
    return write_site(root, ModelVersion(request.param), (2, 2))


async def make_client(site, mesh=True, **override):
    config = Config.from_toml(str(site / "assets/configs/Config.toml"))
    req = config.to_reload_request(sandbox=False)
    if not mesh:
        req.mesh = None
    for k, v in override.items():
        setattr(req, k, v)
    server = Server(config, device="cpu")
    await server.middleware.reload(req)
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, server


async def _greedy_completion(client, prompt, n=6):
    r = await client.post("/api/oai/completions", json={
        "prompt": prompt, "max_tokens": n, "sampler": GREEDY})
    assert r.status == 200
    return (await r.json())["choices"][0]["text"]


def test_mesh_reported_and_generation_matches_single_device(site):
    async def main():
        client, server = await make_client(site)
        try:
            r = await client.get("/api/models/info")
            info = await r.json()
            assert info["mesh"] == {"dp": 4, "tp": 2, "devices": 8}
            assert info["reload"]["mesh"] == [4, 2]
            engine = server.middleware.env.engine
            assert engine.mesh.shape == {"dp": 4, "tp": 2}
            assert engine.local_batch == 1
            sharded = await _greedy_completion(client, "ABCAB")
        finally:
            await client.close()
            await server.middleware.unload()

        client, server = await make_client(site, mesh=False)
        try:
            r = await client.get("/api/models/info")
            assert (await r.json())["mesh"] is None
            single = await _greedy_completion(client, "ABCAB")
        finally:
            await client.close()
            await server.middleware.unload()
        return sharded, single

    sharded, single = asyncio.run(main())
    assert sharded == single and sharded


def test_mesh_concurrent_and_prefix_cache(site):
    """Concurrent requests land in different dp ranks of the slot pool; the
    prefix cache round-trips states through sharded row reads and writes;
    ``/api/oai/states`` reads a sharded row (its heads gathered)."""
    prompt = "ABCABCABCABCABCABCABCABCABCABCABCABC"  # 36 tokens >= 32

    async def main():
        client, server = await make_client(site)
        try:
            texts = await asyncio.gather(*[
                _greedy_completion(client, p, n=4)
                for p in ("ABCAB", "BCABC", "CABCA", "ABCAB")])
            assert texts[0] == texts[3]  # same prompt, greedy

            t1 = await _greedy_completion(client, prompt, n=4)
            cache = server.middleware.env.runtime.cache_for("default")
            assert cache.count >= 1  # prompt state cached (sharded read)
            t2 = await _greedy_completion(client, prompt, n=4)
            assert t1 == t2  # exact-hit fast path equals cold run

            r = await client.post("/api/oai/states", json={"input": "AB"})
            assert r.status == 200
            sharded = (await r.json())["data"][0]
        finally:
            await client.close()
            await server.middleware.unload()

        client, server = await make_client(site, mesh=False)
        try:
            r = await client.post("/api/oai/states", json={"input": "AB"})
            single = (await r.json())["data"][0]
        finally:
            await client.close()
            await server.middleware.unload()
        return sharded, single

    sharded, single = asyncio.run(main())
    assert sharded["shape"] == single["shape"]
    # f32, another order of the output projection's sums: 1e-5 of scale.
    got, want = np.asarray(sharded["data"]), np.asarray(single["data"])
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())


def test_mesh_validation_errors(site):
    async def main():
        config = Config.from_toml(str(site / "assets/configs/Config.toml"))
        req = config.to_reload_request(sandbox=False)
        server = Server(config, device="cpu")
        req.mesh = [16, 1]  # the CPU stands for 16 places: dp > max_batch
        with pytest.raises(ValueError, match="divisible"):
            await server.middleware.reload(req)
        req.mesh = [3, 1]   # dp does not divide max_batch=4
        with pytest.raises(ValueError, match="divisible"):
            await server.middleware.reload(req)
        req.mesh = [2, 0]
        with pytest.raises(ValueError, match="positive"):
            await server.middleware.reload(req)
        assert server.middleware.env is None

    asyncio.run(main())
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(dp=16, tp=1, devices=[torch.device("cpu")] * 8)


def test_mesh_needs_devices_on_cards(site, monkeypatch):
    """On a card the places are the distinct cards: a mesh larger than
    ``torch.cuda.device_count()`` is refused before anything loads."""
    from ai00_server_tpu_torch import middleware as mw

    m = mw.Middleware(device="cpu")
    monkeypatch.setattr(m, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    req = ReloadRequest(model_path="unused.st", max_batch=4, mesh=[2, 1])
    with pytest.raises(ValueError, match=r"mesh \[2, 1\] needs 2 devices, "
                                         r"have 1"):
        asyncio.run(m.reload(req))


def test_mesh_prefab_save_reloads_to_the_same_tokens(site):
    """``/admin/models/save`` gathers the shards into one prefab; reloaded
    on the mesh and on one device it answers as the sharded model did."""
    async def main():
        client, server = await make_client(site)
        try:
            before = await _greedy_completion(client, "BCABCA", n=8)
            r = await client.post("/api/auth/exchange", json={
                "app_id": "admin", "app_secret": "ai00_is_good"})
            hdrs = {"Authorization": f"Bearer {(await r.json())['token']}"}
            r = await client.post("/admin/models/save", headers=hdrs,
                                  json={"path": "mesh.prefab"})
            assert r.status == 200, await r.text()
            path = (await r.json())["path"]
        finally:
            await client.close()
            await server.middleware.unload()
        after = []
        for mesh in (True, False):
            client, server = await make_client(site, mesh=mesh,
                                               model_path=path)
            try:
                after.append(await _greedy_completion(client, "BCABCA", n=8))
            finally:
                await client.close()
                await server.middleware.unload()
        os.remove(path)
        return before, after

    before, after = asyncio.run(main())
    assert after == [before, before]


def test_family_mesh_reported_and_generation_matches_single_device(
        family_site):
    """RWKV-6 / RWKV-4 at tp = 2: ``/api/models/info`` reports the mesh,
    greedy completions (concurrent ones landing in both dp ranks) equal
    the single-device server's, and ``/api/oai/states`` reads a row whose
    heads (RWKV-4: ``aa`` / ``bb`` / ``pp`` channels) are gathered from
    both places, equal to the single-device one to 1e-5 of its scale (f32,
    another order of the split products' sums)."""
    prompts = ("ABCAB", "BCABC", "CABCA")

    async def run(mesh):
        client, server = await make_client(family_site, mesh=mesh)
        try:
            r = await client.get("/api/models/info")
            info = (await r.json())["mesh"]
            texts = await asyncio.gather(*[_greedy_completion(client, p)
                                           for p in prompts])
            r = await client.post("/api/oai/states", json={"input": "AB"})
            assert r.status == 200
            return info, texts, (await r.json())["data"][0]
        finally:
            await client.close()
            await server.middleware.unload()

    sharded = asyncio.run(run(True))
    single = asyncio.run(run(False))
    assert sharded[0] == {"dp": 2, "tp": 2, "devices": 4}
    assert single[0] is None
    assert sharded[1] == single[1] and all(sharded[1])
    assert sharded[2]["shape"] == single[2]["shape"]
    got = np.asarray(sharded[2]["data"])
    want = np.asarray(single[2]["data"])
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())


def test_family_mesh_prefab_save_reloads_to_the_same_tokens(family_site):
    """A prefab saved from the RWKV-6 / RWKV-4 mesh (the shards gathered)
    reloads, on the mesh and on one device, to the same greedy tokens."""
    async def main():
        client, server = await make_client(family_site)
        try:
            before = await _greedy_completion(client, "BCABCA", n=8)
            path = str(family_site / "assets" / "models" / "mesh.prefab")
            await server.middleware.save(path)
        finally:
            await client.close()
            await server.middleware.unload()
        after = []
        for mesh in (True, False):
            client, server = await make_client(family_site, mesh=mesh,
                                               model_path=path)
            try:
                after.append(await _greedy_completion(client, "BCABCA", n=8))
            finally:
                await client.close()
                await server.middleware.unload()
        os.remove(path)
        return before, after

    before, after = asyncio.run(main())
    assert before and after == [before, before]
