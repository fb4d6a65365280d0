"""The port's admin, file, metrics, profile and docs routes on the CPU
(``device="cpu"``), held against the JAX package.

The site is ``tests/test_torch_http.py``'s tiny f32 RWKV-7 with the
listener of ``tests/test_http.py``: ``force_pass = false``, a ``slot`` and
an app key.  Compared with the JAX package, each exactly (tolerance 0:
text, bytes and integers):

* JWT: ``encode_jwt`` byte for byte, each package decodes the other's
  token, both refuse an expired or a tampered one;
* files: ``list_dir``, ``list_models``, ``sampled_sha`` (a sparse file
  over 10 MB) and ``safetensors_header`` on one tree, and the file routes;
* config: ``Config.from_toml(...).to_dict()`` and ``dump_toml`` on a TOML
  with every listener field;
* routes: the ``(method, path)`` sets of the two route tables, and the
  OpenAPI spec documents every registered route;
* metrics: ``/api/metrics`` after the same greedy requests prints every
  line the JAX server prints, with equal request and token counters.

And the port alone: the admin flow of ``test_http.py::test_auth_and_admin``
(401, 403, unload / load / partial load, a completion after each), a
prefab saved and loaded through the routes answering the same greedy text,
the first ``/api/models/state`` event equal to ``/api/models/info``, and
``/admin/profile`` on ``torch.profiler``.

Four JAX defects the port does not copy, each shown beside the JAX
behaviour: ``admin_load`` leaves LoRA and state paths unchecked,
``admin_save`` checks the model directory but writes a name into the
working directory, ``unzip`` checks containment by string prefix, and a
configured ``[web]`` zip's ``index.html`` never reaches ``/``.  The port
answers a refused path 403; the JAX server 500 (``PermissionError`` gets
past its ``bad_request_middleware``).
"""

import asyncio
import json
import os
import time
import tomllib
import zipfile

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.server import auth as jauth
from ai00_server_tpu.server import config as jconfig
from ai00_server_tpu.server import files as jfiles
from ai00_server_tpu.server.app import Server as JServer
from ai00_server_tpu.server.config import Config as JConfig
from ai00_server_tpu.server.webui import WEBUI_HTML as JWEBUI_HTML
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch import main as tmain
from ai00_server_tpu_torch.server import auth, config as tconfig, files
from ai00_server_tpu_torch.server.app import PROFILE_TRACE, Server
from ai00_server_tpu_torch.server.config import Config
from ai00_server_tpu_torch.server.webui import WEBUI_HTML
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_loader import to_converted_layout
from test_torch_states_runtime import tuned_file

cpu_test_threads()

GREEDY = {"type": "Nucleus", "top_k": 1}
SLOT = "testsecret"
KEY = {"app_id": "admin", "app_secret": "testkey"}


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """``assets/{models,tokenizer,configs}`` with the tiny v7, the char
    vocabulary and a config whose listener wants a JWT."""
    root = tmp_path_factory.mktemp("adminsite")
    models = root / "assets" / "models"
    tok_dir = root / "assets" / "tokenizer"
    cfg_dir = root / "assets" / "configs"
    for d in (models, tok_dir, cfg_dir):
        d.mkdir(parents=True)
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=21, dtype=np.float32,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw),
                             str(models / "tiny.st"), dtype=np.float32)
    (tok_dir / "vocab.json").write_text(json.dumps(
        {str(i): chr(64 + i) for i in range(1, 60)}))
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
force_pass = false
slot = "{SLOT}"

[[listen.app_keys]]
app_id = "admin"
secret_key = "testkey"
""")
    return root


def _config(site, jax_side=False):
    cls = JConfig if jax_side else Config
    return cls.from_toml(str(site / "assets/configs/Config.toml"))


async def _client(site, jax_side=False, load=True):
    config = _config(site, jax_side)
    server = JServer(config) if jax_side else Server(config, device="cpu")
    if load:
        await server.middleware.reload(
            config.to_reload_request(sandbox=False))
    client = TestClient(TestServer(server.app))
    await client.start_server()
    return client, server


async def _close(client, server):
    await client.close()
    await server.middleware.unload()


def on_site(site, script, jax_side=False, load=True):
    """Run ``script(client, server)`` against a fresh server of the site."""
    async def main():
        client, server = await _client(site, jax_side, load)
        try:
            return await script(client, server)
        finally:
            await _close(client, server)
    return asyncio.run(main())


async def _token(client) -> dict:
    r = await client.post("/api/auth/exchange", json=KEY)
    assert r.status == 200
    return {"Authorization": f"Bearer {(await r.json())['token']}"}


async def _text(client, prompt="ABCAB", max_tokens=6) -> str:
    r = await client.post("/api/oai/completions", json={
        "prompt": prompt, "max_tokens": max_tokens, "sampler": GREEDY})
    assert r.status == 200, await r.text()
    return (await r.json())["choices"][0]["text"]


# ---------------------------------------------------------------------------
# Framework-free modules against the JAX package's
# ---------------------------------------------------------------------------


def test_jwt_equals_jax_both_ways():
    claims = {"sid": "admin", "exp": int(time.time()) + 60}
    port = auth.encode_jwt(claims, SLOT)
    assert port == jauth.encode_jwt(claims, SLOT)
    for tok in (auth.make_token("admin", SLOT), jauth.make_token("admin",
                                                                 SLOT)):
        assert auth.decode_jwt(tok, SLOT)["sid"] == "admin"
        assert jauth.decode_jwt(tok, SLOT)["sid"] == "admin"
        assert auth.decode_jwt(tok, "other") is None
    expired = auth.encode_jwt({"sid": "admin", "exp": 1}, SLOT)
    h, p, s = port.split(".")
    forged = auth._b64url(json.dumps({"sid": "root", "exp": claims["exp"]},
                                     separators=(",", ":")).encode())
    bad_sig = s[:-2] + ("AA" if s[-2:] != "AA" else "BB")
    for tok in (expired, f"{h}.{forged}.{s}", f"{h}.{p}.{bad_sig}",
                "not-a-token"):
        assert auth.decode_jwt(tok, SLOT) is None
        assert jauth.decode_jwt(tok, SLOT) is None


def test_files_equal_jax(tmp_path):
    """One tree: a sparse 12 MB model file (``sampled_sha``'s sampled
    form), a small one, a safetensors ``.state``, a prefab, a nested model
    and a plain file."""
    models = tmp_path / "models"
    (models / "sub").mkdir(parents=True)
    with open(models / "big.st", "wb") as f:
        f.truncate(12 << 20)
        for i in range(0, 12 << 20, 3 << 20):
            f.seek(i)
            f.write(b"x%d" % i)
    tuned_file(models / "a.state", make_tiny_model(
        ModelVersion.V7, seed=3, dtype=np.float32)[0])
    (models / "small.prefab").write_bytes(bytes(range(256)) * 5)
    (models / "sub" / "deep.pth").write_bytes(b"abc")
    (models / "notes.txt").write_text("hi")
    for fn in ("big.st", "a.state", "small.prefab", "notes.txt"):
        path = str(models / fn)
        assert files.sampled_sha(path) == jfiles.sampled_sha(path)
        assert files.safetensors_header(path) == jfiles.safetensors_header(
            path)
    assert files.safetensors_header(str(models / "a.state"))
    for with_hash in (False, True):
        assert files.list_dir(str(models), with_hash) == jfiles.list_dir(
            str(models), with_hash)
    listed = files.list_models(str(models))
    assert listed == jfiles.list_models(str(models))
    assert sorted(m["name"] for m in listed) == [
        "big.st", "small.prefab", os.path.join("sub", "deep.pth")]
    assert files.list_models(str(tmp_path / "absent")) == []
    assert files.PERMITTED == jfiles.PERMITTED


FULL_TOML = """
[model]
name = "m.st"
path = "assets/models"
quant = 2
quant_type = "NF4"

[[lora]]
path = "l.st"
alpha = 0.5

[[state]]
path = "s.state"
name = "tuned"
id = "fd7a60ed-7807-449f-8256-bccae3246222"
default = true

[tokenizer]
path = "assets/tokenizer/vocab.json"

[bnf]
start_nonterminal = "start"

[adapter.Manual]
index = 1

[listen]
domain = "example.test"
ip = "::1"
port = 8443
acme = true
tls = true
force_pass = false
slot = "s\\"lot\\\\x"
expire_sec = 60
tls_cert = "assets/certs/c.pem"
tls_key = "assets/certs/k.pem"
acme_directory = "http://127.0.0.1:1/directory"
acme_contact = "ops@example.test"
quic = true

[[listen.app_keys]]
app_id = "a"
secret_key = "b"

[[listen.app_keys]]
app_id = "c"
secret_key = "d"

[web]
path = "assets/www/index.zip"

[embed]
path = "assets/models/embed"
"""


@pytest.mark.parametrize("text", [FULL_TOML, "[model]\nname = \"m.st\"\n"])
def test_config_to_dict_and_toml_equal_jax(tmp_path, text):
    """Every listener field (and the defaults) read, written and read back
    as the JAX package does."""
    path = tmp_path / "Config.toml"
    path.write_text(text)
    port = Config.from_toml(str(path)).to_dict()
    assert port == JConfig.from_toml(str(path)).to_dict()
    out = tconfig.dump_toml(port)
    assert out == jconfig.dump_toml(port)
    assert Config.from_dict(tomllib.loads(out)).to_dict() == port


# ---------------------------------------------------------------------------
# Route table and OpenAPI
# ---------------------------------------------------------------------------


def _route_set(app) -> set:
    return {(r.method, r.resource.canonical) for r in app.router.routes()
            if r.method != "HEAD"}


def test_route_table_equals_jax_and_spec_documents_it(site):
    port, ref = Server(Config(), device="cpu"), JServer(JConfig())
    assert _route_set(port.app) == _route_set(ref.app)
    assert len(_route_set(port.app)) == 40

    async def script(client, server):
        spec = await (await client.get("/api-docs/openapi.json")).json()
        documented = {(m.upper(), p) for p, ops in spec["paths"].items()
                      for m in ops}
        assert documented == _route_set(server.app)
        assert "pooling" in json.dumps(
            spec["paths"]["/api/oai/embeddings"]["post"])
        assert spec["paths"]["/api/metrics"]["get"]["summary"]
        assert "torch.profiler" in spec["paths"]["/admin/profile/start"][
            "post"]["summary"]
        r = await client.get("/")
        assert r.headers["Content-Type"].startswith("text/html")
        assert await r.text() == WEBUI_HTML

    on_site(site, script, load=False)


# ---------------------------------------------------------------------------
# Metrics, SSE
# ---------------------------------------------------------------------------

LONG = "ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 2
METRIC_PROMPTS = ("ABCAB", "QRS", LONG, LONG + "ABC")
COUNTERS = ("requests_started", "requests_finished", "prefill_tokens",
            "decode_tokens", "cache_hits")


def _metrics(text: str) -> dict:
    return dict(line.split(" ", 1) for line in text.strip().splitlines())


def test_metrics_equal_jax(site):
    """The same greedy requests, one after another, on both servers: every
    line name the JAX server prints, the request and token counters equal
    (the last prompt extends the one before: a prefix-cache hit on both),
    no busy slot and a positive mean step time.  Each request waits for the
    prompt-cache stores to land (``flush_cache_stores``): on either side a
    store still copying to the host when the next request arrives is a
    miss, by timing alone."""
    async def script(client, server):
        before = _metrics(await (await client.get("/api/metrics")).text())
        texts = []
        for p in METRIC_PROMPTS:
            texts.append(await _text(client, p, 8))
            await server.middleware.env.runtime.flush_cache_stores()
        r = await client.get("/api/metrics")
        assert r.headers["Content-Type"].startswith("text/plain")
        for _ in range(100):  # the last slot frees right after its stream
            after = _metrics(await (await client.get("/api/metrics")).text())
            if after["ai00_slots_busy"] == "0":
                break
            await asyncio.sleep(0.01)
        return before, after, texts

    port = on_site(site, script)
    ref = on_site(site, script, jax_side=True)
    assert port[2] == ref[2]
    for (p, j) in ((port[0], ref[0]), (port[1], ref[1])):
        assert set(j) <= set(p), set(j) - set(p)
        for k in COUNTERS:
            assert int(p[f"ai00_runtime_{k}"]) == int(j[f"ai00_runtime_{k}"]
                                                      ), k
    after = port[1]
    assert after["ai00_model_loaded"] == "1"
    assert int(after["ai00_runtime_requests_finished"]) == len(
        METRIC_PROMPTS)
    assert int(after["ai00_runtime_cache_hits"]) >= 1
    assert after["ai00_slots_busy"] == "0"
    assert after["ai00_slots_total"] == "4"
    assert float(after["ai00_step_seconds_avg"]) > 0
    assert int(after["ai00_runtime_steps"]) >= 1


def test_models_state_sse_first_event_equals_info(site):
    async def script(client, server):
        info = await (await client.get("/api/models/info")).json()
        r = await client.get("/api/models/state")
        assert r.headers["Content-Type"].startswith("text/event-stream")
        while True:
            line = (await r.content.readline()).decode().strip()
            if line.startswith("data: "):
                break
        r.close()
        assert json.loads(line[6:]) == info
        assert info["state"] == "loaded"

    on_site(site, script)


# ---------------------------------------------------------------------------
# The admin flow, prefab round trip, file routes
# ---------------------------------------------------------------------------


def test_auth_and_admin_flow(site):
    """``test_http.py::test_auth_and_admin`` on the port, with a completion
    after each step and the token also as ``?admin_token=``."""
    async def script(client, server):
        before = await _text(client)
        r = await client.get("/admin/models/unload")
        assert r.status == 401
        r = await client.get("/admin/models/unload", headers={
            "Authorization": "Bearer " + auth.make_token("admin", "x")})
        assert r.status == 401
        expired = auth.encode_jwt({"sid": "admin", "exp": 1}, SLOT)
        r = await client.get(f"/admin/models/unload?admin_token={expired}")
        assert r.status == 401
        assert server.middleware.env is not None
        r = await client.post("/api/auth/exchange", json={
            "app_id": "admin", "app_secret": "wrong"})
        assert r.status == 403
        assert (await r.json())["token"] is None
        hdrs = await _token(client)
        r = await client.get("/admin/models/unload", headers=hdrs)
        assert r.status == 200
        assert server.middleware.env is None
        r = await client.post("/admin/models/load", headers=hdrs, json={
            "model_path": "tiny.st", "precision": "Fp32",
            "tokenizer_path": str(site / "assets/tokenizer/vocab.json"),
            "max_batch": 2, "token_chunk_size": 8})
        assert r.status == 200, await r.text()
        assert server.middleware.env.reload.max_batch == 2
        assert await _text(client) == before
        # A partial body keeps the configured tokenizer.
        token = hdrs["Authorization"][7:]
        r = await client.post(f"/admin/models/load?admin_token={token}",
                              json={"model_path": "tiny.st",
                                    "precision": "Fp32", "max_batch": 2,
                                    "token_chunk_size": 8})
        assert r.status == 200, await r.text()
        assert server.middleware.env.reload.tokenizer_path == str(
            site / "assets/tokenizer/vocab.json")
        assert await _text(client) == before
        r = await client.post("/admin/models/load", headers=hdrs, json={
            "model_path": str(site / "assets/tokenizer/vocab.json")})
        assert r.status == 403
        assert await _text(client) == before

    on_site(site, script)


def test_prefab_save_and_load_through_the_routes(site):
    async def script(client, server):
        hdrs = await _token(client)
        before = await _text(client, "QRS", 8)
        r = await client.post("/admin/models/save", headers=hdrs,
                              json={"path": "rt.prefab"})
        assert r.status == 200, await r.text()
        path = (await r.json())["path"]
        assert path == str(site / "assets/models/rt.prefab")
        try:
            r = await client.get("/api/models/list")
            assert "rt.prefab" in {m["name"] for m in await r.json()}
            r = await client.post("/admin/models/load", headers=hdrs,
                                  json={"model_path": "rt.prefab"})
            assert r.status == 200, await r.text()
            assert server.middleware.env.reload.model_path == path
            assert await _text(client, "QRS", 8) == before
        finally:
            os.remove(path)

    on_site(site, script)


def test_file_routes_equal_jax(site, monkeypatch):
    """``/admin/files/dir`` and ``/ls``, ``config/load``, ``config/save``
    and ``/api/models/list`` from the site root (``files.PERMITTED`` is
    relative to the working directory): the same bodies as the JAX
    server's, and a path outside answers 403 (the JAX server 500)."""
    monkeypatch.chdir(site)

    async def script(client, server):
        hdrs = await _token(client)
        out = []
        for route, body in (
                ("/admin/files/dir", {"path": "assets/models"}),
                ("/admin/files/ls", {"path": "assets"}),
                ("/admin/files/config/load",
                 {"path": "assets/configs/Config.toml"}),
                ("/admin/files/config/save",
                 {"path": "assets/configs/Saved.toml",
                  "config": tomllib.loads(FULL_TOML)})):
            r = await client.post(route, headers=hdrs, json=body)
            assert r.status == 200, await r.text()
            out.append(await r.json())
        out.append((site / "assets/configs/Saved.toml").read_text())
        out.append(await (await client.get("/api/models/list")).json())
        refused = [(await client.post(route, headers=hdrs, json=body)).status
                   for route, body in (
                       ("/admin/files/dir", {"path": "/"}),
                       ("/admin/files/config/load",
                        {"path": "assets/../../Config.toml"}),
                       ("/admin/files/config/save",
                        {"path": "Saved.toml", "config": {}}))]
        return out, refused

    port, port_refused = on_site(site, script, load=False)
    ref, ref_refused = on_site(site, script, jax_side=True, load=False)
    assert port == ref
    assert port_refused == [403, 403, 403]
    assert ref_refused == [500, 500, 500]
    assert port[2]["listen"]["force_pass"] is False


# ---------------------------------------------------------------------------
# /admin/profile on torch.profiler
# ---------------------------------------------------------------------------


def test_profile_on_the_cpu(site, tmp_path):
    """start, a completion, stop: the Chrome trace at ``<dir>/trace.json``
    holds the engine's ops (recorded on its worker thread where this
    PyTorch profiles every thread).  A second start and a stop with no
    trace running answer 409 and leave the running trace as it is."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        _ExperimentalConfig(profile_all_threads=True)
        all_threads = True
    except TypeError:
        all_threads = False
    trace_dir = tmp_path / "prof"

    async def script(client, server):
        hdrs = await _token(client)
        r = await client.post("/admin/profile/stop", headers=hdrs)
        assert r.status == 409
        r = await client.post("/admin/profile/start", json={})
        assert r.status == 401
        r = await client.post("/admin/profile/start", headers=hdrs,
                              json={"dir": str(trace_dir)})
        assert r.status == 200
        assert await r.json() == {"state": "tracing", "dir": str(trace_dir)}
        r = await client.post("/admin/profile/start", headers=hdrs,
                              json={"dir": str(tmp_path / "other")})
        assert r.status == 409
        await _text(client, "ABC", 2)
        r = await client.post("/admin/profile/stop", headers=hdrs)
        assert r.status == 200
        assert await r.json() == {"state": "stopped"}
        r = await client.post("/admin/profile/stop", headers=hdrs)
        assert r.status == 409

    on_site(site, script)
    assert not (tmp_path / "other").exists()
    with open(trace_dir / PROFILE_TRACE) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert ops
    if all_threads:
        assert "aten::mm" in ops or "aten::matmul" in ops, sorted(ops)[:20]


def test_profile_refused_on_a_cuda_server_without_cuda_activity(
        site, monkeypatch, tmp_path):
    """A CUDA server whose PyTorch cannot record CUDA activity answers 501
    and starts no trace (no CPU-only trace of a CUDA server)."""
    import torch
    import torch.profiler

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})

    async def script(client, server):
        server.middleware.device = torch.device("cuda")
        hdrs = await _token(client)
        r = await client.post("/admin/profile/start", headers=hdrs,
                              json={"dir": str(tmp_path / "p")})
        assert r.status == 501
        assert "CUDA" in (await r.json())["error"]
        assert server._profile is None
        r = await client.post("/admin/profile/stop", headers=hdrs)
        assert r.status == 409

    on_site(site, script, load=False)
    assert not (tmp_path / "p").exists()


# ---------------------------------------------------------------------------
# JAX defects the port does not copy
# ---------------------------------------------------------------------------


def test_admin_load_checks_lora_and_state_paths(site, tmp_path):
    """A reload whose ``state`` (or ``lora``) path lies outside the model
    directory: the port answers 403 and keeps serving; the JAX server
    reads the file (``ReloadRequest.from_json`` takes the entries
    unchecked) and lists the state."""
    outside = tuned_file(tmp_path / "outside.state", make_tiny_model(
        ModelVersion.V7, seed=21, dtype=np.float32, num_vocab=64)[0])
    state = [{"path": outside, "name": "outside",
              "id": "fd7a60ed-7807-449f-8256-bccae3246222"}]

    async def script(client, server):
        hdrs = await _token(client)
        statuses = []
        for extra in ({"state": state},
                      {"lora": [{"path": outside, "alpha": 1.0}]}):
            r = await client.post("/admin/models/load", headers=hdrs, json={
                "model_path": "tiny.st", "precision": "Fp32", **extra})
            statuses.append(r.status)
            if r.status == 200:
                break
        info = server.middleware.info()
        return statuses, [s["name"] for s in info["states"]], \
            await _text(client)

    port = on_site(site, script)
    ref = on_site(site, script, jax_side=True)
    assert port[0] == [403, 403] and port[1] == []
    assert port[2]
    assert ref[0] == [200] and ref[1] == ["outside"]


def test_admin_save_puts_a_name_in_the_model_directory(site, tmp_path,
                                                       monkeypatch):
    """``{"path": "x.prefab"}``: the port writes it into the model
    directory; the JAX server checks the model directory and writes into
    the working directory.  A path that leaves the directory answers 403
    (the JAX server 500)."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    models = site / "assets" / "models"

    async def script(client, server):
        hdrs = await _token(client)
        r = await client.post("/admin/models/save", headers=hdrs,
                              json={"path": "x.prefab"})
        assert r.status == 200, await r.text()
        r2 = await client.post("/admin/models/save", headers=hdrs,
                               json={"path": str(tmp_path / "y.prefab")})
        return (await r.json())["path"], r2.status

    try:
        path, refused = on_site(site, script)
        assert path == str(models / "x.prefab")
        assert os.path.getsize(path) > 0 and not (cwd / "x.prefab").exists()
        assert refused == 403
        os.remove(path)
        path, refused = on_site(site, script, jax_side=True)
        assert path == "x.prefab" and (cwd / "x.prefab").exists()
        assert not (models / "x.prefab").exists()
        assert refused == 500
    finally:
        for p in (models / "x.prefab", cwd / "x.prefab"):
            if p.exists():
                p.unlink()
    assert not (tmp_path / "y.prefab").exists()


def _zip(path, members: dict) -> str:
    with zipfile.ZipFile(path, "w") as z:
        for name, data in members.items():
            z.writestr(name, data)
    return str(path)


def test_unzip_checks_containment_by_path_components(site, tmp_path,
                                                     monkeypatch):
    """A target ``.../www`` holding a link ``l -> ../www2`` and a zip with
    the member ``l/x.txt``: its real path ``.../www2/x.txt`` starts with
    the string ``.../www``, so the JAX check passes it and ``extractall``
    writes through the link beside the target.  The port compares path
    components and refuses the zip before writing anything (a ``../``
    member too, which ``extractall`` would have flattened into the
    target); its route answers 403."""
    evil = _zip(tmp_path / "evil.zip", {"ok.txt": "fine",
                                        "l/x.txt": "escaped"})
    for side in ("port", "jax"):
        (tmp_path / side / "www").mkdir(parents=True)
        (tmp_path / side / "www2").mkdir()
        os.symlink("../www2", tmp_path / side / "www" / "l")
    with pytest.raises(PermissionError, match="escapes"):
        files.unzip(evil, str(tmp_path / "port" / "www"))
    with pytest.raises(PermissionError, match="escapes"):
        files.unzip(_zip(tmp_path / "dots.zip", {"../www2/y.txt": "y"}),
                    str(tmp_path / "port" / "www"))
    assert os.listdir(tmp_path / "port" / "www2") == []
    assert os.listdir(tmp_path / "port" / "www") == ["l"]
    jfiles.unzip(evil, str(tmp_path / "jax" / "www"))
    assert (tmp_path / "jax" / "www2" / "x.txt").read_text() == "escaped"
    # Members inside the target, given with a trailing "/".
    files.unzip(_zip(tmp_path / "good.zip", {"a/b.txt": "b"}),
                str(tmp_path / "port" / "www") + "/")
    assert (tmp_path / "port" / "www" / "a" / "b.txt").read_text() == "b"

    monkeypatch.chdir(site)
    (site / "assets" / "www").mkdir(exist_ok=True)
    os.replace(evil, site / "assets" / "evil.zip")
    os.symlink("../www2", site / "assets" / "www" / "l")

    async def script(client, server):
        r = await client.post("/admin/files/unzip",
                              headers=await _token(client),
                              json={"zip_path": "assets/evil.zip",
                                    "target_dir": "assets/www"})
        return r.status

    try:
        assert on_site(site, script, load=False) == 403
        assert not (site / "assets" / "www2").exists()
    finally:
        os.remove(site / "assets" / "evil.zip")
        os.remove(site / "assets" / "www" / "l")


async def _get(app, *paths) -> list[str]:
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return [await (await client.get(p)).text() for p in paths]
    finally:
        await client.close()


def test_web_zip_index_is_served_at_root(site, tmp_path):
    """A ``[web]`` zip with its own ``index.html``: the port's
    ``setup_webui`` serves it at ``/`` (and every file at its path); the
    JAX ``main.py`` lines register the static directory after the built-in
    page, so its ``/`` stays the built-in page."""
    index = "<!DOCTYPE html><title>user SPA</title>" + "<!-- pad -->" * 200
    web_zip = _zip(tmp_path / "index.zip", {"index.html": index,
                                            "app.js": "let x = 1;"})
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    _zip(plugins / "extra.zip", {"p.js": "plugin"})
    _zip(plugins / "api.zip", {"skip.js": "no"})

    config = Config.from_dict({"web": {"path": web_zip}})
    server = Server(config, device="cpu")
    tmain.setup_webui(server, config)
    assert server.web_root == str(tmp_path / "_webui")
    assert not (tmp_path / "_webui" / "plugins" / "api").exists()
    assert asyncio.run(_get(server.app, "/", "/index.html", "/app.js",
                            "/plugins/extra/p.js")) == [
        index, index, "let x = 1;", "plugin"]

    jserver = JServer(JConfig())
    target = tmp_path / "_jax_webui"
    jfiles.unzip(web_zip, str(target))  # JAX main.py:94-102
    jserver.app.router.add_static("/", str(target), show_index=True)
    assert asyncio.run(_get(jserver.app, "/")) == [JWEBUI_HTML]
    # Without a zip the port serves the built-in page (checked in
    # test_route_table_equals_jax_and_spec_documents_it).
