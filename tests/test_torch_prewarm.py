"""The port's prewarm against the JAX package's, on the CPU.

* ``ReloadRequest`` ``from_json`` / ``to_json`` equal the JAX ones, key
  order and ``prewarm`` included; ``[model] prewarm`` reaches the request
  (default true) and survives ``dump_toml``; a relative ``[[lora]]`` /
  ``[[state]]`` path that exists only under the model directory is taken
  there, and each LoRA entry is ``{path, alpha}``, as the JAX
  ``to_reload_request`` writes them.
* ``/api/models/info``'s ``reload`` carries ``prewarm``; a prefab's saved
  request carries it, and one saved without the key loads with the
  default, true.
* ``Engine.prewarm`` (the all-idle serving buckets through ``step`` and
  ``decode_chunk(snapshot=False)``) leaves every pool, host flag and the
  snapshot ring bit-equal, rows with hidden sums tracked included, on a
  single engine and on a ``(2, 2)`` CPU mesh; the port of the JAX
  ``test_prewarm_preserves_chunk_snapshots``; a greedy run after a prewarm
  equals one without and the JAX engine's (tokens equal, states at 2e-4 of
  their scale, the port's engine-vs-JAX tolerance in f32).
* ``Middleware``: a prewarm future that completes with ``prewarm`` true,
  none with false; the unload's drain bounded by ``AI00_PREWARM_DRAIN_S``
  in both packages; a prewarm that raises is logged; a request served
  while prewarms run gives the tokens it gives without them.

The JAX engine is never prewarmed here: its own suite holds that its
prewarm changes nothing (``tests/test_prewarm.py``, ``test_drain.py``).
"""

import asyncio
import json
import logging
import threading
import time

import numpy as np
import pytest
import torch
from safetensors import safe_open

import jax
import jax.numpy as jnp

from ai00_server_tpu import engine as jengine_mod
from ai00_server_tpu import loader as jloader
from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.middleware import Middleware as JMiddleware
from ai00_server_tpu.middleware import ReloadRequest as JRequest
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.server.config import Config as JConfig
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch import engine as tengine_mod
from ai00_server_tpu_torch import prefab as tprefab
from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.middleware import Middleware as TMiddleware
from ai00_server_tpu_torch.middleware import ReloadRequest as TRequest
from ai00_server_tpu_torch.ops import sampling
from ai00_server_tpu_torch.runtime import GenerateRequest, Runtime, SamplerSpec
from ai00_server_tpu_torch.server.app import Server
from ai00_server_tpu_torch.server.config import Config as TConfig
from ai00_server_tpu_torch.server.config import dump_toml
from ai00_server_tpu_torch.testing import cpu_test_threads
from ai00_server_tpu_torch.tokenizer import Tokenizer

from test_loader import to_converted_layout
from test_torch_engine_sharded import cpu_mesh, drive, model_inputs, port_engine

cpu_test_threads()

B, CHUNK = 4, 8
GREEDY = {"kind": sampling.KIND_GREEDY, "presence": 0.3, "frequency": 0.3}
NUCLEUS = {"kind": sampling.KIND_NUCLEUS, "top_p": 0.8, "temperature": 0.9,
           "presence": 0.5, "frequency": 0.2}
VOCAB = {str(i): chr(64 + i) for i in range(1, 60)}


def close(got, want, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rtol * scale


# -- the request and the config ------------------------------------------

REQUEST_BODIES = [
    {},
    {"prewarm": False},
    {"model_path": "m.st", "lora": [{"path": "a.lora", "alpha": 0.5}],
     "state": [{"path": "s.state", "name": "s", "default": True}],
     "quant": 2, "quant_type": "NF4", "precision": "Fp32",
     "token_chunk_size": 64, "max_batch": 4, "tokenizer_path": "v.json",
     "bnf": {"start_nonterminal": "start"}, "adapter": {"Manual": 0},
     "decode_chunk_size": 8, "mesh": [2, 1], "prewarm": False,
     "unknown": 1},
]


@pytest.mark.parametrize("body", REQUEST_BODIES,
                         ids=["empty", "prewarm-off", "every-key"])
def test_reload_request_json_equals_jax(body):
    got = TRequest.from_json(body).to_json()
    want = JRequest.from_json(body).to_json()
    assert list(got.items()) == list(want.items())  # key order included
    assert got["prewarm"] is body.get("prewarm", True)
    assert list(got)[-2:] == ["mesh", "prewarm"]


def model_toml(models, prewarm=None, lora=(), state=()) -> str:
    lines = ["[model]", 'name = "tiny.st"', f'path = "{models}"',
             "max_batch = 2", "token_chunk_size = 16"]
    if prewarm is not None:
        lines.append(f"prewarm = {'true' if prewarm else 'false'}")
    for entry in lora:
        lines += ["", "[[lora]]"] + [f"{k} = {json.dumps(v)}"
                                     for k, v in entry.items()]
    for entry in state:
        lines += ["", "[[state]]"] + [f"{k} = {json.dumps(v)}"
                                      for k, v in entry.items()]
    lines += ["", "[tokenizer]", 'path = "vocab.json"', ""]
    return "\n".join(lines)


@pytest.mark.parametrize("prewarm", [None, True, False])
def test_model_prewarm_toml_round_trip(tmp_path, prewarm):
    toml = tmp_path / "Config.toml"
    toml.write_text(model_toml("models", prewarm))
    got = TConfig.from_toml(str(toml)).to_reload_request()
    want = JConfig.from_toml(str(toml)).to_reload_request()
    assert got.to_json() == want.to_json()
    assert got.prewarm is (prewarm is not False)
    again = tmp_path / "Again.toml"
    again.write_text(dump_toml(TConfig.from_toml(str(toml)).to_dict()))
    assert TConfig.from_toml(str(again)).to_reload_request().to_json() \
        == got.to_json()


def test_relative_lora_and_state_paths_equal_jax(tmp_path, monkeypatch):
    """Entries under the model directory given relative to it, one given
    relative to the working directory (it exists as given) and one
    absolute: the port's request names the files the JAX one names, with
    ``alpha`` (default 1.0) on every LoRA entry."""
    monkeypatch.chdir(tmp_path)
    models = tmp_path / "models"
    (models / "sub").mkdir(parents=True)
    for name in ("a.lora", "b.lora", "s.state", "sub/t.state"):
        (models / name).write_bytes(b"x")
    toml = tmp_path / "Config.toml"
    toml.write_text(model_toml(
        "models", lora=[{"path": "a.lora"},
                        {"path": "models/b.lora", "alpha": 0.25}],
        state=[{"path": "s.state", "name": "s", "default": True},
               {"path": str(models / "sub" / "t.state"), "id": "t"}]))
    got = TConfig.from_toml(str(toml)).to_reload_request().to_json()
    want = JConfig.from_toml(str(toml)).to_reload_request().to_json()
    assert got == want
    assert got["lora"] == [{"path": "models/a.lora", "alpha": 1.0},
                           {"path": "models/b.lora", "alpha": 0.25}]
    assert got["state"][0]["path"] == "models/s.state"
    assert got["prewarm"] is True


# -- the engine -----------------------------------------------------------


def clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree


def assert_bit_equal(got, want, where="pools"):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_bit_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_equal(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def pools(eng):
    """Every pool, host flag and the snapshot ring of ``eng`` (of each rank
    of a mesh engine), cloned."""
    if hasattr(eng, "shards"):
        return [pools(s) for s in eng.shards]
    return clone({
        "state": eng.state_pool, "sampler": eng.sampler_state,
        "bias": eng.bias_pool, "mask": eng.mask_pool,
        "dfa_pool": eng.dfa_pool, "dfa_state": eng.dfa_state,
        "hsum": eng.hsum_pool, "bias_active": eng.bias_active,
        "mask_active": eng.mask_active, "dfa_rows": eng.dfa_rows,
        "hsum_rows": eng.hsum_rows, "ring": eng._chunk_snaps})


def fill_rows(eng, seed=3):
    """Random states in every row (row 1 with its hidden sums tracked),
    nucleus samplers with penalties, a bias, a mask and a token DFA, then a
    prefill step and two decode chunks: pools and a ring worth keeping."""
    rng = np.random.default_rng(seed)
    n, V = eng.max_batch, eng.vocab
    for b in range(n):
        row = {k: (rng.standard_normal(tuple(v.shape)) * 0.5).astype(
                   np.float32) for k, v in eng.fresh_row_state().items()}
        eng.load_row_state(b, row, hidden_sums=(b % 4 == 1))
        eng.set_row_sampler(b, NUCLEUS, prompt_tokens=[1 + b, 5, 7])
    eng.set_row_bias(2 % n, rng.standard_normal(V).astype(np.float32))
    allowed = rng.random(V) < 0.5
    allowed[1:4] = True
    eng.set_row_mask(3 % n, allowed)
    table = np.full((3, V), -1, np.int8)
    table[0, 1:6], table[1, 6:12] = 1, 0
    eng.set_row_dfa(0, table, 0)
    toks = rng.integers(1, V, (n, CHUNK)).astype(np.int32)
    lens = np.array([CHUNK, 3, 0, 5, 8, 2, 7, 1][:n], np.int32)
    res = eng.step(toks, lens, lens > 0, want_logits=True)
    active = lens > 0
    seq, _ = eng.decode_chunk(res.tokens, active, 3)
    eng.decode_chunk(torch.from_numpy(seq[-1].copy()), active, 2)


def tiny(version="V7", seed=70, **shape):
    info, _, params = make_tiny_model(ModelVersion(version), seed=seed,
                                      dtype=np.float32, num_vocab=64, **shape)
    return info, params


def t_engine(info, params, max_batch=B):
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return TEngine(TLoaded(info=info, params=tparams), max_batch=max_batch,
                   token_chunk_size=CHUNK, device="cpu")


@pytest.mark.parametrize("version", ["V7", "V6", "V4"])
def test_prewarm_leaves_every_pool_and_the_ring_bit_equal(version):
    """v7 and v6 at head size 4 (not one the WKV kernels take: N % 8 == 0,
    8 <= N <= 128) take the layer path at every T; v4 takes its fused T=1
    step (the kernels' plain versions on the CPU)."""
    eng = t_engine(*tiny(version, head_size=4))
    assert (eng.stack is None) == (version != "V4")
    fill_rows(eng)
    assert len(eng._chunk_snaps) == 2 and eng.hsum_rows.any()
    before = pools(eng)
    eng.prewarm(decode_chunk_size=4)
    assert_bit_equal(pools(eng), before)
    # decode_chunk(snapshot=False) alone: the ring stays as it was.
    eng.decode_chunk(np.zeros(B, np.int32), np.zeros(B, np.bool_), 5,
                     snapshot=False)
    assert_bit_equal(pools(eng), before)


def test_prewarm_preserves_chunk_snapshots():
    """Port of the JAX ``tests/test_drain.py``
    ``test_prewarm_preserves_chunk_snapshots``: after a real decode chunk
    a prewarm runs, and ``restore_last_chunk`` still brings back the real
    pre-chunk state."""
    info, params = tiny(seed=11)
    eng = t_engine(info, params, max_batch=2)
    toks = np.zeros((2, 4), np.int32)
    toks[0] = [1, 2, 3, 4]
    eng.step(toks, np.array([4, 0], np.int32), np.zeros(2, np.bool_), False)
    pre = eng.read_row_state(0)
    active = np.array([True, False])
    eng.decode_chunk(np.array([5, 0], np.int32), active, steps=4)
    assert len(eng._chunk_snaps) == 1
    eng.prewarm(decode_chunk_size=4)
    assert len(eng._chunk_snaps) == 1
    eng.restore_last_chunk()
    post = eng.read_row_state(0)
    for k in pre:
        np.testing.assert_array_equal(post[k], pre[k])


def greedy_run(eng, prewarm_at=None):
    """A ragged prefill, then a 5-token chunk with an idle row and budgets;
    ``prewarm_at`` "start" or "between" runs a prewarm before the prefill
    or between it and the chunk.  Returns (step tokens, chunk tokens, row
    states)."""
    if prewarm_at == "start":
        eng.prewarm(decode_chunk_size=2)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 8, []]
    for b in range(B):
        eng.load_row_state(b, None)
        eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
    toks = np.zeros((B, CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    res = eng.step(toks, lens, lens > 0)
    if prewarm_at == "between":
        eng.prewarm(decode_chunk_size=2)
    budget = np.array([5, 2, 5, 5], np.int32)
    seq, _ = eng.decode_chunk(res.tokens, lens > 0, 5, budget=budget)
    states = [{k: np.asarray(v) for k, v in eng.read_row_state(b).items()}
              for b in range(B)]
    return np.asarray(res.tokens), np.asarray(seq), states


@pytest.mark.parametrize("prewarm_at", ["start", "between"])
def test_greedy_after_prewarm_equals_without_and_jax(prewarm_at):
    info, params = tiny()
    got = greedy_run(t_engine(info, params), prewarm_at)
    plain = greedy_run(t_engine(info, params))
    for g, p in zip(got[:2], plain[:2]):
        np.testing.assert_array_equal(g, p)
    assert_bit_equal(got[2], plain[2], "states")
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK,
                state_dtype=jnp.float32)
    want = greedy_run(j)
    active = np.array([True, True, True, False])
    np.testing.assert_array_equal(got[0][active], want[0][active])
    np.testing.assert_array_equal(got[1][:, active], want[1][:, active])
    for g, w in zip(got[2], want[2]):
        for k in w:
            close(g[k], w[k])


def test_mesh_engine_prewarm():
    """``MeshEngine.prewarm`` on a CPU (2, 2) mesh: every rank's pools and
    ring bit-equal, and a run after it equal to one without it."""
    info, jparams = model_inputs("plain")
    eng = port_engine(info, jparams, cpu_mesh(2, 2))
    fill_rows(eng)
    before = pools(eng)
    eng.prewarm(decode_chunk_size=2)
    assert_bit_equal(pools(eng), before)
    warmed = port_engine(info, jparams, cpu_mesh(2, 2))
    warmed.prewarm(decode_chunk_size=2)
    got = drive(warmed)
    want = drive(port_engine(info, jparams, cpu_mesh(2, 2)))
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))
    assert_bit_equal(clone(got[4]), clone(want[4]), "states")


def test_cancel_prewarm_stops_between_buckets(monkeypatch):
    info, params = tiny()
    eng = t_engine(info, params)
    calls = []
    step = eng.step

    def counted(*args, **kw):
        calls.append(args[0].shape)
        if len(calls) == 2:
            eng.cancel_prewarm()
        return step(*args, **kw)

    monkeypatch.setattr(eng, "step", counted)
    eng.prewarm(decode_chunk_size=4)
    assert calls == [(B, CHUNK), (B, CHUNK)]
    calls.clear()
    eng.prewarm(decode_chunk_size=4)  # a new prewarm starts afresh
    assert calls == [(B, CHUNK), (B, CHUNK)]


# -- the middleware -------------------------------------------------------


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    root = tmp_path_factory.mktemp("prewarm_site")
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=11, dtype=np.float32,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw), str(root / "tiny.st"),
                             dtype=np.float32)
    (root / "vocab.json").write_text(json.dumps(VOCAB))
    return root


def reload_request(site, cls=TRequest, **kw):
    return cls(model_path=str(site / "tiny.st"),
               tokenizer_path=str(site / "vocab.json"), precision="Fp32",
               max_batch=2, token_chunk_size=8, decode_chunk_size=4, **kw)


@pytest.mark.parametrize("prewarm", [True, False])
def test_middleware_prewarm_future(site, prewarm):
    async def main():
        mw = TMiddleware(device="cpu")
        assert not mw.loaded
        await mw.reload(reload_request(site, prewarm=prewarm))
        assert mw.loaded
        future = mw.env.prewarm_future
        if prewarm:
            assert future is not None
            assert await future is None
        else:
            assert future is None
        info = mw.info()
        await mw.unload()
        assert not mw.loaded
        return info

    info = asyncio.run(main())
    assert info["reload"]["prewarm"] is prewarm


def test_models_info_reload_carries_prewarm(site):
    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        toml = site / "Info.toml"
        toml.write_text(model_toml(site, prewarm=False).replace(
            'path = "vocab.json"', f'path = "{site / "vocab.json"}"'))
        config = TConfig.from_toml(str(toml))
        server = Server(config, device="cpu")
        await server.middleware.reload(config.to_reload_request())
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            r = await client.get("/api/models/info")
            return await r.json()
        finally:
            await client.close()
            await server.middleware.unload()

    body = asyncio.run(main())
    assert body["reload"]["prewarm"] is False
    assert list(body["reload"]) == list(JRequest().to_json())


@pytest.mark.parametrize("saved", ["with-key", "without-key"])
def test_prefab_saved_request_carries_prewarm(site, tmp_path, saved):
    """``Middleware.save`` writes the request with ``prewarm``; a prefab
    whose request lacks the key reads back (and loads) with the default,
    true, as the JAX ``ReloadRequest`` reads it."""
    path = tmp_path / "tiny.prefab"

    async def main():
        mw = TMiddleware(device="cpu")
        await mw.reload(reload_request(site, prewarm=False))
        if saved == "with-key":
            await mw.save(str(path))
        else:
            config = {k: v for k, v in mw.env.reload.to_json().items()
                      if k != "prewarm"}
            tprefab.save_prefab(str(path), mw.env.model, config)
        await mw.unload()
        with safe_open(str(path), framework="numpy") as f:
            config = json.loads(f.metadata()["prefab"])["config"]
        await mw.reload(TRequest.from_json({**config,
                                            "model_path": str(path)}))
        future = mw.env.prewarm_future
        if future is not None:
            await future
        await mw.unload()
        return config, future

    config, future = asyncio.run(main())
    assert ("prewarm" in config) == (saved == "with-key")
    got = TRequest.from_json(config).to_json()
    assert got == JRequest.from_json(config).to_json()
    assert got["prewarm"] is (saved == "without-key")
    assert (future is not None) == (saved == "without-key")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_unload_drain_is_bounded(site, monkeypatch, caplog, package):
    """A prewarm held in flight: the unload cancels it, waits
    ``AI00_PREWARM_DRAIN_S`` = 0.2 s, warns and returns."""
    release = threading.Event()
    seen = {}

    def held(engine, decode_chunk_size=8):
        seen["started"] = True
        release.wait(60)
        seen["cancelled"] = engine._prewarm_cancelled

    if package == "port":
        monkeypatch.setattr(tengine_mod, "run_prewarm", held)
        mw, req = TMiddleware(device="cpu"), reload_request(site)
    else:
        monkeypatch.setattr(jengine_mod.Engine, "prewarm", held)
        mw, req = JMiddleware(), reload_request(site, JRequest)
    monkeypatch.setenv("AI00_PREWARM_DRAIN_S", "0.2")
    caplog.set_level(logging.WARNING)

    async def main():
        await mw.reload(req)
        future = mw.env.prewarm_future
        while not seen.get("started"):
            await asyncio.sleep(0.01)
        t0 = time.monotonic()
        await mw.unload()
        elapsed = time.monotonic() - t0
        in_flight = not future.done()
        release.set()
        await future
        return elapsed, in_flight

    try:
        elapsed, in_flight = asyncio.run(main())
    finally:
        release.set()
    assert in_flight and seen["cancelled"] is True
    assert 0.2 <= elapsed < 10
    assert any("prewarm" in r.getMessage() and r.levelno == logging.WARNING
               for r in caplog.records)


def test_prewarm_that_raises_is_logged(site, monkeypatch, caplog):
    def broken(engine, decode_chunk_size=8):
        raise RuntimeError("prewarm broke")

    monkeypatch.setattr(tengine_mod, "run_prewarm", broken)
    caplog.set_level(logging.ERROR)

    async def main():
        mw = TMiddleware(device="cpu")
        await mw.reload(reload_request(site))
        future = mw.env.prewarm_future
        with pytest.raises(RuntimeError, match="prewarm broke"):
            await future
        await asyncio.sleep(0)  # the done-callback runs
        await mw.unload()  # the failure does not stop the unload

    asyncio.run(main())
    logged = [r for r in caplog.records if r.levelno == logging.ERROR
              and r.name == "ai00_server_tpu_torch.middleware"]
    assert len(logged) == 1 and logged[0].exc_info is not None
    assert "prewarm broke" in str(logged[0].exc_info[1])


def test_request_during_prewarm_equals_without():
    """Prewarms run back to back on another thread while the runtime
    serves a greedy request with 4-token chunks: the same text as without
    them, and the snapshot ring still serves the chunk rollbacks."""
    info, params = tiny(seed=11)
    tok = Tokenizer({i: bytes([64 + i]) for i in range(1, 60)})

    async def serve(with_prewarm):
        eng = t_engine(info, params, max_batch=2)
        rt = Runtime(eng, tok, decode_chunk_size=4)
        rt.start()
        stop, rounds = threading.Event(), [0]

        def prewarms():
            while not stop.is_set():
                eng.prewarm(decode_chunk_size=4)
                rounds[0] += 1

        worker = threading.Thread(target=prewarms)
        if with_prewarm:
            worker.start()
        try:
            handles = [await rt.submit(GenerateRequest(
                prompt=prompt, max_tokens=n, bias={0: -1e4},
                sampler=SamplerSpec(kind=sampling.KIND_GREEDY,
                                    presence_penalty=0.0,
                                    frequency_penalty=0.0)))
                for prompt, n in (("ABCAB", 23), ("CAB", 9))]
            texts = []
            for handle in handles:
                parts = [m[1] async for m in handle if m[0] == "content"]
                texts.append("".join(parts))
        finally:
            stop.set()
            if with_prewarm:
                worker.join()
            await rt.stop()
        return texts, rounds[0]

    got, rounds = asyncio.run(serve(True))
    want, _ = asyncio.run(serve(False))
    assert rounds >= 1
    assert got == want and all(got)
