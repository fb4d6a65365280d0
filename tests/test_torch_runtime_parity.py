"""The port's runtime against the JAX package's in three behaviours the
reference holds with tests of its own, on the CPU with the same tiny f32
RWKV-7 (the JAX params carried across with ``params_from_numpy``):

* continue after generation (``tests/test_cache_consistency.py``): the
  slot's resident tokens are what the engine state consumed (its state
  equals a fresh replay of them, 1e-4 of scale + 1e-3 relative, as the
  reference holds), and a warm continuation from the resident state gives
  the text a fresh runtime gives, at ``decode_chunk_size`` 1 and 8; both
  packages produce the same greedy texts;
* drain (``tests/test_drain.py::test_stop_drains_inflight_and_pending``):
  ``Runtime.stop()`` ends two in-flight requests and one pending request
  with ABORT;
* reload in mid-stream
  (``test_reload_mid_stream_terminates_first_stream``): a reload during a
  live HTTP generation ends the first stream with ``finish_reason``
  "abort", and the reloaded model serves.

The port's ``_finalize`` queues ``done`` and then awaits the worker thread
before it records ``resident_tokens`` (the drive loop awaits it, so no
request is scheduled in that window); the tests wait for the slot to go
idle before they read it.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import get_version_module as jmodule
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.runtime import FinishReason as JFinish
from ai00_server_tpu.runtime import GenerateRequest as JRequest
from ai00_server_tpu.runtime import Runtime as JRuntime
from ai00_server_tpu.runtime import SamplerSpec as JSampler
from ai00_server_tpu.server.app import Server as JServer
from ai00_server_tpu.server.config import Config as JConfig
from ai00_server_tpu.testing import make_tiny_model
from ai00_server_tpu.tokenizer import Tokenizer as JTokenizer

from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import get_version_module as tmodule
from ai00_server_tpu_torch.ops import sampling as tsampling
from ai00_server_tpu_torch.runtime import FinishReason as TFinish
from ai00_server_tpu_torch.runtime import GenerateRequest as TRequest
from ai00_server_tpu_torch.runtime import Runtime as TRuntime
from ai00_server_tpu_torch.runtime import SamplerSpec as TSampler
from ai00_server_tpu_torch.server.app import Server as TServer
from ai00_server_tpu_torch.server.config import Config as TConfig
from ai00_server_tpu_torch.tokenizer import Tokenizer as TTokenizer

from test_loader import to_converted_layout

# The two packages' runtime pieces, by name.
JAX = {"engine": lambda m, b: JEngine(JLoaded(info=m[0], params=m[1],
                                              init_wkv=None),
                                      max_batch=b, token_chunk_size=8,
                                      state_dtype=jnp.float32),
       "runtime": JRuntime, "request": JRequest, "tokenizer": JTokenizer,
       "sampler": lambda: JSampler(kind=jsampling.KIND_GREEDY,
                                   presence_penalty=0.0,
                                   frequency_penalty=0.0),
       "abort": JFinish.ABORT}
PORT = {"engine": lambda m, b: TEngine(TLoaded(info=m[0], params=m[2]),
                                       max_batch=b, token_chunk_size=8,
                                       device="cpu"),
        "runtime": TRuntime, "request": TRequest, "tokenizer": TTokenizer,
        "sampler": lambda: TSampler(kind=tsampling.KIND_GREEDY,
                                    presence_penalty=0.0,
                                    frequency_penalty=0.0),
        "abort": TFinish.ABORT}


def tiny_model(seed):
    """(info, JAX params, port params) of one tiny f32 v7."""
    info, _, params = make_tiny_model(ModelVersion.V7, seed=seed,
                                      dtype=np.float32, num_vocab=64)
    return info, params, params_from_numpy(jax.tree.map(np.asarray, params),
                                           "cpu")


async def generate(pkg, rt, prompt, n):
    handle = await rt.submit(pkg["request"](
        prompt=prompt, max_tokens=n, sampler=pkg["sampler"]()))
    parts = []
    async for msg in handle:
        if msg[0] == "content":
            parts.append(msg[1])
    return "".join(parts)


async def idle(rt, slot=0):
    """Wait until ``slot`` has finished (its resident tokens recorded)."""
    for _ in range(2000):
        if rt.slots[slot].ctx is None:
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the slot never went idle")


def replayed_state(pkg, model, tokens):
    """A fresh state after ``tokens`` (batch 1), as numpy."""
    info = model[0]
    toks = np.asarray(tokens, np.int32)[None]
    if pkg is JAX:
        m = jmodule(info.version)
        state = m.init_state(info, 1, jnp.float32)
        _, state = jax.jit(m.forward)(model[1], state, jnp.asarray(toks),
                                      jnp.asarray([len(tokens)], np.int32))
        return {k: np.asarray(v) for k, v in state.items()}
    m = tmodule(info.version)
    state = m.init_state(info, 1, torch.float32)
    _, state = m.forward(model[2], state, torch.from_numpy(toks).long(),
                         torch.tensor([len(tokens)]))
    return {k: v.numpy() for k, v in state.items()}


PROMPT = "<ABCABCABCABCABCABCABCABCABCABCABCA"  # 36 chars, >= 32 tokens


def continue_case(pkg, model, decode_chunk_size):
    # Every sampleable id 1..63 decodes to one char: text maps 1:1 to
    # tokens.
    tok = pkg["tokenizer"]({i: bytes([59 + i]) for i in range(1, 64)})
    assert len(tok.encode(PROMPT)) >= 32

    def make_rt():
        return pkg["runtime"](pkg["engine"](model, 1), tok,
                              decode_chunk_size=decode_chunk_size)

    async def main():
        rt = make_rt()
        rt.start()
        t1 = await generate(pkg, rt, PROMPT, 4)
        await idle(rt)
        resident = rt.slots[0].resident_tokens
        now = rt.engine.read_row_state(0)
        replay = replayed_state(pkg, model, resident)
        for k in replay:
            np.testing.assert_allclose(
                np.asarray(now[k]), replay[k], atol=1e-4, rtol=1e-3,
                err_msg=f"resident tokens do not match engine state ({k})")
        cont = PROMPT + t1 + "AB"
        warm = await generate(pkg, rt, cont, 4)
        await rt.stop()
        rt2 = make_rt()
        rt2.start()
        fresh = await generate(pkg, rt2, cont, 4)
        await rt2.stop()
        return t1, warm, fresh

    return asyncio.run(main())


@pytest.fixture(scope="module")
def model90():
    return tiny_model(90)


@pytest.mark.parametrize("decode_chunk_size", [1, 8])
def test_continue_after_generation_equals_jax(model90, decode_chunk_size):
    t1, warm, fresh = continue_case(PORT, model90, decode_chunk_size)
    assert len(t1) == 4  # every sampled id decodes to a char
    assert warm == fresh
    assert (t1, warm) == continue_case(JAX, model90, decode_chunk_size)[:2]


async def final_reason(handle):
    reason = None
    async for msg in handle:
        if msg[0] == "stop":
            reason = msg[1]
    return reason


def drain_case(pkg, model):
    tok = pkg["tokenizer"]({i: bytes([64 + i]) for i in range(1, 60)})

    async def main():
        rt = pkg["runtime"](pkg["engine"](model, 2), tok,
                            decode_chunk_size=4)
        rt.start()
        # Two long generations fill both slots; a third waits as pending.
        handles = [await rt.submit(pkg["request"](
            prompt="ABCD", max_tokens=10_000, sampler=pkg["sampler"]()))
            for _ in range(3)]
        got = 0
        async for msg in handles[0]:  # decoding has begun
            if msg[0] == "content":
                got += 1
                if got >= 2:
                    break
        stop = asyncio.create_task(rt.stop())
        results = [await asyncio.wait_for(final_reason(h), timeout=60)
                   for h in handles]
        await stop
        return results

    return asyncio.run(main())


def test_stop_drains_inflight_and_pending_equals_jax():
    model = tiny_model(11)
    assert drain_case(PORT, model) == [PORT["abort"]] * 3
    assert drain_case(JAX, model) == [JAX["abort"]] * 3


def write_site(root):
    models = root / "assets" / "models"
    tok_dir = root / "assets" / "tokenizer"
    cfg_dir = root / "assets" / "configs"
    for d in (models, tok_dir, cfg_dir):
        d.mkdir(parents=True)
    _, raw, _ = make_tiny_model(ModelVersion.V7, seed=3, dtype=np.float32,
                                num_vocab=64)
    jloader.save_safetensors(to_converted_layout(raw),
                             str(models / "tiny.st"), dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (cfg_dir / "Config.toml").write_text(f"""
[model]
name = "tiny.st"
path = "{models}"
max_batch = 2
token_chunk_size = 16

[tokenizer]
path = "{tok_dir / 'vocab.json'}"

[listen]
port = 0
""")
    return cfg_dir / "Config.toml"


def reload_case(toml, server_cls, config_cls, **kw):
    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        config = config_cls.from_toml(str(toml))
        server = server_cls(config, **kw)
        reload_req = config.to_reload_request(sandbox=False)
        if hasattr(reload_req, "prewarm"):
            reload_req.prewarm = False
        await server.middleware.reload(reload_req)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            # Random weights: end-of-text is kept out of the greedy picks,
            # so only the reload can end this stream.
            long_task = asyncio.create_task(client.post(
                "/api/oai/completions",
                json={"prompt": "ABCAB", "max_tokens": 100_000,
                      "sampler": {"type": "Nucleus", "top_k": 1},
                      "logit_bias": {"0": -1e4}}))
            await asyncio.sleep(1.0)  # let it start decoding
            await server.middleware.reload(reload_req)
            r1 = await asyncio.wait_for(long_task, timeout=120)
            body1 = await r1.json()
            r2 = await client.post(
                "/api/oai/completions",
                json={"prompt": "AB", "max_tokens": 4,
                      "sampler": {"type": "Nucleus", "top_k": 1}})
            body2 = await r2.json()
            return body1, body2
        finally:
            await client.close()
            await server.middleware.unload()

    body1, body2 = asyncio.run(main())
    return (body1["choices"][0]["finish_reason"],
            body2["choices"][0]["finish_reason"])


def test_reload_mid_stream_terminates_first_stream_equals_jax(tmp_path):
    toml = write_site(tmp_path)
    first, second = reload_case(toml, TServer, TConfig, device="cpu")
    assert first == "abort" and second in ("length", "stop")
    assert reload_case(toml, JServer, JConfig)[0] == "abort"
