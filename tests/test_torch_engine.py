"""The port's Engine against the JAX package's Engine, greedy.

Both engines hold the same tiny f32 v7 (the JAX params carried across with
``params_from_numpy``) and get the same calls: a ragged merged prefill
step, a K-token ``decode_chunk`` with per-row budgets and an inactive row,
then ``rollback_row``.  Greedy tokens must be equal; row states agree to
2e-4 of their scale (f32, different summation order, as in
test_torch_models_v7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

B, CHUNK = 4, 8
GREEDY = {"kind": jsampling.KIND_GREEDY, "presence": 0.3, "frequency": 0.3}


def close(got, want, rtol=2e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture()
def engines():
    info, _, params = make_tiny_model(ModelVersion.V7, seed=70,
                                      dtype=np.float32, num_vocab=64)
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    t = TEngine(TLoaded(info=info, params=tparams), max_batch=B,
                token_chunk_size=CHUNK, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 8, []]
    for eng in (j, t):
        for b in range(B):
            eng.load_row_state(b, None)
            eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
            eng.set_row_bias(b, None)
    eng_bias = np.zeros(64, np.float32)
    eng_bias[5] = 2.0
    j.set_row_bias(1, eng_bias)
    t.set_row_bias(1, eng_bias)
    return j, t, prompts


def _prefill(eng, prompts):
    toks = np.zeros((B, CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    return eng.step(toks, lens, lens > 0).tokens


def _states_close(j, t):
    for b in range(B):
        jr, tr = j.read_row_state(b), t.read_row_state(b)
        for k in jr:
            close(tr[k], jr[k])


def test_step_and_decode_chunk_equal_jax(engines):
    j, t, prompts = engines
    jf, tf = _prefill(j, prompts), _prefill(t, prompts)
    np.testing.assert_array_equal(tf[:3], jf[:3])
    _states_close(j, t)

    active = np.array([True, True, True, False])
    budget = np.array([6, 6, 3, 0], np.int32)
    jt, _ = j.decode_chunk(jf, active, 6, budget=budget)
    tt, _ = t.decode_chunk(tf, active, 6, budget=budget)
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    # Row 2 froze after its budget of 3; the idle row never moved.
    assert (tt[3:, 2] == tt[2, 2]).all()
    _states_close(j, t)
    assert float(np.abs(t.read_row_state(3)["wkv"]).max()) == 0.0

    # A speculative successor chained from the device-resident tokens.
    hf = (np.array([False, False, False, True]), np.array([0, 0, 0, 9]))
    active = np.ones(B, np.bool_)
    jt2, _ = j.decode_chunk(jnp.asarray(jt[-1]), active, 4, host_first=hf)
    tt2, _ = t.decode_chunk(torch.from_numpy(tt[-1]), active, 4,
                            host_first=hf)
    np.testing.assert_array_equal(tt2, jt2)
    _states_close(j, t)


def test_rollback_row_equals_jax(engines):
    j, t, prompts = engines
    jf, tf = _prefill(j, prompts), _prefill(t, prompts)
    active = np.array([True, True, True, False])
    jt, _ = j.decode_chunk(jf, active, 5)
    tt, _ = t.decode_chunk(tf, active, 5)
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    # Row 0 stopped after its second token: restore it to the pre-chunk
    # state and re-feed the two tokens the request consumed.
    feed = [int(tf[0]), int(tt[0, 0])]
    j.rollback_row(0, feed)
    t.rollback_row(0, feed)
    _states_close(j, t)

    # Same state as feeding those two tokens one at a time.
    t2 = TEngine(t.model, max_batch=B, token_chunk_size=CHUNK, device="cpu")
    for b in range(B):
        t2.load_row_state(b, None)
        t2.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
    _prefill(t2, prompts)
    for tok in feed:
        toks = np.zeros((B, 1), np.int32)
        toks[0, 0] = tok
        t2.step(toks, np.array([1, 0, 0, 0], np.int32),
                np.zeros(B, np.bool_))
    for k, v in t2.read_row_state(0).items():
        close(t.read_row_state(0)[k], v, rtol=1e-5)

    # restore_last_chunk brings the whole pool back to its pre-chunk state.
    before = t.read_row_state(1)
    t.decode_chunk(tt[-1], active, 3)
    t.restore_last_chunk()
    for k, v in t.read_row_state(1).items():
        np.testing.assert_array_equal(v, before[k])


def test_runtime_keeps_requests_submitted_during_admission(engines):
    """A request submitted while the drive loop is suspended inside an
    admission (waiting on the engine thread) must still be served."""
    import asyncio
    import json as _json

    from ai00_server_tpu_torch.runtime import GenerateRequest, Runtime
    from ai00_server_tpu_torch.runtime import SamplerSpec
    from ai00_server_tpu_torch.tokenizer import Tokenizer

    _, t, _ = engines
    tok = Tokenizer.from_json(_json.dumps(
        {str(i): chr(64 + i) for i in range(1, 60)}))

    def req():
        return GenerateRequest(prompt="ABC", max_tokens=3, sampler=SamplerSpec(
            kind=jsampling.KIND_GREEDY))

    async def main():
        rt = Runtime(t, tok, decode_chunk_size=4)
        loop = asyncio.get_running_loop()
        late = []
        set_bias = t.set_row_bias

        def hooked(b, bias):
            if not late:  # first admission: submit another request now
                late.append(asyncio.run_coroutine_threadsafe(
                    rt.submit(req()), loop).result(timeout=10))
            set_bias(b, bias)

        t.set_row_bias = hooked
        rt.start()
        try:
            first = await rt.submit(req())
            done = []
            for h in (first, None):
                h = h or late[0]
                async for msg in h:
                    if msg[0] == "stop":
                        done.append(msg[1])
            assert len(done) == 2
        finally:
            t.set_row_bias = set_bias
            await rt.stop()

    asyncio.run(asyncio.wait_for(main(), timeout=60))


# ---------------------------------------------------------------------------
# The fused decode path: layout installed, pool updated in place
# ---------------------------------------------------------------------------


@pytest.fixture()
def fused_engines():
    """Both engines on a tiny f32 v7 with head size 64, the width the
    port's fused decode path takes."""
    info, _, params = make_tiny_model(ModelVersion.V7, seed=71,
                                      dtype=np.float32, num_layer=2,
                                      num_emb=128, head_size=64,
                                      num_vocab=64)
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    t = TEngine(TLoaded(info=info, params=tparams), max_batch=B,
                token_chunk_size=CHUNK, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 8, []]
    for eng in (j, t):
        for b in range(B):
            eng.load_row_state(b, None)
            eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
            eng.set_row_bias(b, None)
    return j, t, prompts


def test_engine_installs_the_fused_layout(fused_engines, engines):
    from ai00_server_tpu_torch.ops import v7_decode as fd

    _, t, _ = fused_engines
    assert fd.supports(t.model.params)
    layout = t.model.params[fd.FUSED_KEY]
    assert layout["Wr"][0] is t.model.params["layers"][0]["att"]["receptance"]
    assert t._graph is None  # a CUDA graph needs a CUDA device
    # Head size 16 is one the kernels take (N % 8 == 0, 8 <= N <= 128): that
    # model fuses too.
    assert fd.supports(engines[1].model.params)


def test_fused_engine_pool_keeps_its_addresses_and_equals_jax(
        fused_engines, monkeypatch):
    from ai00_server_tpu_torch.ops import v7_decode as fd

    j, t, prompts = fused_engines
    fused_steps = []
    real = fd.forward_t1
    monkeypatch.setattr(fd, "forward_t1",
                        lambda *a: fused_steps.append(1) or real(*a))
    ptrs = {k: (id(v), v.data_ptr()) for k, v in t.state_pool.items()}

    def same_pool():
        return all((id(v), v.data_ptr()) == ptrs[k]
                   for k, v in t.state_pool.items())

    jf, tf = _prefill(j, prompts), _prefill(t, prompts)   # T > 1
    assert same_pool() and not fused_steps
    np.testing.assert_array_equal(tf[:3], jf[:3])
    _states_close(j, t)

    one = np.zeros((B, 1), np.int32)                       # T = 1 step
    one[:3, 0] = tf[:3]
    lens = np.array([1, 1, 1, 0], np.int32)
    js, ts = j.step(one, lens, lens > 0), t.step(one, lens, lens > 0)
    assert same_pool() and len(fused_steps) == 1
    np.testing.assert_array_equal(ts.tokens[:3], js.tokens[:3])

    active = np.array([True, True, True, False])
    budget = np.array([5, 5, 2, 0], np.int32)
    before = t.read_row_state(1)
    jt, _ = j.decode_chunk(js.tokens, active, 5, budget=budget)
    tt, _ = t.decode_chunk(ts.tokens, active, 5, budget=budget)
    assert same_pool() and len(fused_steps) == 6
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    _states_close(j, t)
    assert float(np.abs(t.read_row_state(3)["wkv"]).max()) == 0.0

    feed = [int(ts.tokens[0]), int(tt[0, 0])]
    j.rollback_row(0, feed)
    t.rollback_row(0, feed)
    assert same_pool()
    _states_close(j, t)

    t.decode_chunk(tt[-1], active, 3)
    t.restore_last_chunk()
    assert same_pool()
    _states_close(j, t)  # the speculative chunk left no trace
    t.restore_last_chunk()  # and the chunk before it: back to `before`
    assert same_pool()
    for k, v in t.read_row_state(1).items():
        np.testing.assert_array_equal(v, before[k])


# ---------------------------------------------------------------------------
# Int8 models: the int8 LM head, the fused int8 path, the mixed layer path
# ---------------------------------------------------------------------------
#
# The JAX engine quantizes the head only on a TPU unless AI00_QUANT_HEAD=on
# (set here for the JAX side alone), and off the TPU its ``head_logits``
# casts x to bf16 and dequantizes to bf16 whatever the model's dtype.  The
# port's head follows the Pallas kernel instead (operands in x's dtype, f32
# sums), so:
#
# * ``head_logits`` is held against ``quant_pallas.matmul_int8(...,
#   out_dtype=f32, interpret=True)`` on the same ``_head_q``: 2e-5 of scale
#   (the sums' order);
# * the two engines run f32 models end to end from the same codes (the JAX
#   engine's params, ``_head_q`` included, carried across): the logits
#   differ by the JAX side's bf16 rounding of x and of the head (a few
#   2^-9), the greedy tokens are equal because the top two logits are
#   further apart than that (asserted), and the states agree to 2e-4.

QUANT_CASES = {"int8": {0: "int8", 1: "int8"}, "mixed": {0: "int8"},
               # 4-bit: packed codes on both sides (off its own device the
               # JAX engine keeps them packed, no int8 surrogate).
               "nf4": {0: "nf4", 1: "nf4"}, "int4": {0: "int4", 1: "int4"},
               "sf4": {0: "sf4", 1: "sf4"}, "mixed-sf4": {0: "sf4"}}


def _quant_engines(monkeypatch, case):
    from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

    monkeypatch.setenv("AI00_QUANT_HEAD", "on")
    info = tiny_info(ModelVersion.V7, num_layer=2, num_emb=128, head_size=64,
                     num_vocab=64)
    raw = make_raw_weights(info, seed=72, dtype=np.float32)
    params = make_params(info, raw, dtype=np.float32,
                         quant=QUANT_CASES[case])
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK)
    assert "_head_q" in j.model.params and "head" not in j.model.params
    tparams = params_from_numpy(jax.tree.map(np.asarray, j.model.params),
                                "cpu")
    t = TEngine(TLoaded(info=info, params=tparams), max_batch=B,
                token_chunk_size=CHUNK, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 8, []]
    for eng in (j, t):
        for b in range(B):
            eng.load_row_state(b, None)
            eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
            eng.set_row_bias(b, None)
    return j, t, prompts, raw


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_engine_equals_jax(monkeypatch, case):
    from ai00_server_tpu_torch.ops import v7_decode as fd

    j, t, prompts, _ = _quant_engines(monkeypatch, case)
    hq, jhq = t.model.params["_head_q"], j.model.params["_head_q"]
    np.testing.assert_array_equal(hq.q.numpy(), np.asarray(jhq.q))
    np.testing.assert_array_equal(hq.scale.numpy(), np.asarray(jhq.scale))
    assert "head" not in t.model.params
    # A uniform mode takes the fused path; a mixed model keeps to the layers.
    fused = not case.startswith("mixed")
    assert fd.supports(t.model.params) == fused
    mode = QUANT_CASES[case][0]
    assert t.model.params["layers"][0]["ffn"]["key"].mode == mode
    assert hq.mode == "int8"  # the head is int8 whatever the layers' mode
    assert t._graph is None
    fused_steps = []
    real = fd.forward_t1
    monkeypatch.setattr(fd, "forward_t1",
                        lambda *a: fused_steps.append(1) or real(*a))

    toks = np.zeros((B, CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    js = j.step(toks, lens, lens > 0, want_logits=True)
    ts = t.step(toks, lens, lens > 0, want_logits=True)
    jl, tl = np.asarray(js.logits)[:3], ts.logits.numpy()[:3]
    gap = np.sort(tl, axis=-1)
    gap = float((gap[:, -1] - gap[:, -2]).min())
    assert float(np.abs(tl - jl).max()) <= 2.0 ** -6 * float(np.abs(jl).max())
    assert gap > 4 * float(np.abs(tl - jl).max())  # well separated
    np.testing.assert_array_equal(ts.tokens[:3], js.tokens[:3])
    _states_close(j, t)
    assert not fused_steps

    active = np.array([True, True, True, False])
    budget = np.array([5, 5, 2, 0], np.int32)
    jt, _ = j.decode_chunk(js.tokens, active, 5, budget=budget)
    tt, _ = t.decode_chunk(ts.tokens, active, 5, budget=budget)
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    _states_close(j, t)
    assert len(fused_steps) == (5 if fused else 0)
    assert float(np.abs(t.read_row_state(3)["wkv"]).max()) == 0.0

    feed = [int(ts.tokens[0]), int(tt[0, 0])]
    j.rollback_row(0, feed)
    t.rollback_row(0, feed)
    _states_close(j, t)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_int8_head_logits_equal_pallas_kernel(monkeypatch, name):
    from ai00_server_tpu.ops import quant_pallas

    from ai00_server_tpu_torch.engine import head_logits

    _, t, _, _ = _quant_engines(monkeypatch, "int8")
    hq = t.model.params["_head_q"]
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((3, 128)), jdt)
    want = quant_pallas.matmul_int8(
        x, jnp.asarray(hq.q.numpy()), jnp.asarray(hq.scale.numpy()),
        out_dtype=jnp.float32, interpret=True)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32)))
    got = head_logits(t.model.params, tx if name == "float32"
                      else tx.bfloat16())
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    close(got.numpy(), want, rtol=2e-5)


def test_engine_quantizes_its_own_head_like_the_reference(monkeypatch):
    """A port-loaded int8 model (no ``_head_q`` carried across): the engine
    quantizes the head on its device to the reference quantizer's codes and
    drops the plain head; a plain model keeps its head."""
    from ai00_server_tpu.ops import quant as jquant

    from ai00_server_tpu_torch.testing import make_params as tmake
    from ai00_server_tpu_torch.testing import tiny_info as ttiny

    _, _, _, raw = _quant_engines(monkeypatch, "int8")
    info = ttiny(num_layer=2, num_emb=128, head_size=64, num_vocab=64)
    for quant_map in (QUANT_CASES["mixed"], None):
        params = tmake(info, raw, torch.bfloat16, quant=quant_map)
        head = params["head"].clone()
        TEngine(TLoaded(info=info, params=params), max_batch=2,
                token_chunk_size=CHUNK, device="cpu")
        if quant_map is None:
            assert "_head_q" not in params and "head" in params
            continue
        want = jquant.quantize_int8(head.float().numpy())
        assert "head" not in params
        np.testing.assert_array_equal(params["_head_q"].q.numpy(),
                                      np.asarray(want.q))
        np.testing.assert_array_equal(params["_head_q"].scale.numpy(),
                                      np.asarray(want.scale))


# ---------------------------------------------------------------------------
# RWKV-6: the same engine, unchanged, on v6 models
# ---------------------------------------------------------------------------
#
# Tiny f32 v6 models through both engines, as above: head size 4 (not one
# the WKV kernels take: N % 8 == 0, 8 <= N <= 128) keeps to the layer path (``wkv56_chunk`` / ``wkv56_t1``'s plain versions), head
# size 64 takes the fused v6 path for T=1 (``ops/v6_decode``), all-int8 and
# all-nf4 models the fused path on codes, a layer-0-int8 model the layer
# path with ``matmul_int8_l``.  Quantized models get the int8 LM head on
# both sides (``AI00_QUANT_HEAD=on`` for the JAX engine), with the logits'
# tolerance of the int8 cases above.  Greedy tokens equal; states within
# 2e-4 of their scale (f32, another summation order).

V6_CASES = {"layer": (4, None), "fused": (64, None),
            "int8": (64, {0: "int8", 1: "int8"}),
            "mixed": (64, {0: "int8"}), "nf4": (64, {0: "nf4", 1: "nf4"})}


def _version_engines(monkeypatch, version, head, quant_map, seed):
    from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

    if quant_map:
        monkeypatch.setenv("AI00_QUANT_HEAD", "on")
    info = tiny_info(version, num_layer=2, num_emb=128, head_size=head,
                     num_vocab=64)
    params = make_params(info, make_raw_weights(info, seed=seed,
                                                dtype=np.float32),
                         dtype=np.float32, quant=quant_map)
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK)
    tparams = params_from_numpy(jax.tree.map(np.asarray, j.model.params),
                                "cpu")
    t = TEngine(TLoaded(info=info, params=tparams), max_batch=B,
                token_chunk_size=CHUNK, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [3] * 8, []]
    for eng in (j, t):
        for b in range(B):
            eng.load_row_state(b, None)
            eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts[b])
            eng.set_row_bias(b, None)
    return j, t, prompts


def _engine_equals_jax(monkeypatch, j, t, prompts, quantized, fused,
                       fd, fresh_row):
    """A ragged merged prefill, a 5-token decode_chunk with an idle row and
    a rollback through both engines: greedy tokens equal, states within
    2e-4 of their scale, the T=1 steps through ``fd.forward_t1`` exactly
    when ``fused``, the idle row as ``fresh_row`` says and the pool at its
    addresses."""
    assert fd.supports(t.model.params) == fused
    assert ("_head_q" in t.model.params) == quantized
    fused_steps = []
    real = fd.forward_t1
    monkeypatch.setattr(fd, "forward_t1",
                        lambda *a: fused_steps.append(1) or real(*a))
    ptrs = {k: v.data_ptr() for k, v in t.state_pool.items()}

    toks = np.zeros((B, CHUNK), np.int32)
    lens = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    js = j.step(toks, lens, lens > 0, want_logits=True)
    ts = t.step(toks, lens, lens > 0, want_logits=True)
    jl, tl = np.asarray(js.logits)[:3], ts.logits.numpy()[:3]
    if quantized:  # the JAX side's bf16 head (see above)
        gap = np.sort(tl, axis=-1)
        gap = float((gap[:, -1] - gap[:, -2]).min())
        assert float(np.abs(tl - jl).max()) <= 2.0 ** -6 * float(
            np.abs(jl).max())
        assert gap > 4 * float(np.abs(tl - jl).max())
    else:
        close(tl, jl)
    np.testing.assert_array_equal(ts.tokens[:3], js.tokens[:3])
    _states_close(j, t)
    assert not fused_steps

    active = np.array([True, True, True, False])
    budget = np.array([5, 5, 2, 0], np.int32)
    jt, _ = j.decode_chunk(js.tokens, active, 5, budget=budget)
    tt, _ = t.decode_chunk(ts.tokens, active, 5, budget=budget)
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    _states_close(j, t)
    assert len(fused_steps) == (5 if fused else 0)
    fresh_row(t.read_row_state(3))

    feed = [int(ts.tokens[0]), int(tt[0, 0])]
    j.rollback_row(0, feed)
    t.rollback_row(0, feed)
    _states_close(j, t)
    assert {k: v.data_ptr() for k, v in t.state_pool.items()} == ptrs


@pytest.mark.parametrize("case", sorted(V6_CASES))
def test_v6_engine_equals_jax(monkeypatch, case):
    from ai00_server_tpu_torch.models import v6 as tv6
    from ai00_server_tpu_torch.ops import v6_decode as fd6

    head, quant_map = V6_CASES[case]
    j, t, prompts = _version_engines(monkeypatch, ModelVersion.V6, head,
                                     quant_map, seed=73)
    assert t.module is tv6
    assert t.state_pool["wkv"].shape == (2, B, 128 // head, head, head)

    def fresh_row(row):
        assert float(np.abs(row["wkv"]).max()) == 0.0

    _engine_equals_jax(monkeypatch, j, t, prompts, quant_map is not None,
                       case in ("fused", "int8", "nf4"), fd6, fresh_row)


# ---------------------------------------------------------------------------
# RWKV-5 and RWKV-4: the same engine, unchanged
# ---------------------------------------------------------------------------
#
# As the v6 cases: a v5 of head size 4 keeps to the layer path, head size
# 64 takes ops/v5_decode; every v4 fuses (ops/v4_decode: no head-size rule)
# unless its layers are partly quantized.  A fresh v4 row starts at pp =
# PP_INIT (models/v4.init_state), never at zeros.  The weights' seed (77)
# is one where every quantized case's top two logits lie further apart than
# 4x the JAX side's bf16-head error, which the test asserts before it
# compares greedy tokens (seeds 74-76 give one case a closer pair).

V54_CASES = {"v5-layer": ("V5", 4, None), "v5-fused": ("V5", 64, None),
             "v5-int8": ("V5", 64, {0: "int8", 1: "int8"}),
             "v5-mixed": ("V5", 64, {0: "int8"}),
             "v4-fused": ("V4", 1, None),
             "v4-nf4": ("V4", 1, {0: "nf4", 1: "nf4"}),
             "v4-mixed": ("V4", 1, {0: "nf4"})}


@pytest.mark.parametrize("case", sorted(V54_CASES))
def test_v5_v4_engine_equals_jax(monkeypatch, case):
    from ai00_server_tpu_torch.models import get_version_module
    from ai00_server_tpu_torch.models.v4 import PP_INIT
    from ai00_server_tpu_torch.ops import fused_decode

    version, head, quant_map = V54_CASES[case]
    ver = ModelVersion(version)
    j, t, prompts = _version_engines(monkeypatch, ver, head, quant_map,
                                     seed=77)
    assert t.module is get_version_module(t.info.version)
    assert set(t.state_pool) == set(j.state_pool)
    fused = not case.endswith(("layer", "mixed"))

    def fresh_row(row):
        if version == "V5":
            assert float(np.abs(row["wkv"]).max()) == 0.0
        else:
            assert (row["pp"] == np.float32(PP_INIT)).all()
            assert float(np.abs(row["aa"]).max()) == 0.0

    _engine_equals_jax(monkeypatch, j, t, prompts, quant_map is not None,
                       fused, fused_decode.module_for(version), fresh_row)
