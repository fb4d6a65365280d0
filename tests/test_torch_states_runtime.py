"""Custom initial states in the port's runtime and engine against the JAX
package's on the CPU (after ``tests/test_torch_runtime_parity.py``), with
one tiny f32 RWKV-7 through both packages and a state-tuning ``.state``
file each package reads with its own ``load_state_file``:

* greedy tokens under the ``.state`` file's id, under the default state
  and under an inline state equal the JAX runtime's;
* per-state slots and prefix caches: the same 40-token prompt under the
  default state, the tuned state, then the default again, and a prompt
  that extends the slot's resident tokens under the other state, each
  equal to a fresh runtime's answer and to the JAX runtime's sequence
  (without the state id in the slot and the cache, the second request
  would continue the default's cached prompt and get its answer);
* an inline state without an id is served to its request alone: the
  tokens equal the registered state's, and ``Runtime.states`` and
  ``Runtime.caches`` do not grow (the JAX server registers every such
  state under a fresh uuid4);
* the nil UUID is the model's own initial state even where a default
  state is configured (as JAX's ``{"id": nil}``);
* the engine: the first logits of a step taken right after a custom state
  is installed equal the plain forward from that state and the JAX
  engine's, and the rows that keep decoding meanwhile are unchanged.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import packing as jpacking
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.runtime import GenerateRequest as JRequest
from ai00_server_tpu.runtime import Runtime as JRuntime
from ai00_server_tpu.runtime import SamplerSpec as JSampler
from ai00_server_tpu.testing import (make_params, make_raw_weights,
                                     make_tiny_model, tiny_info)
from ai00_server_tpu.tokenizer import Tokenizer as JTokenizer

from ai00_server_tpu_torch import engine as tengine
from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import get_version_module as tmodule
from ai00_server_tpu_torch.models import packing as tpacking
from ai00_server_tpu_torch.ops import sampling as tsampling
from ai00_server_tpu_torch.runtime import NIL_STATE_ID
from ai00_server_tpu_torch.runtime import GenerateRequest as TRequest
from ai00_server_tpu_torch.runtime import Runtime as TRuntime
from ai00_server_tpu_torch.runtime import SamplerSpec as TSampler
from ai00_server_tpu_torch.tokenizer import Tokenizer as TTokenizer

RTOL = 2e-4
SID = "fd7a60ed-7807-449f-8256-bccae3246222"
PROMPT = "<ABCABCABCABCABCABCABCABCABCABCABCABCAB"  # 40 chars: 40 tokens
VOCAB = {i: bytes([59 + i]) for i in range(1, 64)}

JAX = {"engine": lambda m, b: JEngine(JLoaded(info=m["info"],
                                              params=m["jparams"],
                                              init_wkv=None),
                                      max_batch=b, token_chunk_size=8,
                                      state_dtype=jnp.float32),
       "runtime": JRuntime, "request": JRequest, "tokenizer": JTokenizer,
       "sampler": lambda: JSampler(kind=jsampling.KIND_GREEDY,
                                   presence_penalty=0.0,
                                   frequency_penalty=0.0),
       "tuned": "jtuned", "nil": str(__import__("uuid").UUID(int=0))}
PORT = {"engine": lambda m, b: TEngine(TLoaded(info=m["tinfo"],
                                               params=m["tparams"]),
                                       max_batch=b, token_chunk_size=8,
                                       device="cpu"),
        "runtime": TRuntime, "request": TRequest, "tokenizer": TTokenizer,
        "sampler": lambda: TSampler(kind=tsampling.KIND_GREEDY,
                                    presence_penalty=0.0,
                                    frequency_penalty=0.0),
        "tuned": "ttuned", "nil": NIL_STATE_ID}


def tuned_file(path, info, seed=7):
    """A state-tuning file: per-layer time_state at 0.3 x standard
    normal, stored transposed as the converter stores it."""
    H, N = info.num_head, info.head_size
    ts = np.random.default_rng(seed).standard_normal(
        (info.num_layer, H, N, N)).astype(np.float32) * 0.3
    jloader.save_safetensors(
        {f"blocks.{i}.att.time_state": np.swapaxes(ts[i], -1, -2)
         for i in range(info.num_layer)}, str(path), dtype=np.float32)
    return str(path)


def lasting(raw: dict) -> dict:
    """Random weights under which an initial state outlasts a 40-token
    prompt: every matrix but the embedding divided by the square root of
    its fan-in (times 2), and v7's decay bias ``w0`` at -6, a decay of
    ~0.9985 a step (drawn at random, the decay is ~0.74 a step and a
    state is forgotten within 40 tokens: every state gives one answer)."""
    out = {}
    for k, v in raw.items():
        if k.endswith(".weight") and v.ndim == 2 and k != "emb.weight":
            v = v / np.sqrt(v.shape[0]) * 2
        if k.endswith("att.w0"):
            v = np.full_like(v, -6.0)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    from ai00_server_tpu_torch.models import ModelInfo as TInfo
    from ai00_server_tpu_torch.models import ModelVersion as TVersion

    info = tiny_info(ModelVersion.V7, num_vocab=64)
    jparams = make_params(info, lasting(make_raw_weights(
        info, seed=42, dtype=np.float32)), dtype=np.float32)
    tinfo = TInfo(version=TVersion.V7, num_layer=info.num_layer,
                  num_emb=info.num_emb, num_hidden=info.num_hidden,
                  num_vocab=info.num_vocab, num_head=info.num_head,
                  head_size=info.head_size)
    path = tuned_file(tmp_path_factory.mktemp("st") / "tuned.state", info)
    return {"info": info, "tinfo": tinfo, "jparams": jparams,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
            "jtuned": jpacking.load_state_file(info, path),
            "ttuned": tpacking.load_state_file(tinfo, path)}


async def generate(pkg, rt, prompt, n, **state):
    handle = await rt.submit(pkg["request"](
        prompt=prompt, max_tokens=n, sampler=pkg["sampler"](), **state))
    parts = []
    async for msg in handle:
        if msg[0] == "content":
            parts.append(msg[1])
    return "".join(parts)


async def idle(rt):
    for _ in range(2000):
        if all(s.ctx is None for s in rt.slots):
            await rt.flush_cache_stores()
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the slots never went idle")


def run(pkg, model, requests, states=None, max_batch=1):
    """Texts of ``requests`` ((prompt, state keywords), one after the
    other) on one runtime; ``states`` maps ids to which state of the model
    ("tuned") or None."""
    tok = pkg["tokenizer"](VOCAB)
    registry = {sid: (model[pkg["tuned"]] if which == "tuned" else None)
                for sid, which in (states or {SID: "tuned"}).items()}

    async def main():
        rt = pkg["runtime"](pkg["engine"](model, max_batch), tok,
                            states=registry, decode_chunk_size=8)
        rt.start()
        out = []
        try:
            for prompt, state in requests:
                if state.get("state") == "tuned":
                    state = {"state": model[pkg["tuned"]]}
                out.append(await generate(pkg, rt, prompt, 6, **state))
                await idle(rt)
            return out, rt
        finally:
            await rt.stop()

    return asyncio.run(main())


def test_state_file_default_and_inline_tokens_equal_jax(model):
    port, rt = run(PORT, model, [(PROMPT, {"state_id": SID}),
                                 (PROMPT, {}),
                                 ("XYZ" + PROMPT, {"state": "tuned"})])
    # JAX registers an inline state under an id; served alone it is the
    # registered state's answer.
    jax_, _ = run(JAX, model, [(PROMPT, {"state_id": SID}), (PROMPT, {}),
                               ("XYZ" + PROMPT, {"state_id": SID})])
    assert port == jax_
    assert port[0] != port[1]  # the tuned state steers the answer
    assert len(port[0]) == 6


def test_states_never_cross_slots_or_caches(model):
    """Trouble spot 2: default, tuned, default on one prompt, then a prompt
    extending the slot's resident tokens under the tuned state."""
    def sequence(pkg):
        first, _ = run(pkg, model, [(PROMPT, {})])
        seq = [(PROMPT, {}), (PROMPT, {"state_id": SID}), (PROMPT, {}),
               (PROMPT + first[0] + "AB", {"state_id": SID})]
        texts, rt = run(pkg, model, seq)
        fresh = [run(pkg, model, [r])[0][0] for r in seq]
        return texts, fresh, rt

    texts, fresh, rt = sequence(PORT)
    assert texts == fresh
    assert texts[0] == texts[2] != texts[1]
    assert set(rt.caches) == {"default", SID}
    # One install from the file: the last request extends the prompt the
    # tuned state's own cache holds, and checks that out.
    assert rt.metrics["state_installs"] == 1
    jtexts, jfresh, _ = sequence(JAX)
    assert texts == jtexts == jfresh


def test_inline_state_is_served_alone(model):
    async def main():
        rt = TRuntime(PORT["engine"](model, 1), TTokenizer(VOCAB),
                      states={SID: model["ttuned"]}, decode_chunk_size=8)
        rt.start()
        try:
            want = await generate(PORT, rt, PROMPT, 6, state_id=SID)
            await idle(rt)
            states, caches = dict(rt.states), set(rt.caches)
            got = []
            for _ in range(3):
                got.append(await generate(PORT, rt, PROMPT, 6,
                                          state=model["ttuned"]))
                await idle(rt)
            assert rt.states == states and set(rt.caches) == caches
            assert got == [want] * 3
            # A resident slot of an inline state is never continued.
            cont = await generate(PORT, rt, PROMPT + want + "AB", 6)
            await idle(rt)
        finally:
            await rt.stop()
        return want, cont

    want, cont = asyncio.run(main())
    assert cont == run(PORT, model, [(PROMPT + want + "AB", {})])[0][0]


def test_nil_uuid_is_the_models_own_state(model):
    """With a default state configured, the nil UUID still addresses the
    model's own initial state (JAX's ``{"id": nil}`` form)."""
    states = {SID: "tuned", "default": "tuned", JAX["nil"]: None}
    reqs = [(PROMPT, {}), (PROMPT, {"state_id": PORT["nil"]})]
    port, _ = run(PORT, model, reqs, states=states)
    jax_, _ = run(JAX, model, reqs, states=states)
    plain, _ = run(PORT, model, [(PROMPT, {})], states={})
    tuned, _ = run(PORT, model, [(PROMPT, {"state_id": SID})])
    assert port == jax_
    assert port == [tuned[0], plain[0]]


def test_unknown_state_id_is_refused(model):
    async def main():
        rt = TRuntime(PORT["engine"](model, 1), TTokenizer(VOCAB))
        with pytest.raises(KeyError, match="unknown state id"):
            await rt.submit(TRequest(prompt="AB", state_id="nope"))
        await rt.stop()

    asyncio.run(main())


@pytest.fixture(scope="module")
def fused():
    """A tiny v7 of head size 64 (the fused T=1 path: its plain versions on
    the CPU) and a tuned state for it, in both packages."""
    from ai00_server_tpu_torch.models import ModelInfo as TInfo
    from ai00_server_tpu_torch.models import ModelVersion as TVersion

    info, _, jparams = make_tiny_model(ModelVersion.V7, seed=41,
                                       dtype=np.float32, num_layer=2,
                                       num_emb=128, head_size=64,
                                       num_vocab=64)
    tinfo = TInfo(version=TVersion.V7, num_layer=2, num_emb=128,
                  num_hidden=info.num_hidden, num_vocab=64, num_head=2,
                  head_size=64)
    rng = np.random.default_rng(9)
    flat = rng.standard_normal(tpacking.state_shape(tinfo)).astype(
        np.float32) * 0.3
    return {"info": info, "tinfo": tinfo, "jparams": jparams,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
            "jtuned": jpacking.unpack_state(info, flat),
            "ttuned": tpacking.unpack_state(tinfo, flat)}


def test_step_after_install_equals_plain_forward(fused):
    """Trouble spot 1 on the CPU: install a state in row 1 while row 0
    decodes; row 0's tokens are those of an engine without the install,
    and row 1's first logits equal the plain forward from the state and
    the JAX engine's."""
    B, T = 2, 8
    prompt = np.array([[5, 6, 7, 8, 9, 10, 11, 12],
                       [3, 4, 5, 6, 7, 8, 9, 10]], np.int32)
    greedy = TSampler(kind=tsampling.KIND_GREEDY).row_params()

    def prepared():
        eng = PORT["engine"](fused, B)
        assert eng._graph is None and "_fused_t1" in eng.model.params
        for b in range(B):
            eng.load_row_state(b)
            eng.set_row_sampler(b, greedy)
        res = eng.step(prompt, np.full(B, T, np.int32), np.ones(B, bool))
        toks, _ = eng.decode_chunk(res.tokens, np.ones(B, bool), 3)
        return eng, toks[-1]

    eng, last = prepared()
    ref, ref_last = prepared()
    np.testing.assert_array_equal(last, ref_last)
    eng.load_row_state(1, fused["ttuned"])
    only0 = np.array([True, False])
    a, _ = eng.decode_chunk(last, only0, 4)
    b, _ = ref.decode_chunk(ref_last, only0, 4)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])

    tok = np.zeros((B, 1), np.int32)
    tok[1, 0] = 17
    res = eng.step(tok, np.array([0, 1], np.int32), np.array([False, True]),
                   want_logits=True)
    got = res.logits[1].numpy()
    m = tmodule(fused["tinfo"].version)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             fused["ttuned"].items()}
    h, _ = m.forward(fused["tparams"], state, torch.tensor([[17]]),
                     torch.tensor([1]))
    want = tengine.head_logits(fused["tparams"], h[:, -1]).numpy()[0]
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= RTOL * scale

    jeng = JAX["engine"](fused, B)
    jeng.load_row_state(1, jax.tree.map(jnp.asarray, fused["jtuned"]))
    jres = jeng.step(tok, np.array([0, 1], np.int32),
                     np.array([False, True]), want_logits=True)
    jlog = np.asarray(jres.logits)[1]
    assert float(np.abs(got - jlog).max()) <= RTOL * scale
