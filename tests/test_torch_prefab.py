"""Prefabs across the two packages on the CPU (``tests/test_quant_prefab.py``
mirrored): a prefab written by the JAX package's ``save_prefab`` loads in
the port's ``load_prefab`` and one written by the port's loads in the JAX
package's, for plain f32 weights, every layer int8 / nf4 / sf4 / int4, and
a mixed model (layer 0 int8 of 2).  The codes and scales cross bit for bit
and the logits (forward, then the LM head) equal the other package's at
``RTOL`` 2e-4 of scale.  Also:

* bf16 weights cross as their bits (``uint16`` views, never through f32);
* the embedded initial state (``init_wkv``) crosses both ways;
* a JAX engine in 4-bit surrogate mode (``AI00_NF4_DECODE=surrogate``, set
  only here through ``monkeypatch``) exports its codes repacked to 4-bit:
  the port, which decodes 4-bit codes directly and has no surrogate, loads
  the original nf4 codes;
* an older prefab with a ``head_q`` key: the port serves it (as
  ``_head_q``) and writes it back under the same key;
* the port's engine keeps the lossless LM head on the host when it
  installs the int8 one, so a prefab exported from a quantized model holds
  the head it was loaded with;
* a reference (CBOR) prefab, a file with another magic and a plain
  checkpoint are refused with ``ValueError`` naming the file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from ai00_server_tpu import engine as jengine
from ai00_server_tpu import prefab as jprefab
from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion as JVersion
from ai00_server_tpu.models import get_version_module as jmodule
from ai00_server_tpu.ops import quant as jquant
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch import engine as tengine
from ai00_server_tpu_torch import prefab as tprefab
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import stack_params
from ai00_server_tpu_torch.models import ModelVersion
from ai00_server_tpu_torch.models import get_version_module as tmodule
from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.testing import tiny_info as ttiny_info

RTOL = 2e-4
SHAPE = dict(num_layer=2, num_emb=128, head_size=64, num_vocab=64)
MODES = {"none": None, "int8": {0: "int8", 1: "int8"},
         "nf4": {0: "nf4", 1: "nf4"}, "sf4": {0: "sf4", 1: "sf4"},
         "int4": {0: "int4", 1: "int4"}, "mixed": {0: "int8"}}
TOKENS = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (
        float(np.abs(got - want).max()), scale)


def infos(version="V7"):
    return (tiny_info(JVersion(version), **SHAPE),
            ttiny_info(ModelVersion(version), **SHAPE))


def jax_logits(info, params):
    m = jmodule(info.version)
    h, _ = jax.jit(m.forward)(params, m.init_state(info, 1, jnp.float32),
                              jnp.asarray(TOKENS),
                              jnp.array([TOKENS.shape[1]], jnp.int32))
    return np.asarray(jengine.head_logits(params, h[0]))


def port_logits(info, params):
    m = tmodule(info.version)
    h, _ = m.forward(params, m.init_state(info, 1),
                     torch.from_numpy(TOKENS),
                     torch.tensor([TOKENS.shape[1]]))
    return tengine.head_logits(params, h[0]).numpy()


def jax_leaves(params):
    """(mode, q, scale) of every quantized leaf, layer by layer, in key
    order."""
    out = []
    for g in params["groups"]:
        K = int(np.asarray(g["layer_index"]).shape[0])
        for i in range(K):
            for part in ("att", "ffn"):
                for k in sorted(g["layers"][part]):
                    v = g["layers"][part][k]
                    if isinstance(v, jquant.QuantizedLinear):
                        out.append((v.mode, np.asarray(v.q)[i],
                                    np.asarray(v.scale)[i]))
    return out


def port_leaves(params):
    out = []
    for p in params["layers"]:
        for part in ("att", "ffn"):
            for k in sorted(p[part]):
                v = p[part][k]
                if tquant.is_quantized(v):
                    out.append((v.mode, v.q.numpy(), v.scale.numpy()))
    return out


def assert_same_leaves(a, b):
    assert len(a) == len(b)
    for (ma, qa, sa), (mb, qb, sb) in zip(a, b):
        assert ma == mb
        np.testing.assert_array_equal(qa, qb)
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_jax_prefab_loads_in_the_port(tmp_path, mode):
    jinfo, tinfo = infos()
    raw = make_raw_weights(jinfo, seed=12, dtype=np.float32)
    params = make_params(jinfo, raw, dtype=np.float32, quant=MODES[mode])
    path = str(tmp_path / "m.prefab")
    jprefab.save_prefab(path, JLoaded(info=jinfo, params=params,
                                      init_wkv=None), config={"quant": 2})
    lm = tprefab.load_prefab(path, device="cpu")
    assert lm.info == tinfo and lm.init_wkv is None
    assert_same_leaves(port_leaves(lm.params), jax_leaves(params))
    close(port_logits(lm.info, lm.params), jax_logits(jinfo, params))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_prefab_loads_in_jax(tmp_path, mode):
    jinfo, tinfo = infos()
    raw = make_raw_weights(jinfo, seed=13, dtype=np.float32)
    params = stack_params(tinfo, raw, dtype=torch.float32, device="cpu",
                          quant=MODES[mode])
    path = str(tmp_path / "m.prefab")
    tprefab.save_prefab(path, TLoaded(info=tinfo, params=params),
                        config={"quant": 2})
    lm = jprefab.load_prefab(path)
    assert lm.info.num_layer == 2 and lm.info.version == JVersion.V7
    assert_same_leaves(port_leaves(params), jax_leaves(lm.params))
    close(jax_logits(lm.info, lm.params), port_logits(tinfo, params))
    # Groups are runs of one mode, as the JAX loader stacks them.
    sizes = [int(np.asarray(g["layer_index"]).shape[0])
             for g in lm.params["groups"]]
    assert sizes == ([1, 1] if mode == "mixed" else [2])
    # ...and the port reads its own prefab back to the same params.
    back = tprefab.load_prefab(path, device="cpu")
    assert_same_leaves(port_leaves(back.params), port_leaves(params))
    np.testing.assert_array_equal(port_logits(tinfo, back.params),
                                  port_logits(tinfo, params))


def test_bf16_and_init_wkv_cross_both_ways(tmp_path):
    jinfo, tinfo = infos("V5")
    raw = make_raw_weights(jinfo, seed=14, dtype=np.float32)
    init = np.random.default_rng(3).standard_normal(
        (2, jinfo.num_head, 64, 64)).astype(np.float32)
    jparams = make_params(jinfo, raw, dtype=jnp.bfloat16)
    path = str(tmp_path / "j.prefab")
    jprefab.save_prefab(path, JLoaded(info=jinfo, params=jparams,
                                      init_wkv=init))
    lm = tprefab.load_prefab(path, device="cpu")
    assert lm.params["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lm.params["emb"].view(torch.int16).numpy(),
        np.asarray(jparams["emb"]).view(np.int16))
    np.testing.assert_array_equal(
        lm.params["layers"][1]["att"]["gate"].view(torch.int16).numpy(),
        np.asarray(jparams["groups"][0]["layers"]["att"]["gate"][1]).view(
            np.int16))
    np.testing.assert_array_equal(lm.init_wkv, init)

    path2 = str(tmp_path / "t.prefab")
    tprefab.save_prefab(path2, lm)
    back = jprefab.load_prefab(path2)
    np.testing.assert_array_equal(back.init_wkv, init)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def test_jax_surrogate_export_loads_as_4bit(tmp_path, monkeypatch):
    """The JAX engine converts 4-bit codes to int8 surrogate codes only in
    surrogate mode and repacks them at export: the port loads the original
    nf4 codes (it decodes 4-bit directly and keeps no surrogate)."""
    monkeypatch.setenv("AI00_NF4_DECODE", "surrogate")
    monkeypatch.setenv("AI00_QUANT_HEAD", "off")
    jinfo, tinfo = infos()
    raw = make_raw_weights(jinfo, seed=15, dtype=np.float32)
    quant = MODES["nf4"]
    original = make_params(jinfo, raw, dtype=np.float32, quant=quant)
    model = JLoaded(info=jinfo, params=make_params(
        jinfo, raw, dtype=np.float32, quant=quant), init_wkv=None)
    JEngine(model, max_batch=1, token_chunk_size=8,
            state_dtype=jnp.float32)
    assert model.surrogate_modes  # the JAX engine holds int8 surrogates
    assert {m for m, _, _ in jax_leaves(model.params)} == {"int8"}
    path = str(tmp_path / "s.prefab")
    jprefab.save_prefab(path, model)
    lm = tprefab.load_prefab(path, device="cpu")
    assert_same_leaves(port_leaves(lm.params), jax_leaves(original))
    close(port_logits(tinfo, lm.params), jax_logits(jinfo, original))


def test_head_q_prefab(tmp_path):
    """A prefab from before the int8 head became a derived key holds
    ``head_q``: the port takes its logits from it and writes it back."""
    jinfo, tinfo = infos()
    raw = make_raw_weights(jinfo, seed=16, dtype=np.float32)
    params = make_params(jinfo, raw, dtype=np.float32, quant=MODES["int8"])
    params["head_q"] = jquant.quantize_int8(np.asarray(params.pop("head")))
    path = str(tmp_path / "old.prefab")
    jprefab.save_prefab(path, JLoaded(info=jinfo, params=params,
                                      init_wkv=None))
    lm = tprefab.load_prefab(path, device="cpu")
    assert "head" not in lm.params and "head_q" not in lm.params
    np.testing.assert_array_equal(lm.params["_head_q"].q.numpy(),
                                  np.asarray(params["head_q"].q))
    # Score shapes (more rows than KERNEL_ROWS): both packages dequantize
    # the head to bf16 and take one f32-summed product of bf16 operands.
    x = np.random.default_rng(4).standard_normal(
        (tquant.KERNEL_ROWS + 8, 128)).astype(np.float32)
    close(tengine.head_logits(lm.params, torch.from_numpy(x)).numpy(),
          np.asarray(jengine.head_logits(params, jnp.asarray(x))))
    head_q = lm.params["_head_q"]
    eng = tengine.Engine(lm, max_batch=1, token_chunk_size=8, device="cpu")
    assert lm.params["_head_q"] is head_q  # the prefab's codes, kept
    res = eng.step(TOKENS, np.array([8], np.int32), np.array([True]), True)
    assert res.logits.shape == (1, 64) and torch.isfinite(res.logits).all()
    path2 = str(tmp_path / "again.prefab")
    tprefab.save_prefab(path2, lm)
    back = jprefab.load_prefab(path2)
    np.testing.assert_array_equal(np.asarray(back.params["head_q"].q),
                                  np.asarray(params["head_q"].q))


def test_export_keeps_the_lossless_head(tmp_path):
    _, tinfo = infos()
    raw = make_raw_weights(infos()[0], seed=17, dtype=np.float32)
    params = stack_params(tinfo, raw, dtype=torch.float32, device="cpu",
                          quant=MODES["int8"])
    head = params["head"].clone()
    model = TLoaded(info=tinfo, params=params)
    eng = tengine.Engine(model, max_batch=1, token_chunk_size=8,
                         device="cpu")
    assert "head" not in params and "_head_q" in params
    torch.testing.assert_close(model.host_params["head"], head,
                               rtol=0, atol=0)
    path = str(tmp_path / "q.prefab")
    tprefab.save_prefab(path, model)
    lm = jprefab.load_prefab(path)
    np.testing.assert_array_equal(np.asarray(lm.params["head"]),
                                  head.numpy())
    assert "_head_q" not in lm.params
    again = tprefab.load_prefab(path, device="cpu")
    eng2 = tengine.Engine(again, max_batch=1, token_chunk_size=8,
                          device="cpu")
    torch.testing.assert_close(again.params["_head_q"].q,
                               params["_head_q"].q, rtol=0, atol=0)
    del eng, eng2


def test_foreign_files_are_refused(tmp_path):
    cbor = tmp_path / "ref.prefab"
    cbor.write_bytes(b"\xa3\x65model" + b"\x00" * 32)
    with pytest.raises(ValueError, match="ref.prefab.*cbor"):
        tprefab.load_prefab(str(cbor), device="cpu")
    magic = str(tmp_path / "other.prefab")
    save_file({"t0": np.zeros(2, np.float32)}, magic,
              metadata={"prefab": json.dumps({"magic": "ai00-tpu-prefab-v1"})})
    with pytest.raises(ValueError, match="other.prefab.*not an ai00-tpu"):
        tprefab.load_prefab(magic, device="cpu")
    plain = str(tmp_path / "plain.st")
    save_file({"emb.weight": np.zeros((2, 2), np.float32)}, plain,
              metadata={"format": "pt"})
    with pytest.raises(ValueError, match="plain.st"):
        tprefab.load_prefab(plain, device="cpu")


def test_prefab_with_lora_entries_is_refused(tmp_path):
    """A prefab loads as it was saved: a reload that names LoRA entries
    beside it raises, naming the file, and leaves the loaded model be."""
    import asyncio

    from ai00_server_tpu_torch.middleware import Middleware, ReloadRequest

    mw = Middleware(device="cpu")
    req = ReloadRequest(model_path=str(tmp_path / "q.prefab"),
                        lora=[{"path": str(tmp_path / "l.st"), "alpha": 1}])
    with pytest.raises(ValueError, match="q.prefab.*lora"):
        asyncio.run(mw.reload(req))
    assert mw.env is None


def serve_texts(server_cls, config_cls, toml, model_path=None, save=None,
                **kw):
    """Greedy completions of a server loaded from ``toml`` (or its model
    swapped for ``model_path``); ``save``: export a prefab there after."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        config = config_cls.from_toml(str(toml))
        server = server_cls(config, **kw)
        req = config.to_reload_request(sandbox=False)
        if model_path is not None:
            req.model_path = str(model_path)
        if hasattr(req, "prewarm"):
            req.prewarm = False
        await server.middleware.reload(req)
        client = TestClient(TestServer(server.app))
        await client.start_server()
        try:
            out = []
            for prompt in ("ABCAB", "QRS"):
                r = await client.post("/api/oai/completions", json={
                    "prompt": prompt, "max_tokens": 6,
                    "sampler": {"type": "Nucleus", "top_k": 1}})
                assert r.status == 200, await r.text()
                out.append((await r.json())["choices"][0]["text"])
            if save is not None:
                await server.middleware.save(str(save))
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    return asyncio.run(main())


@pytest.mark.parametrize("quant_type", ["Int8", "NF4"])
def test_middleware_save_and_reload(tmp_path, quant_type):
    """``Middleware.save`` exports the served model; reloading the prefab
    repeats the greedy tokens; the JAX server serves the port's prefab
    with the tokens it serves the checkpoint with, and the port serves
    the JAX server's prefab with the same tokens."""
    from ai00_server_tpu import loader as jloader
    from ai00_server_tpu.server.app import Server as JServer
    from ai00_server_tpu.server.config import Config as JConfig

    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config

    from test_loader import to_converted_layout

    jinfo, _ = infos()
    raw = make_raw_weights(jinfo, seed=18, dtype=np.float32)
    jloader.save_safetensors(to_converted_layout(raw),
                             str(tmp_path / "tiny.st"), dtype=np.float32)
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    toml = tmp_path / "Config.toml"
    toml.write_text(f"""
[model]
name = "tiny.st"
path = "{tmp_path}"
max_batch = 2
token_chunk_size = 8
precision = "Fp32"
quant = 2
quant_type = "{quant_type}"

[tokenizer]
path = "{tmp_path / 'vocab.json'}"
""")
    port_prefab = tmp_path / "port.prefab"
    jax_prefab = tmp_path / "jax.prefab"
    before = serve_texts(Server, Config, toml, save=port_prefab,
                         device="cpu")
    after = serve_texts(Server, Config, toml, model_path=port_prefab,
                        device="cpu")
    assert before == after and all(before)
    jax_st = serve_texts(JServer, JConfig, toml, save=jax_prefab)
    assert serve_texts(JServer, JConfig, toml,
                       model_path=port_prefab) == jax_st
    assert serve_texts(Server, Config, toml, model_path=jax_prefab,
                       device="cpu") == before


def test_prefab_with_the_published_lora_ranks(tmp_path):
    """RWKV-7 World 0.4B's value LoRA rank (32) differs from its other
    ranks (64): layer 0's zero value residual takes the other layers'
    rank, so every layer stacks into one prefab group, which the JAX
    package loads and runs to the port's logits."""
    from ai00_server_tpu_torch.testing import make_raw_weights as tmake

    _, tinfo = infos()
    raw = tmake(tinfo, seed=19, dtype=np.float32,
                lora_dims={"w": 16, "a": 16, "v": 8, "g": 32})
    params = stack_params(tinfo, raw, dtype=torch.float32, device="cpu",
                          quant=MODES["int8"])
    assert params["layers"][0]["att"]["v1"].shape == (128, 8)
    path = str(tmp_path / "ranks.prefab")
    tprefab.save_prefab(path, TLoaded(info=tinfo, params=params))
    lm = jprefab.load_prefab(path)
    assert np.asarray(lm.params["groups"][0]["layers"]["att"]["v1"]).shape \
        == (2, 128, 8)
    close(jax_logits(lm.info, lm.params), port_logits(tinfo, params))
