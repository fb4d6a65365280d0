"""The port's loader against the JAX package's on the CPU for what the
``.state files, LoRA and prefab`` slice brings (``tests/test_loader.py``'s
``test_lora_blend``, ``test_embedded_time_state`` and
``test_pth_conversion``, mirrored):

* ``apply_lora``: the blended math-layout weights equal JAX's at f32
  ``rtol`` 1e-6, and the LoRA-blended weights of a loaded model too; the
  blend runs before quantization, so a LoRA-blended int8 / nf4 model holds
  codes and scales equal to JAX's, bit for bit;
* ``convert_pth`` / ``read_checkpoint`` of a raw ``.pth`` for RWKV-4,
  -5 (the v5.1 repeat of ``time_decay`` / ``time_faaaa`` and v5.2), -6 and
  -7: the converted arrays equal JAX's exactly, and the forward of the
  ``.pth``-loaded model equals JAX's at ``RTOL`` 2e-4 of scale (the
  tolerance of ``tests/test_torch_models_v7.py``);
* a state-tuned checkpoint: ``init_wkv`` equals JAX's, and the engine's
  fresh row carries it (transposed for v7) as the JAX engine's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.models import ModelVersion as JVersion
from ai00_server_tpu.models import get_version_module as jmodule
from ai00_server_tpu.testing import make_raw_weights, tiny_info

from ai00_server_tpu_torch import loader as tloader
from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.models import get_version_module as tmodule

from test_loader import to_converted_layout

RTOL = 2e-4
QUANT_INFO = dict(num_layer=2, num_emb=128, head_size=64, num_vocab=64)
LORA_KEYS = ("att.receptance.weight", "att.output.weight",
             "ffn.value.weight")


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (
        float(np.abs(got - want).max()), scale)


def write_model(tmp_path, version="V7", seed=8, **shape):
    info = tiny_info(JVersion(version), **(shape or QUANT_INFO))
    raw = make_raw_weights(info, seed=seed, dtype=np.float32)
    path = str(tmp_path / "model.st")
    jloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    return info, raw, path


def write_lora(tmp_path, info, rank=4, seed=0):
    """A converted LoRA file over every layer's receptance, output and
    channel-mix value: ``lora.0`` (torch ``lora_A`` (rank, in)) stored
    transposed, ``lora.1`` (torch ``lora_B`` (out, rank)) as it is."""
    rng = np.random.default_rng(seed)
    C, F = info.num_emb, info.num_hidden
    dims = {"att.receptance.weight": (C, C), "att.output.weight": (C, C),
            "ffn.value.weight": (F, C)}
    tensors = {}
    for i in range(info.num_layer):
        for k, (n_in, n_out) in dims.items():
            A = rng.standard_normal((rank, n_in)).astype(np.float32) * 0.1
            B = rng.standard_normal((n_out, rank)).astype(np.float32) * 0.1
            tensors[f"blocks.{i}.{k}.lora.0"] = A.T
            tensors[f"blocks.{i}.{k}.lora.1"] = B
    path = str(tmp_path / "lora.st")
    jloader.save_safetensors(tensors, path, dtype=np.float32)
    return path, tensors


def test_apply_lora_equals_jax(tmp_path):
    info, raw, path = write_model(tmp_path)
    lora_path, _ = write_lora(tmp_path, info)
    lora_raw = tloader.read_checkpoint(lora_path)
    jmath = jloader.to_math_layout(jloader.read_checkpoint(path))
    tmath = tloader.to_math_layout(tloader.read_checkpoint(path))
    jloader.apply_lora(jmath, jloader.read_checkpoint(lora_path), 16.0)
    tloader.apply_lora(tmath, lora_raw, 16.0)
    assert set(jmath) == set(tmath)
    for k in jmath:
        np.testing.assert_allclose(tmath[k], jmath[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    # The blend is W + alpha / rank * A^T @ B^T in math layout.
    k = "blocks.1.att.receptance.weight"
    A = lora_raw[k + ".lora.0"].T
    B = lora_raw[k + ".lora.1"]
    want = raw[k] + (16.0 / 4) * (A.T @ B.T)
    np.testing.assert_allclose(tmath[k], want, rtol=1e-6, atol=1e-6)


def test_lora_blended_model_equals_jax(tmp_path):
    info, _, path = write_model(tmp_path)
    lora_path, _ = write_lora(tmp_path, info)
    loras = [(lora_path, 16.0), (lora_path, -4.0)]
    jm = jloader.load_model(path, dtype=jnp.float32, loras=loras)
    tm = tloader.load_model(path, dtype=torch.float32, device="cpu",
                            loras=loras)
    group = jm.params["groups"][0]["layers"]
    for i, layer in enumerate(tm.params["layers"]):
        for k in LORA_KEYS:
            part, name = k.split(".")[:2]
            np.testing.assert_allclose(
                layer[part][name].numpy(), np.asarray(group[part][name][i]),
                rtol=1e-6, atol=0, err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_lora_then_quantize_codes_equal_jax(tmp_path, mode):
    """The blend runs on the f32 weights before quantization: the codes
    and scales of a LoRA-blended int8 / nf4 model equal JAX's."""
    info, _, path = write_model(tmp_path)
    lora_path, _ = write_lora(tmp_path, info)
    quant = {i: mode for i in range(info.num_layer)}
    loras = [(lora_path, 16.0)]
    jm = jloader.load_model(path, dtype=jnp.float32, loras=loras,
                            quant=quant)
    tm = tloader.load_model(path, dtype=torch.float32, device="cpu",
                            loras=loras, quant=quant)
    plain = tloader.load_model(path, dtype=torch.float32, device="cpu",
                               quant=quant)
    group = jm.params["groups"][0]["layers"]
    for i, layer in enumerate(tm.params["layers"]):
        for part, keys in (("att", ("receptance", "key", "value",
                                    "output")),
                           ("ffn", ("key", "value"))):
            for k in keys:
                got, want = layer[part][k], group[part][k]
                assert got.mode == want.mode == mode
                np.testing.assert_array_equal(
                    got.q.numpy(), np.asarray(want.q)[i], err_msg=k)
                np.testing.assert_array_equal(
                    got.scale.numpy(), np.asarray(want.scale)[i], err_msg=k)
        # The blended projections' codes differ from the unblended ones.
        assert not torch.equal(layer["att"]["receptance"].q,
                               plain.params["layers"][i]["att"][
                                   "receptance"].q)


def write_pth(tmp_path, version: str, seed: int, v51: bool = False):
    """A raw ``.pth`` in the torch naming of ``version`` and the math
    weights it holds (v5.1: one ``time_decay`` / ``time_faaaa`` value a
    head, which the converter repeats over the head's channels)."""
    info = tiny_info(JVersion(version), num_layer=2, num_emb=32,
                     head_size=16, num_vocab=64)
    raw = make_raw_weights(info, seed=seed, dtype=np.float32)
    if v51:
        for k in list(raw):
            if k.endswith("time_decay") or k.endswith("time_first"):
                raw[k] = np.repeat(raw[k][:, :1], raw[k].shape[1], axis=1)
    sd = {}
    for k, v in to_converted_layout(raw).items():
        if jloader._is_convert_transposed(k) and v.ndim >= 2:
            v = np.swapaxes(v, -1, -2)  # back to the torch parameter
        orig = k
        if version in ("V5", "V6"):
            orig = orig.replace("time_first", "time_faaaa")
        if version == "V6":
            orig = orig.replace("time_mix", "time_maa")
        if v51 and ("time_decay" in k or "time_first" in k):
            v = v[:, 0]
        sd[orig] = torch.tensor(np.ascontiguousarray(v))
    path = str(tmp_path / "model.pth")
    torch.save(sd, path)
    return info, path


PTH_CASES = {"v4": ("V4", False), "v5.1": ("V5", True), "v5.2": ("V5", False),
             "v6": ("V6", False), "v7": ("V7", False)}


@pytest.mark.parametrize("case", sorted(PTH_CASES))
def test_pth_conversion_equals_jax(tmp_path, case):
    version, v51 = PTH_CASES[case]
    info, path = write_pth(tmp_path, version, seed=10, v51=v51)
    want = jloader.convert_pth(path)
    got = tloader.read_checkpoint(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if v51:
        assert got["blocks.0.att.time_decay"].shape == (
            info.num_head, info.head_size)

    jm = jloader.load_model(path, dtype=jnp.float32)
    tm = tloader.load_model(path, dtype=torch.float32, device="cpu")
    assert tm.info.version.value == jm.info.version.value == version
    toks = np.arange(1, 7, dtype=np.int32)[None]
    jm_mod = jmodule(jm.info.version)
    h_j, _ = jax.jit(jm_mod.forward)(
        jm.params, jm_mod.init_state(jm.info, 1, jnp.float32),
        jnp.asarray(toks), jnp.array([6], jnp.int32))
    tm_mod = tmodule(tm.info.version)
    h_t, _ = tm_mod.forward(tm.params, tm_mod.init_state(tm.info, 1),
                            torch.from_numpy(toks), torch.tensor([6]))
    close(h_t.numpy(), np.asarray(h_j))


@pytest.mark.parametrize("version", ["V6", "V7"])
def test_embedded_time_state_equals_jax(tmp_path, version):
    info = tiny_info(JVersion(version), num_layer=2, num_emb=32,
                     head_size=16, num_vocab=64)
    raw = make_raw_weights(info, seed=9, dtype=np.float32)
    conv = to_converted_layout(raw)
    H, N = info.num_head, info.head_size
    ts = np.random.default_rng(1).standard_normal(
        (info.num_layer, H, N, N)).astype(np.float32)
    for i in range(info.num_layer):
        conv[f"blocks.{i}.att.time_state"] = np.swapaxes(ts[i], -1, -2)
    path = str(tmp_path / "tuned.st")
    jloader.save_safetensors(conv, path, dtype=np.float32)

    jm = jloader.load_model(path, dtype=jnp.float32)
    tm = tloader.load_model(path, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tm.init_wkv, jm.init_wkv)
    np.testing.assert_array_equal(tm.init_wkv, ts)
    jrow = JEngine(jm, max_batch=2, token_chunk_size=8,
                   state_dtype=jnp.float32).fresh_row_state()
    trow = TEngine(tm, max_batch=2, token_chunk_size=8,
                   device="cpu").fresh_row_state()
    for k in jrow:
        np.testing.assert_array_equal(trow[k].numpy(), np.asarray(jrow[k]),
                                      err_msg=k)
    assert trow["wkv"].abs().max() > 0


def served_texts(server_cls, config_cls, toml, **kw):
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        config = config_cls.from_toml(str(toml))
        server = server_cls(config, **kw)
        req = config.to_reload_request(sandbox=False)
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
                    "sampler": {"type": "Nucleus", "top_k": 1},
                    "logit_bias": {"0": -1e4}})  # no end-of-text
                assert r.status == 200, await r.text()
                out.append((await r.json())["choices"][0]["text"])
            return out
        finally:
            await client.close()
            await server.middleware.unload()

    return asyncio.run(main())


@pytest.mark.parametrize("case", ["lora", "lora int8", "pth",
                                  "state-tuned"])
def test_served_equals_jax_server(tmp_path, monkeypatch, case):
    """A ``[[lora]]`` config (f32 and int8), a raw ``.pth`` and a
    state-tuned checkpoint served by the port give the JAX server's greedy
    text.  The port gives any quantized model an int8 LM head; the JAX
    side gets one through ``AI00_QUANT_HEAD=on`` (set here only)."""
    import json

    from ai00_server_tpu.server.app import Server as JServer
    from ai00_server_tpu.server.config import Config as JConfig

    from ai00_server_tpu_torch.server.app import Server
    from ai00_server_tpu_torch.server.config import Config

    info, raw, path = write_model(tmp_path)
    name = "model.st"
    lora = ""
    if case.startswith("lora"):
        lora_path, _ = write_lora(tmp_path, info)
        lora = f'[[lora]]\npath = "{lora_path}"\nalpha = 16.0\n'
    if case == "pth":
        _, pth = write_pth(tmp_path, "V6", seed=19)
        name = "model.pth"
    if case == "state-tuned":
        conv = to_converted_layout(raw)
        H, N = info.num_head, info.head_size
        ts = np.random.default_rng(2).standard_normal(
            (info.num_layer, H, N, N)).astype(np.float32)
        for i in range(info.num_layer):
            conv[f"blocks.{i}.att.time_state"] = np.swapaxes(ts[i], -1, -2)
        jloader.save_safetensors(conv, str(tmp_path / "tuned.st"),
                                 dtype=np.float32)
        name = "tuned.st"
    vocab = {str(i): chr(64 + i) for i in range(1, 60)}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    toml = tmp_path / "Config.toml"
    toml.write_text(f"""
[model]
name = "{name}"
path = "{tmp_path}"
max_batch = 2
token_chunk_size = 8
precision = "Fp32"
quant = {2 if case == "lora int8" else 0}

{lora}
[tokenizer]
path = "{tmp_path / 'vocab.json'}"
""")
    if case == "lora int8":
        monkeypatch.setenv("AI00_QUANT_HEAD", "on")
    port = served_texts(Server, Config, toml, device="cpu")
    assert port == served_texts(JServer, JConfig, toml) and all(port)


def test_published_lora_ranks_load_and_equal_jax(tmp_path):
    """RWKV-7 World 0.4B's value-residual LoRA rank (32) is not its other
    ranks (64).  Layer 0 has no value residual; the port gives its zeros
    the other layers' rank, so the layers stack (the JAX loader gives them
    ``a1``'s rank and cannot stack them into one group).  The forward
    equals JAX's on one-layer groups (``group_sizes=[1, 1]``)."""
    from ai00_server_tpu_torch.models import ModelVersion as TVersion
    from ai00_server_tpu_torch.testing import make_raw_weights as tmake
    from ai00_server_tpu_torch.testing import tiny_info as ttiny

    tinfo = ttiny(TVersion.V7, **QUANT_INFO)
    raw = tmake(tinfo, seed=20, dtype=np.float32,
                lora_dims={"w": 16, "a": 16, "v": 8, "g": 32})
    path = str(tmp_path / "ranks.st")
    tloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    tm = tloader.load_model(path, dtype=torch.float32, device="cpu")
    assert tm.params["layers"][0]["att"]["v1"].shape == (128, 8)
    info = tiny_info(JVersion.V7, **QUANT_INFO)
    jparams = jloader.stack_params(
        info, jloader.to_math_layout(jloader.read_checkpoint(path)),
        dtype=jnp.float32, group_sizes=[1, 1])
    toks = np.arange(1, 7, dtype=np.int32)[None]
    jm_mod = jmodule(info.version)
    h_j, _ = jax.jit(jm_mod.forward)(
        jparams, jm_mod.init_state(info, 1, jnp.float32), jnp.asarray(toks),
        jnp.array([6], jnp.int32))
    tm_mod = tmodule(tm.info.version)
    h_t, _ = tm_mod.forward(tm.params, tm_mod.init_state(tm.info, 1),
                            torch.from_numpy(toks), torch.tensor([6]))
    close(h_t.numpy(), np.asarray(h_j))
