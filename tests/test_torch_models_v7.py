"""The port's RWKV-7 forward against the JAX package's, on a tiny f32 model.

One random model (``ai00_server_tpu.testing.make_tiny_model``) is loaded
three ways: the JAX loader, the port's loader (from the same ``.st``
file) and ``params_from_numpy`` (the JAX params carried across).  The same
tokens go through ``ai00_server_tpu.models.v7.forward`` and the port's
``forward`` on CPU tensors.  Tolerance 2e-4 relative to each tensor's scale
in f32: the two frameworks sum the matmuls in different orders, and three
layers of LayerNorm/GroupNorm amplify that to a few 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch import loader as tloader
from ai00_server_tpu_torch import testing as ttesting
from ai00_server_tpu_torch.models import v7 as tv7
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_loader import to_converted_layout

cpu_test_threads()

RTOL = 2e-4


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (
        float(np.abs(got - want).max()), scale)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    info, raw, jparams = make_tiny_model(ModelVersion.V7, seed=11,
                                         dtype=np.float32)
    path = str(tmp_path_factory.mktemp("m") / "tiny.st")
    jloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    from_file = tloader.load_model(path, dtype=torch.float32, device="cpu")
    carried = tloader.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return info, jparams, {"file": from_file.params, "carried": carried}


def _tokens(rng, info, B, T):
    return rng.integers(1, info.num_vocab, size=(B, T)).astype(np.int32)


def _run_jax(params, state, toks, lens):
    h, s = jv7.forward(params, state, jnp.asarray(toks), jnp.asarray(lens))
    return np.asarray(h), jax.tree.map(np.asarray, s)


def _run_torch(params, state, toks, lens):
    h, s = tv7.forward(params, state, torch.from_numpy(toks),
                       torch.from_numpy(lens))
    return h.numpy(), {k: v.numpy() for k, v in s.items()}


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.mark.parametrize("how", ["file", "carried"])
def test_ragged_prefill_then_decode(models, how):
    info, jparams, tparams = models
    params = tparams[how]
    rng = np.random.default_rng(3)
    B, T = 3, 7
    toks = _tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)

    js = jv7.init_state(info, B)
    ts = tv7.init_state(info, B)
    jh, js = _run_jax(jparams, js, toks, lens)
    th, ts = _run_torch(params, ts, toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    close(th[mask], jh[mask])
    for k in js:
        close(ts[k], js[k])

    # T=1 decode with an idle row: its state must not move.
    for _ in range(3):
        t1 = _tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = _run_jax(jparams, js, t1, l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = _run_torch(params, _torch_state(ts), t1, l1)
        close(th[:2], jh[:2])
        for k in js:
            close(ts[k], js[k])
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])


def test_chunked_prefill_equals_full(models):
    info, _, tparams = models
    params = tparams["file"]
    rng = np.random.default_rng(5)
    B, T = 2, 12
    toks = _tokens(rng, info, B, T)
    full = np.full(B, T, np.int32)
    h_full, s_full = _run_torch(params, tv7.init_state(info, B), toks, full)

    s = tv7.init_state(info, B)
    hs = []
    for lo in (0, 5):
        hi = T if lo else 5
        part = np.zeros((B, 8), np.int32)
        part[:, : hi - lo] = toks[:, lo:hi]
        h, s = tv7.forward(params, s, torch.from_numpy(part),
                           torch.full((B,), hi - lo, dtype=torch.int32))
        hs.append(h.numpy()[:, : hi - lo])
    close(np.concatenate(hs, axis=1), h_full)
    for k in s_full:
        close(s[k].numpy(), s_full[k])


def test_port_testing_weights_equal_jax():
    from ai00_server_tpu.testing import make_raw_weights, tiny_info

    jinfo = tiny_info(ModelVersion.V7)
    tinfo = ttesting.tiny_info()
    for dtype in (np.float32, np.float64):
        want = make_raw_weights(jinfo, seed=4, dtype=dtype)
        got = ttesting.make_raw_weights(tinfo, seed=4, dtype=dtype)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# A mixed model: layers 0-1 int8, layer 2 plain, on the layer-by-layer path
# ---------------------------------------------------------------------------
#
# f32, so that the two ways to dequantize agree (the kernels' plain versions
# round the scale to the activation dtype first, ``dequant`` - which the JAX
# package takes on the CPU - multiplies in f32: the same weight in f32).
# Tolerance 2e-4 of each tensor's scale, as above.

MIXED_QUANT = {0: "int8", 1: "int8"}


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

    info = tiny_info(ModelVersion.V7, num_layer=3, num_emb=128, head_size=64,
                     num_vocab=64)
    raw = make_raw_weights(info, seed=12, dtype=np.float32)
    jparams = make_params(info, raw, dtype=np.float32, quant=MIXED_QUANT)
    path = str(tmp_path_factory.mktemp("q") / "tiny.st")
    jloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    return info, raw, jparams, {
        "file": tloader.load_model(path, dtype=torch.float32, device="cpu",
                                   quant=MIXED_QUANT).params,
        "carried": tloader.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"),
        "made": ttesting.make_params(ttesting.tiny_info(
            num_layer=3, num_emb=128, head_size=64, num_vocab=64), raw,
            torch.float32, quant=MIXED_QUANT),
    }


@pytest.mark.parametrize("how", ["file", "carried", "made"])
def test_mixed_params_hold_the_jax_codes(mixed, how):
    from ai00_server_tpu_torch.ops import quant as tquant

    _, _, jparams, tparams = mixed
    layers = tparams[how]["layers"]
    jq = jparams["groups"][0]["layers"]
    assert [g["layer_index"].shape[0] for g in jparams["groups"]] == [2, 1]
    for part, key in (("att", "receptance"), ("att", "key"), ("att", "value"),
                      ("att", "output"), ("ffn", "key"), ("ffn", "value")):
        views = [layers[i][part][key] for i in range(2)]
        assert all(isinstance(v, tquant.QuantizedLayerView) for v in views)
        assert views[0].qlin is views[1].qlin  # one stacked tensor per group
        assert [v.idx for v in views] == [0, 1]
        np.testing.assert_array_equal(views[0].qlin.q.numpy(),
                                      np.asarray(jq[part][key].q))
        np.testing.assert_array_equal(views[0].qlin.scale.numpy(),
                                      np.asarray(jq[part][key].scale))
        assert isinstance(layers[2][part][key], torch.Tensor)
    assert isinstance(layers[0]["att"]["w1"], torch.Tensor)


@pytest.mark.parametrize("impl", ["generic", "pallas_interpret"])
@pytest.mark.parametrize("how", ["file", "carried"])
def test_mixed_ragged_prefill_then_decode(mixed, how, impl, monkeypatch):
    """``impl``: the JAX side on its generic CPU path, or with its T=1
    kernels (``ffn7_t1_l``, ``wkv7_t1``) and the chunk kernel in interpret
    mode."""
    from ai00_server_tpu_torch.ops import ffn, quant_matmul

    if impl != "generic":
        monkeypatch.setenv("AI00_WKV_IMPL", impl)
    info, _, jparams, tparams = mixed
    params = tparams[how]
    calls = {"ffn": 0, "l": 0}
    real_ffn, real_l = ffn.ffn7_t1_l_plain, quant_matmul.matmul_int8_l_plain
    monkeypatch.setattr(ffn, "ffn7_t1_l_plain", lambda *a: (
        calls.__setitem__("ffn", calls["ffn"] + 1), real_ffn(*a))[1])
    monkeypatch.setattr(quant_matmul, "matmul_int8_l_plain", lambda *a: (
        calls.__setitem__("l", calls["l"] + 1), real_l(*a))[1])
    rng = np.random.default_rng(3)
    B, T = 3, 7
    toks = _tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)
    jh, js = _run_jax(jparams, jv7.init_state(info, B), toks, lens)
    th, ts = _run_torch(params, tv7.init_state(info, B), toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    close(th[mask], jh[mask])
    for k in js:
        close(ts[k], js[k])
    # 21 rows: under 512, so the int8 layers' 12 products took matmul_int8_l
    # (4 of the time mix and 2 of the channel mix, per layer) and no fused
    # channel mix ran at T > 1.
    assert calls == {"ffn": 0, "l": 12}

    for _ in range(2):
        t1 = _tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = _run_jax(jparams, js, t1, l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = _run_torch(params, _torch_state(ts), t1, l1)
        close(th[:2], jh[:2])
        for k in js:
            close(ts[k], js[k])
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])
    # T = 1: per int8 layer four matmul_int8_l and one ffn7_t1_l.
    assert calls == {"ffn": 4, "l": 12 + 16}


# ---------------------------------------------------------------------------
# The same with 4-bit layers: layers 0-1 nf4 / sf4 / int4, layer 2 plain
# ---------------------------------------------------------------------------
#
# f32 again, so ``dequant`` (the JAX package's generic CPU path and both
# packages' prefill) and the kernels' dequantize give the same weight.
# Tolerance 2e-4 of each tensor's scale, as above.


@pytest.fixture(scope="module", params=["nf4", "sf4", "int4"])
def mixed4(request, tmp_path_factory):
    from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

    mode = request.param
    quant = {0: mode, 1: mode}
    info = tiny_info(ModelVersion.V7, num_layer=3, num_emb=128, head_size=64,
                     num_vocab=64)
    raw = make_raw_weights(info, seed=13, dtype=np.float32)
    jparams = make_params(info, raw, dtype=np.float32, quant=quant)
    path = str(tmp_path_factory.mktemp("q4") / "tiny.st")
    jloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    return mode, info, jparams, {
        "file": tloader.load_model(path, dtype=torch.float32, device="cpu",
                                   quant=quant).params,
        "carried": tloader.params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"),
        "made": ttesting.make_params(ttesting.tiny_info(
            num_layer=3, num_emb=128, head_size=64, num_vocab=64), raw,
            torch.float32, quant=quant),
    }


@pytest.mark.parametrize("how", ["file", "carried", "made"])
def test_4bit_params_hold_the_jax_codes(mixed4, how):
    from ai00_server_tpu_torch.ops import quant as tquant

    mode, _, jparams, tparams = mixed4
    layers = tparams[how]["layers"]
    jq = jparams["groups"][0]["layers"]
    assert [g["layer_index"].shape[0] for g in jparams["groups"]] == [2, 1]
    for part, key in (("att", "receptance"), ("att", "key"), ("att", "value"),
                      ("att", "output"), ("ffn", "key"), ("ffn", "value")):
        views = [layers[i][part][key] for i in range(2)]
        assert all(isinstance(v, tquant.QuantizedLayerView) for v in views)
        assert views[0].qlin is views[1].qlin  # one stacked tensor per group
        assert views[0].mode == mode and views[0].q.dtype == torch.uint8
        assert views[0].shape == tuple(jq[part][key].shape)
        np.testing.assert_array_equal(views[0].qlin.q.numpy(),
                                      np.asarray(jq[part][key].q))
        np.testing.assert_array_equal(views[0].qlin.scale.numpy(),
                                      np.asarray(jq[part][key].scale))
        assert isinstance(layers[2][part][key], torch.Tensor)
    assert isinstance(layers[0]["att"]["w1"], torch.Tensor)


@pytest.mark.parametrize("impl", ["generic", "pallas_interpret"])
def test_4bit_ragged_prefill_then_decode(mixed4, impl, monkeypatch):
    """``impl``: the JAX side on its generic CPU path, or with its T=1
    kernels (``ffn7_t1_l`` in the 4-bit mode, ``wkv7_t1``) and the chunk
    kernel in interpret mode."""
    from ai00_server_tpu_torch.ops import ffn, quant_matmul

    if impl != "generic":
        monkeypatch.setenv("AI00_WKV_IMPL", impl)
    mode, info, jparams, tparams = mixed4
    params = tparams["file"]
    calls = {"ffn": [], "l": []}
    real_ffn, real_l = ffn.ffn7_t1_l_plain, quant_matmul.matmul_4bit_l_plain
    monkeypatch.setattr(ffn, "ffn7_t1_l_plain", lambda *a: (
        calls["ffn"].append(a[-1]), real_ffn(*a))[1])
    monkeypatch.setattr(quant_matmul, "matmul_4bit_l_plain", lambda *a: (
        calls["l"].append(a[-1]), real_l(*a))[1])
    rng = np.random.default_rng(3)
    B, T = 3, 7
    toks = _tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)
    jh, js = _run_jax(jparams, jv7.init_state(info, B), toks, lens)
    th, ts = _run_torch(params, tv7.init_state(info, B), toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    close(th[mask], jh[mask])
    for k in js:
        close(ts[k], js[k])
    # 21 rows: under 512, so the 4-bit layers' 12 products took
    # matmul_4bit_l and no fused channel mix ran at T > 1.
    assert len(calls["ffn"]) == 0 and len(calls["l"]) == 12

    for _ in range(2):
        t1 = _tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = _run_jax(jparams, js, t1, l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = _run_torch(params, _torch_state(ts), t1, l1)
        close(th[:2], jh[:2])
        for k in js:
            close(ts[k], js[k])
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])
    # T = 1: per 4-bit layer four matmul_4bit_l and one ffn7_t1_l, each told
    # the mode.
    assert len(calls["ffn"]) == 4 and len(calls["l"]) == 12 + 16
    assert set(calls["ffn"]) == set(calls["l"]) == {mode}


def test_unstacked_4bit_codes_take_matmul_4bit(mixed4, monkeypatch):
    """A layer whose big projections are unstacked ``QuantizedLinear`` nodes
    (no ``qlin``): ``linear`` sends every product to ``matmul_4bit`` and the
    channel mix takes its generic form; the result equals the stacked
    model's to 2e-4."""
    from ai00_server_tpu_torch.ops import quant as tquant
    from ai00_server_tpu_torch.ops import quant_matmul

    mode, info, _, tparams = mixed4
    params = tparams["made"]

    def unstack(node):
        if isinstance(node, dict):
            return {k: unstack(v) for k, v in node.items()}
        if isinstance(node, tquant.QuantizedLayerView):
            return tquant.QuantizedLinear(node.mode, node.q, node.scale,
                                          node.shape)
        return node

    flat = {**params, "layers": [unstack(p) for p in params["layers"]]}
    calls = []
    real = quant_matmul.matmul_4bit
    monkeypatch.setattr(quant_matmul, "matmul_4bit", lambda *a, mode: (
        calls.append(mode), real(*a, mode=mode))[1])
    rng = np.random.default_rng(8)
    B = 3
    toks, lens = _tokens(rng, info, B, 1), np.array([1, 0, 1], np.int32)
    h_ref, s_ref = _run_torch(params, tv7.init_state(info, B), toks, lens)
    assert not calls
    h, s = _run_torch(flat, tv7.init_state(info, B), toks, lens)
    assert calls == [mode] * 12  # six products in each of the two layers
    close(h[lens > 0], h_ref[lens > 0])
    for k in s_ref:
        close(s[k], s_ref[k])
