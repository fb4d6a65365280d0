"""The port's RWKV-6 forward against the JAX package's, on tiny f32 models.

One random v6 (``testing.make_raw_weights``: the port's copy draws the same
arrays as the JAX package's for equal seeds) is loaded three ways: the JAX
loader, the port's loader (from the same ``.st`` file) and
``params_from_numpy`` (the JAX params carried across).  The same tokens go
through ``ai00_server_tpu.models.v6.forward`` and the port's ``forward`` on
CPU tensors: a ragged prefill chunk (``wkv56_chunk``'s plain version), then
T=1 steps with an idle row (``wkv56_t1``'s).  The same for models whose
first layer is int8 or nf4 (the layer path, ``matmul_int8_l`` /
``matmul_4bit_l`` on stacked codes).

Tolerances as the JAX package's own v4/v5/v6 tests use
(``tests/test_fused_decode_v456.py:54-58``): hidden rtol = atol = 2e-4,
states rtol 3e-3 / atol 2e-4.  Both sides compute in f32; the two
frameworks sum the products in different orders, and the decay
``exp(-exp(.))`` amplifies that in near-zero state entries.  With quantized
layers, as that file's quantized case (:146-151): hidden atol 5e-4, states
atol 1e-3 (the dequantized products reassociate too).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu import testing as jtesting
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v6 as jv6

from ai00_server_tpu_torch import loader as tloader
from ai00_server_tpu_torch import testing as ttesting
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.models import v6 as tv6
from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

HIDDEN = dict(rtol=2e-4, atol=2e-4)
STATE = dict(rtol=3e-3, atol=2e-4)
Q_HIDDEN = dict(rtol=2e-4, atol=5e-4)
Q_STATE = dict(rtol=3e-3, atol=1e-3)
V6 = ModelVersion.V6


def _info(**kw):
    return jtesting.tiny_info(V6, **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_weights_equal_jax(dtype):
    info = _info(num_layer=2)
    want = jtesting.make_raw_weights(info, seed=5, dtype=dtype)
    got = ttesting.make_raw_weights(ttesting.tiny_info(V6, num_layer=2),
                                    seed=5, dtype=dtype)
    assert list(got) == list(want)  # the same keys, drawn in the same order
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["blocks.1.att.time_mix_w1"].shape == (32, 5 * 8)
    # The ranks are arguments: RWKV-6 World 1B6 uses tm 32 and td 64.
    wide = ttesting.make_raw_weights(ttesting.tiny_info(V6, num_layer=1),
                                     lora_dims={"tm": 4, "td": 6})
    assert wide["blocks.0.att.time_mix_w2"].shape == (5, 4, 32)
    assert wide["blocks.0.att.time_decay_w1"].shape == (32, 6)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    info = _info()
    raw = jtesting.make_raw_weights(info, seed=11, dtype=np.float32)
    jparams = jtesting.make_params(info, raw, dtype=np.float32)
    path = str(tmp_path_factory.mktemp("m6") / "tiny6.st")
    jloader.save_safetensors(ttesting.to_converted_layout(raw), path,
                             dtype=np.float32)
    from_file = tloader.load_model(path, dtype=torch.float32, device="cpu")
    carried = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return info, raw, path, jparams, {"file": from_file, "carried": carried}


def test_loader_round_trip(models):
    info, raw, path, jparams, tparams = models
    loaded = tparams["file"]
    assert loaded.info.version == V6
    assert (loaded.info.num_head, loaded.info.head_size) == (2, 16)
    # The converter stores time_mix_w2 as (5, C, D) and time_mix_w1 as
    # (5D, C); the math layout is (5, D, C) and (C, 5D).
    on_disk = tloader.load_safetensors(path)
    assert on_disk["blocks.0.att.time_mix_w2"].shape == (5, 32, 8)
    assert on_disk["blocks.0.att.time_mix_w1"].shape == (40, 32)
    math = tloader.to_math_layout(on_disk)
    assert math["blocks.0.att.time_mix_w2"].shape == (5, 8, 32)
    # time_first / time_decay keep their shapes (no reshape to a vector).
    assert math["blocks.0.att.time_first"].shape == (2, 16)
    assert math["blocks.0.att.time_decay"].shape == (32,)
    for i, p in enumerate(loaded.params["layers"]):
        att, ffn = p["att"], p["ffn"]
        a = f"blocks.{i}.att."
        assert att["first"].shape == (info.num_head, info.head_size)
        np.testing.assert_array_equal(att["mix_w2"].numpy(),
                                      raw[a + "time_mix_w2"])
        np.testing.assert_array_equal(att["mix_w1"].numpy(),
                                      raw[a + "time_mix_w1"])
        np.testing.assert_array_equal(att["decay"].numpy(),
                                      raw[a + "time_decay"])
        np.testing.assert_array_equal(att["gate"].numpy(),
                                      raw[a + "gate.weight"])
        np.testing.assert_array_equal(
            ffn["receptance"].numpy(),
            raw[f"blocks.{i}.ffn.receptance.weight"])
        assert set(ffn) == {"mix_k", "mix_r", "key", "receptance", "value"}


def test_params_from_numpy_equals_the_loader(models):
    """``params_from_numpy`` on a JAX v6 tree gives the port loader's
    params, leaf for leaf."""
    _, _, _, jparams, tparams = models
    got, want = tparams["carried"], tparams["file"].params
    assert set(got) == set(want)
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for part in ("att", "ffn"):
            assert set(g[part]) == set(w[part])
            for k in w[part]:
                np.testing.assert_array_equal(g[part][k].numpy(),
                                              w[part][k].numpy(),
                                              err_msg=f"{i}.{part}.{k}")
    np.testing.assert_array_equal(got["emb"].numpy(), want["emb"].numpy())
    stacked = np.asarray(jparams["groups"][0]["layers"]["att"]["first"])
    np.testing.assert_array_equal(got["layers"][2]["att"]["first"].numpy(),
                                  stacked[2])


def _tokens(rng, info, B, T):
    return rng.integers(1, info.num_vocab, size=(B, T)).astype(np.int32)


def _run_jax(params, state, toks, lens):
    h, s = jv6.forward(params, state, jnp.asarray(toks), jnp.asarray(lens))
    return np.asarray(h), jax.tree.map(np.asarray, s)


def _run_torch(params, state, toks, lens):
    h, s = tv6.forward(params, state, torch.from_numpy(toks),
                       torch.from_numpy(lens))
    return h.numpy(), {k: v.numpy() for k, v in s.items()}


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _prefill_then_decode(info, jparams, params, seed, hidden=HIDDEN,
                         state=STATE):
    rng = np.random.default_rng(seed)
    B, T = 3, 7
    toks = _tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)
    js = jv6.init_state(info, B)
    ts = tv6.init_state(info, B)
    assert ts["wkv"].shape == (info.num_layer, B, info.num_head,
                               info.head_size, info.head_size)
    jh, js = _run_jax(jparams, js, toks, lens)
    th, ts = _run_torch(params, ts, toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    np.testing.assert_allclose(th[mask], jh[mask], **hidden)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **state)

    # T=1 decode with an idle row: its state must not move.
    for _ in range(3):
        t1 = _tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = _run_jax(jparams, js, t1, l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = _run_torch(params, _torch_state(ts), t1, l1)
        np.testing.assert_allclose(th[:2], jh[:2], **hidden)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], err_msg=k, **state)
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])


@pytest.mark.parametrize("how", ["file", "carried"])
def test_ragged_prefill_then_decode(models, how):
    info, _, _, jparams, tparams = models
    params = tparams[how]
    params = params.params if how == "file" else params
    _prefill_then_decode(info, jparams, params, seed=3)


def test_chunked_prefill_equals_full(models):
    info, _, _, _, tparams = models
    params = tparams["file"].params
    rng = np.random.default_rng(5)
    B, T = 2, 12
    toks = _tokens(rng, info, B, T)
    full = np.full(B, T, np.int32)
    h_full, s_full = _run_torch(params, tv6.init_state(info, B), toks, full)
    s = tv6.init_state(info, B)
    hs = []
    for lo, hi in ((0, 5), (5, T)):
        part = np.zeros((B, 8), np.int32)
        part[:, : hi - lo] = toks[:, lo:hi]
        h, s = tv6.forward(params, s, torch.from_numpy(part),
                           torch.full((B,), hi - lo, dtype=torch.int32))
        hs.append(h.numpy()[:, : hi - lo])
    np.testing.assert_allclose(np.concatenate(hs, 1), h_full, rtol=1e-5,
                               atol=1e-5)
    for k in s_full:
        np.testing.assert_allclose(s[k].numpy(), s_full[k], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_mixed_quantized_layer_path(mode):
    """Layer 0 quantized, the others plain: the JAX params carried across
    and the port's own loader give the same codes, and both forwards agree
    with the JAX forward on the layer path."""
    info = _info(num_layer=2, num_emb=128, head_size=64)
    raw = jtesting.make_raw_weights(info, seed=13, dtype=np.float32)
    jparams = jtesting.make_params(info, raw, dtype=np.float32,
                                   quant={0: mode})
    carried = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    own = ttesting.make_params(info, raw, quant={0: mode})
    for params in (carried, own):
        layer0, layer1 = params["layers"]
        for part, key in (("att", "gate"), ("ffn", "receptance"),
                          ("att", "output")):
            assert tquant.is_quantized(layer0[part][key])
            assert layer0[part][key].mode == mode
            assert not tquant.is_quantized(layer1[part][key])
    for part in ("att", "ffn"):
        for k, leaf in carried["layers"][0][part].items():
            if tquant.is_quantized(leaf):
                np.testing.assert_array_equal(leaf.q.numpy(),
                                              own["layers"][0][part][k].q
                                              .numpy())
    for params in (carried, own):
        _prefill_then_decode(info, jparams, params, seed=4, hidden=Q_HIDDEN,
                             state=Q_STATE)


def test_versions_served_and_refused():
    """Every version is served now: v5 and v4, once refused by name, get
    their modules, tiny infos, raw weights (the JAX draws), params and the
    JAX state's keys."""
    from ai00_server_tpu.models import v4 as jv4
    from ai00_server_tpu.models import v5 as jv5

    from ai00_server_tpu_torch.models import v4 as tv4
    from ai00_server_tpu_torch.models import v5 as tv5

    assert get_version_module(V6) is tv6
    for version, module, jmodule in ((ModelVersion.V5, tv5, jv5),
                                     (ModelVersion.V4, tv4, jv4)):
        assert get_version_module(version) is module
        info = ttesting.tiny_info(version)
        jinfo = jtesting.tiny_info(version)
        assert (info.num_head, info.head_size) == (jinfo.num_head,
                                                   jinfo.head_size)
        raw = ttesting.make_raw_weights(info)
        assert list(raw) == list(jtesting.make_raw_weights(jinfo))
        params = tloader.stack_params(info, raw, device="cpu")
        assert len(params["layers"]) == info.num_layer
        assert set(module.init_state(info, 1)) == set(
            jmodule.init_state(jinfo, 1))
    with pytest.raises(ValueError, match="unknown model version"):
        get_version_module("V3")
