"""The port's RWKV-5 forward against the JAX package's, on tiny models.

One random v5 (``testing.make_raw_weights``: the port's copy draws the same
arrays as the JAX package's for equal seeds) is loaded three ways: the JAX
loader, the port's loader (from the same ``.st`` file) and
``params_from_numpy`` (the JAX params carried across).  The same tokens go
through ``ai00_server_tpu.models.v5.forward`` and the port's ``forward`` on
CPU tensors: a ragged prefill chunk (``wkv56_chunk``'s plain version on
the static (H, N) decay), then T=1 steps with an idle row
(``wkv56_t1``'s).  The same for models whose first layer is int8 or nf4 (the
layer path on stacked codes), and in bf16.

Tolerances as the JAX package's own v4/v5/v6 tests use
(``tests/test_fused_decode_v456.py:54-58``): hidden rtol = atol = 2e-4,
states rtol 3e-3 / atol 2e-4 in f32 (the two frameworks sum the products in
different orders); with quantized layers, as that file's quantized case
(:146-151), hidden atol 5e-4 and states atol 1e-3.  bf16 weights and
activations: 2^-4 of each tensor's largest magnitude.  Each op of a layer
(``linear``, the norms, the token shift, the WKV) gives the JAX op's bits
when the two are run one by one, but XLA compiles the layer scan into
fusions that drop some of the bf16 roundings between ops (and expands a
bf16 sigmoid as ``1 / (1 + exp(-x))`` rounded at each step), so single
ulps differ and three layers of weights at std 0.4 carry them on: measured
at most 0.039 over 12 seeds of v5 and v4, prefill and three decode steps.

``tests/test_torch_models_v4.py`` runs the same helpers on RWKV-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu import testing as jtesting
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v4 as jv4
from ai00_server_tpu.models import v5 as jv5

from ai00_server_tpu_torch import loader as tloader
from ai00_server_tpu_torch import testing as ttesting
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

HIDDEN = dict(rtol=2e-4, atol=2e-4)
STATE = dict(rtol=3e-3, atol=2e-4)
Q_HIDDEN = dict(rtol=2e-4, atol=5e-4)
Q_STATE = dict(rtol=3e-3, atol=1e-3)
BF16_REL = 2.0 ** -4
V5 = ModelVersion.V5
JAX_MODULES = {ModelVersion.V5: jv5, ModelVersion.V4: jv4}


def shape_of(info):
    """A ModelInfo's fields, comparable across the two packages."""
    return (info.version.value, info.num_layer, info.num_emb,
            info.num_hidden, info.num_vocab, info.num_head, info.head_size)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def raw_weights_equal_jax(version, dtype):
    info = jtesting.tiny_info(version, num_layer=2)
    want = jtesting.make_raw_weights(info, seed=5, dtype=dtype)
    tinfo = ttesting.tiny_info(version, num_layer=2)
    assert shape_of(tinfo) == shape_of(info)
    got = ttesting.make_raw_weights(tinfo, seed=5, dtype=dtype)
    assert list(got) == list(want)  # the same keys, drawn in the same order
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_weights_equal_jax(dtype):
    raw_weights_equal_jax(V5, dtype)


def make_models(version, tmp_path_factory):
    info = jtesting.tiny_info(version)
    raw = jtesting.make_raw_weights(info, seed=11, dtype=np.float32)
    jparams = jtesting.make_params(info, raw, dtype=np.float32)
    path = str(tmp_path_factory.mktemp(version.value) / "tiny.st")
    jloader.save_safetensors(ttesting.to_converted_layout(raw), path,
                             dtype=np.float32)
    from_file = tloader.load_model(path, dtype=torch.float32, device="cpu")
    carried = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return info, raw, path, jparams, {"file": from_file.params,
                                      "carried": carried,
                                      "loaded": from_file}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(V5, tmp_path_factory)


def params_equal_loader(jparams, got, want):
    """``params_from_numpy`` on a JAX tree gives the port loader's params,
    leaf for leaf."""
    assert set(got) == set(want)
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for part in ("att", "ffn"):
            assert set(g[part]) == set(w[part])
            for k in w[part]:
                np.testing.assert_array_equal(g[part][k].numpy(),
                                              w[part][k].numpy(),
                                              err_msg=f"{i}.{part}.{k}")
    np.testing.assert_array_equal(got["emb"].numpy(), want["emb"].numpy())
    stacked = np.asarray(jparams["groups"][0]["layers"]["att"]["time_first"])
    np.testing.assert_array_equal(
        got["layers"][2]["att"]["time_first"].numpy(), stacked[2])


def test_loader_round_trip(models):
    info, raw, path, jparams, tparams = models
    loaded = tparams["loaded"]
    assert shape_of(loaded.info) == shape_of(info)
    assert (loaded.info.num_head, loaded.info.head_size) == (2, 16)
    for i, p in enumerate(loaded.params["layers"]):
        att, ffn = p["att"], p["ffn"]
        a = f"blocks.{i}.att."
        assert att["time_decay"].shape == (2, 16)
        assert att["time_first"].shape == (2, 16)
        np.testing.assert_array_equal(att["time_decay"].numpy(),
                                      raw[a + "time_decay"])
        np.testing.assert_array_equal(att["gate"].numpy(),
                                      raw[a + "gate.weight"])
        np.testing.assert_array_equal(att["ln_x_w"].numpy(),
                                      raw[a + "ln_x.weight"])
        assert set(att) == {"time_mix_k", "time_mix_v", "time_mix_r",
                            "time_mix_g", "time_decay", "time_first",
                            "receptance", "key", "value", "gate", "output",
                            "ln_x_w", "ln_x_b"}
        assert set(ffn) == {"time_mix_k", "time_mix_r", "key", "receptance",
                            "value"}
    params_equal_loader(jparams, tparams["carried"], tparams["file"])


def tokens(rng, info, B, T):
    return rng.integers(1, info.num_vocab, size=(B, T)).astype(np.int32)


def run_jax(version, params, state, toks, lens):
    h, s = JAX_MODULES[version].forward(params, state, jnp.asarray(toks),
                                        jnp.asarray(lens))
    return (np.asarray(h.astype(jnp.float32)),
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), s))


def run_torch(version, params, state, toks, lens):
    h, s = get_version_module(version).forward(
        params, state, torch.from_numpy(toks), torch.from_numpy(lens))
    return h.float().numpy(), {k: v.float().numpy() for k, v in s.items()}


def torch_state(state, like=None):
    return {k: torch.from_numpy(np.array(v)).to(
        like[k].dtype if like else torch.float32) for k, v in state.items()}


def prefill_then_decode(version, info, jparams, params, seed, hidden=HIDDEN,
                        state=STATE, bf16=False):
    """A ragged prefill chunk then three T=1 steps with an idle row, the
    port against the JAX forward; the idle row's state keeps its bits."""
    rng = np.random.default_rng(seed)
    B, T = 3, 7
    toks = tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)
    jmod, tmod = JAX_MODULES[version], get_version_module(version)
    js = jmod.init_state(info, B)
    ts = tmod.init_state(info, B)
    assert set(ts) == set(js)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape, k
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    jh, js = run_jax(version, jparams, js, toks, lens)
    th, ts = run_torch(version, params, ts, toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]

    def agree(got, want, tol, what):
        if bf16:
            assert rel(got, want) <= BF16_REL, what
        else:
            np.testing.assert_allclose(got, want, err_msg=what, **tol)

    agree(th[mask], jh[mask], hidden, "prefill hidden")
    for k in js:
        agree(ts[k], js[k], state, k)
    for _ in range(3):
        t1 = tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = run_jax(version, jparams, jax.tree.map(jnp.asarray, js), t1,
                         l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = run_torch(version, params, torch_state(ts), t1, l1)
        agree(th[:2], jh[:2], hidden, "decode hidden")
        for k in js:
            agree(ts[k], js[k], state, k)
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])


@pytest.mark.parametrize("how", ["file", "carried"])
def test_ragged_prefill_then_decode(models, how):
    info, _, _, jparams, tparams = models
    prefill_then_decode(V5, info, jparams, tparams[how], seed=3)


def chunked_equals_full(version, info, params):
    """Two chunks of a prefill (suffix-padded to 8) give the full chunk's
    hidden and state."""
    mod = get_version_module(version)
    rng = np.random.default_rng(5)
    B, T = 2, 12
    toks = tokens(rng, info, B, T)
    full = np.full(B, T, np.int32)
    h_full, s_full = run_torch(version, params, mod.init_state(info, B),
                               toks, full)
    s = mod.init_state(info, B)
    hs = []
    for lo, hi in ((0, 5), (5, T)):
        part = np.zeros((B, 8), np.int32)
        part[:, : hi - lo] = toks[:, lo:hi]
        h, s = mod.forward(params, s, torch.from_numpy(part),
                           torch.full((B,), hi - lo, dtype=torch.int32))
        hs.append(h.numpy()[:, : hi - lo])
    np.testing.assert_allclose(np.concatenate(hs, 1), h_full, rtol=1e-5,
                               atol=1e-5)
    for k in s_full:
        np.testing.assert_allclose(s[k].numpy(), s_full[k], rtol=1e-5,
                                   atol=1e-5)


def test_chunked_prefill_equals_full(models):
    info, _, _, _, tparams = models
    chunked_equals_full(V5, info, tparams["file"])


def suffix_mask_freezes_state(version, info, params):
    """A row whose chunk is padded after its length ends in the state of
    its valid prefix alone; a row of length 0 keeps its state bit for
    bit."""
    mod = get_version_module(version)
    rng = np.random.default_rng(8)
    B, T = 3, 6
    start = mod.init_state(info, B)
    _, start = mod.forward(params, start, torch.from_numpy(
        tokens(rng, info, B, 4)), torch.full((B,), 4, dtype=torch.int32))
    toks = tokens(rng, info, B, T)
    _, padded = mod.forward(params, {k: v.clone() for k, v in start.items()},
                            torch.from_numpy(toks),
                            torch.tensor([6, 3, 0], dtype=torch.int32))
    _, exact = mod.forward(params, {k: v[:, 1:2].clone()
                                    for k, v in start.items()},
                           torch.from_numpy(toks[1:2, :3]),
                           torch.tensor([3], dtype=torch.int32))
    for k in start:
        np.testing.assert_allclose(padded[k][:, 1].numpy(),
                                   exact[k][:, 0].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(padded[k][:, 2].numpy(),
                                      start[k][:, 2].numpy())
        assert not torch.equal(padded[k][:, 0], start[k][:, 0])


def test_suffix_mask_freezes_state(models):
    info, _, _, _, tparams = models
    suffix_mask_freezes_state(V5, info, tparams["file"])


def bf16_equals_jax(version):
    """bf16 weights and activations, f32 state, on both sides."""
    info = jtesting.tiny_info(version)
    raw = jtesting.make_raw_weights(info, seed=12, dtype=np.float32)
    jparams = jtesting.make_params(info, raw, dtype=jnp.bfloat16)
    tparams = ttesting.make_params(info, raw, dtype=torch.bfloat16)
    carried = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    for a, b in zip(tparams["layers"], carried["layers"]):
        for part in ("att", "ffn"):
            for k in a[part]:
                assert torch.equal(a[part][k], b[part][k]), k
    prefill_then_decode(version, info, jparams, tparams, seed=6, bf16=True)


def test_bf16_equals_jax():
    bf16_equals_jax(V5)


def mixed_quantized_layer_path(version, mode, keys):
    """Layer 0 quantized, the others plain: the JAX params carried across
    and the port's own loader give the same codes, and both forwards agree
    with the JAX forward on the layer path."""
    info = jtesting.tiny_info(version, num_layer=2, num_emb=128,
                              head_size=64)
    raw = jtesting.make_raw_weights(info, seed=13, dtype=np.float32)
    jparams = jtesting.make_params(info, raw, dtype=np.float32,
                                   quant={0: mode})
    carried = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    own = ttesting.make_params(info, raw, quant={0: mode})
    for params in (carried, own):
        layer0, layer1 = params["layers"]
        for part, key in keys:
            assert tquant.is_quantized(layer0[part][key])
            assert layer0[part][key].mode == mode
            assert not tquant.is_quantized(layer1[part][key])
    for part, key in keys:
        np.testing.assert_array_equal(
            carried["layers"][0][part][key].q.numpy(),
            own["layers"][0][part][key].q.numpy())
    for params in (carried, own):
        prefill_then_decode(version, info, jparams, params, seed=4,
                            hidden=Q_HIDDEN, state=Q_STATE)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_mixed_quantized_layer_path(mode):
    mixed_quantized_layer_path(V5, mode, (
        ("att", "receptance"), ("att", "gate"), ("att", "output"),
        ("ffn", "receptance"), ("ffn", "value")))


def test_forward_dispatches_on_the_layout(monkeypatch):
    """models/v5.forward at T=1 takes ops/v5_decode with the layout
    installed, the layer path without; T > 1 keeps to the layer path."""
    from ai00_server_tpu_torch.models import v5 as tv5
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import v5_decode as tfd

    assert get_version_module(V5) is tv5
    assert fused_decode.module_for("V5") is tfd
    info = ttesting.tiny_info(V5, num_layer=2, num_emb=128, head_size=64)
    params = ttesting.make_params(info, ttesting.make_raw_weights(info, 2))
    assert tfd.can_fuse(params) and not tfd.supports(params)
    calls = []
    real = tfd.forward_t1
    monkeypatch.setattr(tfd, "forward_t1",
                        lambda *a: calls.append(1) or real(*a))
    B = 2
    t1 = torch.ones((B, 1), dtype=torch.int32)
    l1 = torch.ones(B, dtype=torch.int32)
    tv5.forward(params, tv5.init_state(info, B), t1, l1)
    assert not calls
    params[tfd.FUSED_KEY] = tfd.make_fused_layout(params)
    state = tv5.init_state(info, B)
    _, out = tv5.forward(params, state, t1, l1)
    assert calls == [1] and out is state
    tv5.forward(params, tv5.init_state(info, B), t1.repeat(1, 2), l1 * 2)
    assert calls == [1]
