"""The port's RWKV-4 forward against the JAX package's, on tiny models.

The helpers of ``tests/test_torch_models_v5.py`` (one random model loaded
by the JAX loader, by the port's loader from the same ``.st`` file and by
``params_from_numpy``; a ragged prefill chunk and T=1 steps with an idle
row through both packages; chunked against full; the suffix mask; bf16; a
layer-0-quantized model) on RWKV-4, whose WKV here is
``ops/wkv4.wkv4_chunk`` (its plain version on CPU tensors) at every T.
The tolerances are that file's, for the reasons given there.

``wkv4_chunk_plain`` is also held against the JAX ``models/v4._wkv_scan``
itself, from a state whose rows are advanced, fresh (``pp = PP_INIT``) or
idle, in f32: rtol 1e-5 / atol 1e-6 (the same arithmetic; XLA and PyTorch
differ in the last bit of ``exp``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v4 as jv4

from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.models import v4 as tv4
from ai00_server_tpu_torch.ops.wkv4 import wkv4_chunk, wkv4_chunk_plain
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_torch_models_v5 import (bf16_equals_jax, chunked_equals_full,
                                  make_models, mixed_quantized_layer_path,
                                  params_equal_loader, prefill_then_decode,
                                  raw_weights_equal_jax, shape_of,
                                  suffix_mask_freezes_state)

cpu_test_threads()

V4 = ModelVersion.V4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_weights_equal_jax(dtype):
    raw_weights_equal_jax(V4, dtype)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return make_models(V4, tmp_path_factory)


def test_loader_round_trip(models):
    info, raw, path, jparams, tparams = models
    loaded = tparams["loaded"]
    assert shape_of(loaded.info) == shape_of(info)
    assert (loaded.info.num_head, loaded.info.head_size) == (32, 1)
    for i, p in enumerate(loaded.params["layers"]):
        att = p["att"]
        a = f"blocks.{i}.att."
        assert att["time_decay"].shape == (32,)
        assert att["time_first"].shape == (32,)
        np.testing.assert_array_equal(att["time_first"].numpy(),
                                      raw[a + "time_first"])
        assert set(att) == {"time_mix_k", "time_mix_v", "time_mix_r",
                            "time_decay", "time_first", "receptance", "key",
                            "value", "output"}
        assert set(p["ffn"]) == {"time_mix_k", "time_mix_r", "key",
                                 "receptance", "value"}
    params_equal_loader(jparams, tparams["carried"], tparams["file"])


def test_init_state_starts_pp_finite():
    from ai00_server_tpu_torch.testing import tiny_info

    info = tiny_info(V4, num_layer=2)
    state = tv4.init_state(info, 3, dtype=torch.bfloat16)
    assert set(state) == {"att_x", "aa", "bb", "pp", "ffn_x"}
    assert state["att_x"].dtype == torch.bfloat16
    for k in ("aa", "bb", "pp"):  # the recurrence is f32 whatever the dtype
        assert state[k].dtype == torch.float32
    assert tv4.PP_INIT == jv4.PP_INIT
    assert float(state["pp"].max()) == float(np.float32(jv4.PP_INIT))
    assert float(state["pp"].min()) == float(np.float32(jv4.PP_INIT))
    assert bool(torch.isfinite(state["pp"]).all())


@pytest.mark.parametrize("how", ["file", "carried"])
def test_ragged_prefill_then_decode(models, how):
    info, _, _, jparams, tparams = models
    prefill_then_decode(V4, info, jparams, tparams[how], seed=3)


def test_chunked_prefill_equals_full(models):
    info, _, _, _, tparams = models
    chunked_equals_full(V4, info, tparams["file"])


def test_suffix_mask_freezes_state(models):
    info, _, _, _, tparams = models
    suffix_mask_freezes_state(V4, info, tparams["file"])


def test_bf16_equals_jax():
    bf16_equals_jax(V4)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_mixed_quantized_layer_path(mode):
    mixed_quantized_layer_path(V4, mode, (
        ("att", "receptance"), ("att", "key"), ("att", "output"),
        ("ffn", "receptance"), ("ffn", "value")))


@pytest.mark.parametrize("T", [1, 9])
def test_wkv4_chunk_plain_equals_jax_scan(T):
    rng = np.random.default_rng(T)
    B, C = 4, 24

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    aa, bb, pp = rnd(B, C), np.abs(rnd(B, C)) + 0.5, rnd(B, C)
    aa[1], bb[1], pp[1] = 0.0, 0.0, jv4.PP_INIT  # a fresh row
    k, v = rnd(B, T, C), rnd(B, T, C)
    w, u = -np.exp(rnd(C, scale=0.5)), rnd(C, scale=0.5)
    mask = np.arange(T)[None, :] < np.array([T, T, 0, (T + 1) // 2])[:, None]
    (jaa, jbb, jpp), jy = jv4._wkv_scan(*(jnp.asarray(t) for t in (
        aa, bb, pp, k, v, w, u, mask)))
    ts = [torch.from_numpy(t) for t in (aa, bb, pp, k, v, w, u, mask)]
    (taa, tbb, tpp), ty = wkv4_chunk(*ts)  # CPU tensors: the plain version
    (paa, _, _), _ = wkv4_chunk_plain(*ts)
    assert torch.equal(taa, paa)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    for got, want, start in ((taa, jaa, aa), (tbb, jbb, bb), (tpp, jpp, pp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_array_equal(got.numpy()[2], start[2])  # idle row


def test_forward_dispatches_on_the_layout(monkeypatch):
    """models/v4.forward at T=1 takes ops/v4_decode with the layout
    installed, the layer path (``wkv4_chunk`` at T=1) without."""
    from ai00_server_tpu_torch.ops import fused_decode
    from ai00_server_tpu_torch.ops import v4_decode as tfd
    from ai00_server_tpu_torch.testing import (make_params, make_raw_weights,
                                               tiny_info)

    assert get_version_module(V4) is tv4
    assert fused_decode.module_for("V4") is tfd
    # No head-size rule: the tiny default width fuses.
    info = tiny_info(V4, num_layer=2)
    params = make_params(info, make_raw_weights(info, 2))
    assert tfd.can_fuse(params) and not tfd.supports(params)
    calls = []
    real = tfd.forward_t1
    monkeypatch.setattr(tfd, "forward_t1",
                        lambda *a: calls.append(1) or real(*a))
    B = 2
    t1 = torch.ones((B, 1), dtype=torch.int32)
    l1 = torch.ones(B, dtype=torch.int32)
    h_layer, _ = tv4.forward(params, tv4.init_state(info, B), t1, l1)
    assert not calls
    params[tfd.FUSED_KEY] = tfd.make_fused_layout(params)
    state = tv4.init_state(info, B)
    h_fused, out = tv4.forward(params, state, t1, l1)
    assert calls == [1] and out is state
    np.testing.assert_allclose(h_fused.numpy(), h_layer.numpy(), rtol=2e-4,
                               atol=2e-4)
