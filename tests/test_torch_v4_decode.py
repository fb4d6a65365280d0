"""The port's fused RWKV-4 decode step against the JAX package's.

The helpers of ``tests/test_torch_v5_decode.py`` on RWKV-4: a tiny v4 (3
layers, C=128, vocab 64) through ``ai00_server_tpu.ops.v4_decode_pallas``
in interpret mode and through the port's ``ops/v4_decode`` on CPU tensors
(the kernels' plain versions), plain and with every layer's seven big
projections int8, nf4, sf4 or int4; tolerances as there.  ``v4_wkv_plain``
is held against the Pallas kernel's WKV lines, from a state with an
advanced, a fresh (``pp = PP_INIT``) and an idle row: f32 outputs 2e-6
relative (the last bit of ``exp``), the bf16 output one ulp (2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v4 as jv4
from ai00_server_tpu.ops import v4_decode_pallas as jfd4
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import v4_decode as tfd4

from test_torch_v5_decode import (CASES, JDT, TDT, as_torch, big_equal_jax,
                                  fused_equals_layer_path, make_pair, rel,
                                  step_with_inactive_row, three_step_chain,
                                  to_np)

V4 = ModelVersion.V4
C, V = 128, 64


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    return make_pair(V4, request.param)


def test_layout_equals_jax_array_for_array(pair):
    """The JAX layout's ``vecs`` rows: w, u (the port's ``vecs``), the three
    ``1 - mix`` rows (the port's ``mix``) and the channel mix's two (its
    ``fmix``), the last five in the activation dtype here, where the Pallas
    kernel rounds them."""
    _, _, jparams, tparams = pair
    jl, tl = jparams[jfd4.FUSED_KEY], tparams[tfd4.FUSED_KEY]
    for key in ("ln1", "ln2"):
        np.testing.assert_array_equal(
            to_np(tl[key]), np.asarray(jl[key].astype(jnp.float32)), key)
    jv = np.asarray(jl["vecs"])
    assert tl["vecs"].dtype == torch.float32
    # Row 0, -exp(time_decay): the two frameworks' exp differ in the last
    # bit now and then.
    np.testing.assert_allclose(tl["vecs"].numpy()[:, 0], jv[:, 0], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(tl["vecs"].numpy()[:, 1], jv[:, 1])
    np.testing.assert_array_equal(to_np(tl["mix"]), jv[:, 2:5])
    np.testing.assert_array_equal(to_np(tl["fmix"]), jv[:, 5:7])
    big_equal_jax(tparams, jl, tl, tfd4._BIG_SRC)


def test_step_with_inactive_row_equals_jax(pair):
    step_with_inactive_row(V4, pair)


def test_three_step_chain_equals_jax(pair):
    three_step_chain(V4, pair)


def test_forward_dispatches_on_the_layout(monkeypatch):
    fused_equals_layer_path(V4, monkeypatch)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_wkv_plain_equals_kernel_lines(name):
    """v4_decode_pallas._kernel lines 142-166."""
    rng = np.random.default_rng(11)
    B, cd = 3, JDT[name]

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r = 1 / (1 + np.exp(-rnd(B, C)))
    k, v = rnd(B, C), rnd(B, C)
    vecs = np.stack([-np.exp(rnd(C, scale=0.5)), rnd(C, scale=0.5)])
    aa, bb, pp = rnd(B, C), np.abs(rnd(B, C)) + 0.5, rnd(B, C)
    aa[2], bb[2], pp[2] = 0.0, 0.0, jv4.PP_INIT  # a fresh row
    active = np.array([True, False, True])

    jw, ju = jnp.asarray(vecs[0:1]), jnp.asarray(vecs[1:2])
    jk, jvv = jnp.asarray(k), jnp.asarray(v)
    ww = ju + jk
    q = jnp.maximum(pp, ww)
    e1, e2 = jnp.exp(pp - q), jnp.exp(ww - q)
    wkv = (e1 * aa + e2 * jvv) / (e1 * bb + e2)
    ww2 = pp + jw
    q2 = jnp.maximum(ww2, jk)
    e1u, e2u = jnp.exp(ww2 - q2), jnp.exp(jk - q2)
    act = active[:, None]
    want_state = [np.asarray(jnp.where(act, e1u * aa + e2u * jvv, aa)),
                  np.asarray(jnp.where(act, e1u * bb + e2u, bb)),
                  np.asarray(jnp.where(act, q2, pp))]
    want = np.asarray((jnp.asarray(r) * wkv).astype(cd).astype(jnp.float32))

    state = [as_torch(t) for t in (aa, bb, pp)]
    got = tfd4.v4_wkv(as_torch(r), as_torch(k), as_torch(v), as_torch(vecs),
                      torch.from_numpy(active), *state, TDT[name])
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= (2e-6 if name == "float32" else 2.0 ** -7)
    for g, w, start in zip(state, want_state, (aa, bb, pp)):
        assert rel(g.numpy(), w) <= 2e-6
        np.testing.assert_array_equal(g.numpy()[1], start[1])  # inactive
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_can_fuse_is_about_the_model(mode):
    """No head-size rule (``v4_decode_pallas.py:48-61``); one dtype; the
    seven big projections uniformly plain or of one mode; a partly
    quantized model keeps to the layer path."""
    assert tfused.module_for("V4") is tfd4
    assert not tfd4.can_fuse({"layers": []})
    info = tiny_info(V4, num_layer=3, num_emb=C, num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)

    def both(quant):
        jp = make_params(info, raw, dtype=np.float32, quant=quant)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    jp, tp = both(None)
    assert jfd4.can_fuse(jp) and tfd4.can_fuse(tp)
    jp, tp = both({i: mode for i in range(3)})
    assert jfd4.can_fuse(jp) and tfd4.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd4._BIG_SRC) == mode
    layout = tfd4.make_fused_layout(tp)
    assert {"Wr_q", "frec_q", "frec_s"} <= set(layout)
    assert "Wg_q" not in layout  # v4 has no gate
    jp, tp = both({0: mode})
    assert not jfd4.can_fuse(jp) and not tfd4.can_fuse(tp)
