"""The port's fused RWKV-5 decode step against the JAX package's.

A tiny v5 (3 layers, C=128, head 64, vocab 64; weights and tokens from
numpy seeds) goes through ``ai00_server_tpu.ops.v5_decode_pallas`` — the
Pallas kernel itself, in interpret mode, as
``tests/test_fused_decode_v456.py`` runs it — and through the port's
``ops/v5_decode`` on CPU tensors, where every wrapper runs its kernel's plain
version.  The same with every layer's eight big projections int8, nf4, sf4
or int4, quantized by the JAX loader and carried across with
``params_from_numpy``, so both sides compute from the same codes.

Tolerances, relative to each tensor's largest magnitude:

* f32: 2e-5.  Both sides do the same arithmetic at the same rounding
  points; only the order of the sums in the products, the norms and the
  transcendental functions' last bits differ.
* bf16 weights and activations, f32 state: 2^-6 on the hidden and on the
  state per step (two bf16 ulps of the largest value; for a 3-step chain
  the bound grows by that much each step): the two frameworks sum each
  product in another order, which now and then moves a sum across a bf16
  rounding boundary, and LayerNorm, GroupNorm and the products carry it
  on, as in ``tests/test_torch_v6_decode.py``.  A wrong rounding point is
  held by the per-line tests below, where the same bf16 results are
  compared one rounding at a time (one ulp, 2^-7).

An inactive row's state must be bit-identical in every case.

``tests/test_torch_v4_decode.py`` runs the same helpers on RWKV-4.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v4 as jv4
from ai00_server_tpu.models import v5 as jv5
from ai00_server_tpu.models.common import GN_EPS
from ai00_server_tpu.ops import v4_decode_pallas as jfd4
from ai00_server_tpu.ops import v5_decode_pallas as jfd5
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import get_version_module
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import v4_decode as tfd4
from ai00_server_tpu_torch.ops import v5_decode as tfd5
from ai00_server_tpu_torch.ops import v6_decode as tfd6
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

L, C, N, V = 3, 128, 64, 64
TOL = {"float32": {"hidden": 2e-5, "state": 2e-5},
       "bfloat16": {"hidden": 2.0 ** -6, "state": 2.0 ** -6}}
CASES = ["float32", "bfloat16", "float32-int8", "bfloat16-int8",
         "float32-nf4", "bfloat16-nf4", "float32-sf4", "float32-int4"]
V5 = ModelVersion.V5
# version: (JAX model, JAX Pallas module, port module)
STACKS = {ModelVersion.V5: (jv5, jfd5, tfd5), ModelVersion.V4: (jv4, jfd4,
                                                                tfd4)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def as_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


@functools.lru_cache(maxsize=None)
def make_pair(version, case):
    """(dtype name, info, JAX params with layout, port params with layout)
    for a case ``"<dtype>"`` or ``"<dtype>-<mode>"``."""
    _, jfd, tfd = STACKS[version]
    name, _, mode = case.partition("-")
    info = tiny_info(version, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    jparams = make_params(info, raw, dtype=JDT[name],
                          quant={i: mode for i in range(L)} if mode else None)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert jfd.can_fuse(jparams) and tfd.can_fuse(tparams)
    jparams = dict(jparams)
    jparams[jfd.FUSED_KEY] = jfd.make_fused_layout(jparams)
    tparams[tfd.FUSED_KEY] = tfd.make_fused_layout(tparams)
    return name, info, jparams, tparams


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    return make_pair(V5, request.param)


def advanced_state(version, info, jparams, B, seed=0):
    """An f32 state after a 5-token prefill through the JAX layer path."""
    jmod, jfd, _ = STACKS[version]
    rng = np.random.default_rng(seed)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    toks = jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32)
    _, state = jax.jit(jmod.forward)(plain, jmod.init_state(info, B), toks,
                                     jnp.full((B,), 5, jnp.int32))
    return jax.tree.map(np.asarray, state)


def torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def big_equal_jax(tparams, jl, tl, big_src):
    """The big projections of the port's layout are the JAX layout's
    arrays (codes and scales as they are), each the params' own tensor."""
    quantized = "Wr_q" in jl
    assert quantized == ("Wr" not in tl)
    for name, (part, key) in big_src.items():
        for suffix in (("_q", "_s") if quantized else ("",)):
            got = torch.stack(tl[name + suffix])
            want = np.asarray(jl[name + suffix].astype(jnp.float32)
                              if not suffix else jl[name + suffix])
            np.testing.assert_array_equal(to_np(got).astype(want.dtype), want,
                                          name + suffix)
        leaf = tparams["layers"][1][part][key]
        if quantized:
            assert tl[name + "_q"][1].data_ptr() == leaf.qlin.q[1].data_ptr()
        else:
            assert tl[name][1] is leaf


def test_layout_equals_jax_array_for_array(pair):
    """The JAX layout keeps every per-channel row in f32 (``vecs``, and the
    four mixes in ``mix``); the port keeps the mixes rounded once to the
    activation dtype, where the Pallas kernel rounds them (``mix[i:i+1]
    .astype(cd)``), and the channel mix's two in ``fmix``."""
    name, _, jparams, tparams = pair
    jl, tl = jparams[jfd5.FUSED_KEY], tparams[tfd5.FUSED_KEY]
    cd = JDT[name]
    for key in ("ln1", "ln2"):
        np.testing.assert_array_equal(
            to_np(tl[key]), np.asarray(jl[key].astype(jnp.float32)), key)
    np.testing.assert_array_equal(
        to_np(tl["mix"]),
        np.asarray(jl["mix"].astype(cd).astype(jnp.float32)))
    jv = np.asarray(jl["vecs"])
    assert tl["vecs"].dtype == torch.float32
    # Row 0, exp(-exp(time_decay)): the two frameworks' exp differ in the
    # last bit now and then.
    np.testing.assert_allclose(tl["vecs"].numpy()[:, 0], jv[:, 0], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(tl["vecs"].numpy()[:, 1:], jv[:, 1:4])
    np.testing.assert_array_equal(to_np(tl["fmix"]), jv[:, 4:])
    big_equal_jax(tparams, jl, tl, tfd5._BIG_SRC)


def step_with_inactive_row(version, pair):
    name, info, jparams, tparams = pair
    _, jfd, tfd = STACKS[version]
    B = 4
    state = advanced_state(version, info, jparams, B)
    rng = np.random.default_rng(1)
    t1 = rng.integers(0, V, (B, 1)).astype(np.int32)
    l1 = np.array([1, 1, 0, 1], np.int32)
    jh, js = jfd.forward_t1(jparams, jax.tree.map(jnp.asarray, state),
                            jnp.asarray(t1), jnp.asarray(l1), interpret=True)
    ts = torch_state(state)
    th, ts_out = tfd.forward_t1(tparams, ts, torch.from_numpy(t1),
                                torch.from_numpy(l1))
    assert ts_out is ts  # updated in place
    assert th.shape == (B, 1, C) and str(th.dtype) == "torch." + name
    act = l1 > 0
    assert rel(to_np(th)[act], np.asarray(jh.astype(jnp.float32))[act]) \
        <= TOL[name]["hidden"]
    for k in state:
        assert rel(ts[k].numpy(), js[k]) <= TOL[name]["state"], k
        np.testing.assert_array_equal(ts[k].numpy()[:, 2], state[k][:, 2])
        assert not np.array_equal(ts[k].numpy()[:, 0], state[k][:, 0])


def test_step_with_inactive_row_equals_jax(pair):
    step_with_inactive_row(V5, pair)


def three_step_chain(version, pair):
    name, info, jparams, tparams = pair
    _, jfd, tfd = STACKS[version]
    B = 2
    state = advanced_state(version, info, jparams, B, seed=3)
    js = jax.tree.map(jnp.asarray, state)
    ts = torch_state(state)
    rng = np.random.default_rng(2)
    ones = np.ones(B, np.int32)
    for step in range(1, 4):
        t1 = rng.integers(0, V, (B, 1)).astype(np.int32)
        jh, js = jfd.forward_t1(jparams, js, jnp.asarray(t1),
                                jnp.asarray(ones), interpret=True)
        th, _ = tfd.forward_t1_plain(tparams, ts, torch.from_numpy(t1),
                                     torch.from_numpy(ones))
        assert rel(to_np(th), np.asarray(jh.astype(jnp.float32))) \
            <= step * TOL[name]["hidden"]
        for k in state:
            assert rel(ts[k].numpy(), js[k]) \
                <= step * TOL[name]["state"], (step, k)


def test_three_step_chain_equals_jax(pair):
    three_step_chain(V5, pair)


def fused_equals_layer_path(version, monkeypatch):
    """models/vN.forward at T=1: the fused path with the layout, the layer
    path without, and the two agree within the JAX package's own tolerances
    for its fused kernels (tests/test_fused_decode_v456.py:54-58)."""
    _, jfd, tfd = STACKS[version]
    _, info, jparams, tparams = make_pair(version, "float32")
    mod = get_version_module(version)
    B = 4
    state = advanced_state(version, info, jparams, B)
    t1 = torch.from_numpy(
        np.random.default_rng(1).integers(0, V, (B, 1)).astype(np.int32))
    l1 = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    calls = []
    real = tfd.forward_t1
    monkeypatch.setattr(tfd, "forward_t1",
                        lambda *a: calls.append(1) or real(*a))
    plain = {k: v for k, v in tparams.items() if k != tfd.FUSED_KEY}
    h_ref, s_ref = mod.forward(plain, torch_state(state), t1, l1)
    assert not calls
    s_fused = torch_state(state)
    h_f, s_f = mod.forward(tparams, s_fused, t1, l1)
    assert calls == [1] and s_f is s_fused
    np.testing.assert_allclose(h_f.numpy(), h_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    for k in s_ref:
        np.testing.assert_allclose(s_f[k].numpy(), s_ref[k].numpy(),
                                   rtol=3e-3, atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(s_f[k].numpy()[:, 2], state[k][:, 2])


def test_forward_dispatches_on_the_layout(monkeypatch):
    fused_equals_layer_path(V5, monkeypatch)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_wkv_gn_static_decay_plain_equals_kernel_lines(name):
    """``v6_wkv_gn_plain`` in its static-decay mode (``w=None``) against
    v5_decode_pallas._kernel lines 160-188, head by head."""
    rng = np.random.default_rng(9)
    B, H, cd = 3, C // N, JDT[name]

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = rnd(B, C)
    g = g / (1 + np.exp(-g))
    vecs = rnd(6, C, scale=0.5)  # the JAX layout's rows
    vecs[0] = np.exp(-np.exp(vecs[0]))
    S = rnd(B, H, N, N)
    active = np.array([True, False, True])

    def vec(nm):
        return vecs[jfd5._VEC_IDX[nm]][None]

    S_want, y_n = np.empty_like(S), np.empty((B, C), np.float32)
    for h in range(H):
        sl = slice(h * N, (h + 1) * N)
        s = S[:, h]
        a = k[:, sl][:, :, None] * v[:, sl][:, None, :]
        y_h = np.sum((s + vec("first")[:, sl][:, :, None] * a)
                     * r[:, sl][:, :, None], axis=1)
        S_want[:, h] = np.where(active[:, None, None],
                                vec("wdec")[:, sl][:, :, None] * s + a, s)
        y_n[:, sl] = (y_h - y_h.mean(-1, keepdims=True)) / np.sqrt(
            y_h.var(-1, keepdims=True) + GN_EPS)
    yf = jnp.asarray(y_n * vec("lnx_w") + vec("lnx_b")).astype(cd) \
        .astype(jnp.float32)
    want = np.asarray((yf * g).astype(cd).astype(jnp.float32))

    St = as_torch(S)
    got = tfd6.v6_wkv_gn(*(as_torch(t) for t in (r, k, v)), None,
                         as_torch(g), as_torch(vecs[:4]),
                         torch.from_numpy(active), St, TDT[name])
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= (2e-5 if name == "float32" else 2.0 ** -7)
    assert rel(St.numpy(), S_want) <= 2e-6
    np.testing.assert_array_equal(St.numpy()[1], S[1])
    # The mode is the dense kernel on the decay broadcast to every row.
    St2 = as_torch(S)
    dense = tfd6.v6_wkv_gn(*(as_torch(t) for t in (r, k, v)),
                           as_torch(np.broadcast_to(vecs[0], (B, C))),
                           as_torch(g), as_torch(vecs[:4]),
                           torch.from_numpy(active), St2, TDT[name])
    assert torch.equal(dense, got) and torch.equal(St2, St)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_can_fuse_is_about_the_model(mode):
    """A head size the kernels take, one dtype, the eight big projections
    uniformly plain or uniformly of one mode; a model whose layers are
    partly quantized keeps to the layer path (JAX: more than one layer
    group)."""
    info = tiny_info(V5, num_layer=2, num_emb=48, head_size=12, num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)
    small_heads = params_from_numpy(
        jax.tree.map(np.asarray, make_params(info, raw, dtype=np.float32)),
        "cpu")
    # the kernels take N % 8 == 0, 8 <= N <= 128
    assert not tfd5.can_fuse(small_heads)
    assert not tfd5.can_fuse({"layers": []})
    assert tfused.module_for("V5") is tfd5
    # A v4 or v6 model is not a v5 one, and the other way round.
    assert not tfd5.can_fuse(make_pair(ModelVersion.V4, "float32")[3])
    assert not tfd4.can_fuse(make_pair(V5, "float32")[3])
    assert not tfd6.can_fuse(make_pair(V5, "float32")[3])
    info = tiny_info(V5, num_layer=L, num_emb=C, head_size=N, num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)

    def both(quant):
        jp = make_params(info, raw, dtype=np.float32, quant=quant)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    jp, tp = both({i: mode for i in range(L)})
    assert jfd5.can_fuse(jp) and tfd5.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd5._BIG_SRC) == mode
    assert {"Wg_q", "frec_q", "frec_s"} <= set(tfd5.make_fused_layout(tp))
    jp, tp = both({0: mode})
    assert not jfd5.can_fuse(jp) and not tfd5.can_fuse(tp)
