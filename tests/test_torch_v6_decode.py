"""The port's fused RWKV-6 decode step against the JAX package's.

A tiny v6 (3 layers, C=128, head 64, vocab 64; weights and tokens from
numpy seeds) goes through ``ai00_server_tpu.ops.v6_decode_pallas`` — the
Pallas kernel itself, in interpret mode — and through the port's
``ops/v6_decode`` on CPU tensors, where every wrapper runs its kernel's
plain version.  The same with every layer's eight big projections int8
(``-int8``) or nf4 (``-nf4``), quantized by the JAX loader and carried
across with ``params_from_numpy``, so both sides compute from the same
codes.

Tolerances, relative to each tensor's largest magnitude:

* f32: 2e-5.  Both sides do the same arithmetic at the same rounding
  points; only the order of the sums in the products, the norms and the
  transcendental functions' last bits differ (measured ~1e-6).
* bf16 weights and activations, f32 state: 2^-6 on the hidden and on the
  state per step (two bf16 ulps of the largest value; for a 3-step chain
  the bound grows by that much each step).  The two frameworks sum each
  f32 product in another order, which now and then moves a sum across a
  bf16 rounding boundary: a v6 layer rounds some twenty products per row,
  so over three layers a step flips one activation ulp in most seeds, and
  LayerNorm, GroupNorm and the decay ``exp(-exp(.))`` carry it into the
  hidden and the state (measured over 8 seeds and 3 steps: at most 1.1e-2,
  plain, int8 and nf4 alike; many steps agree bit for bit).  A wrong
  rounding point is held by the per-line tests below, where the same
  bf16 results are compared one rounding at a time (one ulp, 2^-7).

An inactive row's state must be bit-identical in every case.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v6 as jv6
from ai00_server_tpu.models.common import GN_EPS, LN_EPS
from ai00_server_tpu.ops import v6_decode_pallas as jfd
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import v6 as tv6
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import v6_decode as tfd
from ai00_server_tpu_torch.ops import v7_decode as tv7d

L, C, N, V = 3, 128, 64, 64
TOL = {"float32": {"hidden": 2e-5, "state": 2e-5},
       "bfloat16": {"hidden": 2.0 ** -6, "state": 2.0 ** -6}}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _info():
    return tiny_info(ModelVersion.V6, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)


@functools.lru_cache(maxsize=None)
def make_pair(case):
    """(dtype name, info, JAX params with layout, port params with layout)
    for a case ``"<dtype>"`` or ``"<dtype>-<mode>"`` (int8, nf4)."""
    name, _, mode = case.partition("-")
    info = _info()
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    jparams = make_params(info, raw, dtype=jdt,
                          quant={i: mode for i in range(L)} if mode else None)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert jfd.can_fuse(jparams) and tfd.can_fuse(tparams)
    jparams = dict(jparams)
    jparams[jfd.FUSED_KEY] = jfd.make_fused_layout(jparams)
    tparams[tfd.FUSED_KEY] = tfd.make_fused_layout(tparams)
    return name, info, jparams, tparams


@pytest.fixture(scope="module", params=["float32", "bfloat16",
                                        "float32-int8", "bfloat16-int8",
                                        "float32-nf4", "bfloat16-nf4"])
def pair(request):
    return make_pair(request.param)


def advanced_state(info, jparams, B, seed=0):
    """An f32 state after a 5-token prefill through the JAX layer path."""
    rng = np.random.default_rng(seed)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    toks = jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32)
    _, state = jax.jit(jv6.forward)(plain, jv6.init_state(info, B), toks,
                                    jnp.full((B,), 5, jnp.int32))
    return jax.tree.map(np.asarray, state)


def torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def test_layout_equals_jax_array_for_array(pair):
    """The port keeps the (C, 5D) token-shift LoRA whole where the TPU
    layout splits it per stage: each JAX stage is a slice of it."""
    _, _, jparams, tparams = pair
    jl, tl = jparams[jfd.FUSED_KEY], tparams[tfd.FUSED_KEY]
    quantized = "Wr_q" in jl
    assert quantized == ("Wr" not in tl)
    for key in ("mix", "ln1", "ln2"):
        np.testing.assert_array_equal(
            to_np(tl[key]), np.asarray(jl[key].astype(jnp.float32)), key)
    assert tl["vecs"].dtype == torch.float32
    # The JAX rows 4-5 (f32 copies of the channel mix's mixes) are the
    # port's fmix, kept in the activation dtype only.
    jv = np.asarray(jl["vecs"])
    np.testing.assert_array_equal(tl["vecs"].numpy(), jv[:, :4])
    np.testing.assert_array_equal(to_np(tl["fmix"]), jv[:, 4:])
    D = tl["mw2"][0].shape[1]
    for l in range(L):
        for f in range(5):
            np.testing.assert_array_equal(
                to_np(tl["mw1"][l][:, f * D:(f + 1) * D]),
                np.asarray(jl[f"mw1_{f}"][l].astype(jnp.float32)))
            np.testing.assert_array_equal(
                to_np(tl["mw2"][l][f]),
                np.asarray(jl[f"mw2_{f}"][l].astype(jnp.float32)))
        for key in ("dw1", "dw2"):
            np.testing.assert_array_equal(
                to_np(tl[key][l]), np.asarray(jl[key][l].astype(jnp.float32)))
        att = tparams["layers"][l]["att"]
        assert tl["mw1"][l] is att["mix_w1"]  # the params' own tensors
    for name, (part, key) in tfd._BIG_SRC.items():
        for suffix in (("_q", "_s") if quantized else ("",)):
            got = torch.stack(tl[name + suffix])
            want = np.asarray(jl[name + suffix].astype(jnp.float32)
                              if not suffix else jl[name + suffix])
            np.testing.assert_array_equal(to_np(got).astype(want.dtype), want,
                                          name + suffix)
        if quantized:
            qlin = tparams["layers"][0][part][key].qlin
            assert tl[name + "_q"][1].data_ptr() == qlin.q[1].data_ptr()


def test_step_with_inactive_row_equals_jax(pair):
    name, info, jparams, tparams = pair
    B = 4
    state = advanced_state(info, jparams, B)
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


def test_three_step_chain_equals_jax(pair):
    name, info, jparams, tparams = pair
    B = 2
    state = advanced_state(info, jparams, B, seed=3)
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


def test_bf16_tracks_the_f32_reference():
    """As tests/test_fused_decode_v456.py:84-113 bounds the Pallas kernel:
    the bf16 fused step tracks the f32 layer path at least as closely as
    the bf16 layer path does (the two round at different points)."""
    info = _info()
    raw = make_raw_weights(info, seed=6, dtype=np.float32)
    p32 = params_from_numpy(jax.tree.map(
        np.asarray, make_params(info, raw, dtype=np.float32)), "cpu")
    p16 = params_from_numpy(jax.tree.map(
        np.asarray, make_params(info, raw, dtype=jnp.bfloat16)), "cpu")
    B = 4
    state = advanced_state(info, make_params(info, raw, dtype=np.float32), B)
    rng = np.random.default_rng(3)
    t1 = torch.from_numpy(rng.integers(0, V, (B, 1)).astype(np.int32))
    l1 = torch.ones(B, dtype=torch.int32)
    h32, _ = tv6.forward(p32, torch_state(state), t1, l1)
    h16, _ = tv6.forward(p16, torch_state(state), t1, l1)
    p16[tfd.FUSED_KEY] = tfd.make_fused_layout(p16)
    hf, _ = tfd.forward_t1(p16, torch_state(state), t1, l1)
    err_layer = float((h16.float() - h32).abs().max())
    err_fused = float((hf.float() - h32).abs().max())
    assert err_fused <= max(err_layer * 1.5, 0.05), (err_fused, err_layer)


# ---------------------------------------------------------------------------
# Each plain kernel version against the matching lines of the Pallas kernel
# ---------------------------------------------------------------------------

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ln_mix_plain_equals_kernel_lines(name):
    """v6_decode_pallas._kernel lines 159-166 and 211."""
    rng = np.random.default_rng(5)
    B, cd = 3, JDT[name]
    x = rng.standard_normal((B, C)).astype(np.float32) * 2
    prev = rng.standard_normal((B, C)).astype(np.float32)
    ln = jnp.asarray(1 + 0.1 * rng.standard_normal((2, C)), cd)
    mix = jnp.asarray(0.3 * rng.standard_normal((1, C)), cd)
    active = np.array([True, False, True])

    lnv = jfd._ln(jnp.asarray(x), ln[0:1], ln[1:2], LN_EPS)
    xa, dx = lnv.astype(cd), (jnp.asarray(prev) - lnv).astype(cd)
    want = jnp.stack([xa, dx, xa + dx * mix[0:1].astype(cd)])
    want_shift = jnp.where(active[:, None], lnv, prev)

    shift = as_torch(prev)
    got = tv7d.v7_ln_mix(as_torch(x), as_torch(ln, TDT[name]), shift,
                         as_torch(mix, TDT[name]), torch.from_numpy(active),
                         with_xa_dx=True)
    assert got.shape == (3, B, C) and got.dtype == TDT[name]
    # One ulp of the activation dtype: rsqrt / mean differ in their last bit.
    tol = 2e-6 if name == "float32" else 2.0 ** -7
    assert rel(to_np(got), np.asarray(want.astype(jnp.float32))) <= tol
    assert rel(shift.numpy(), want_shift) <= 2e-6
    np.testing.assert_array_equal(shift.numpy()[1], prev[1])


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("epi", ["shift_combine", "silu_gate", "decay",
                                 "gated_residual"])
def test_skinny_matmul_v6_epilogues_equal_kernel_lines(name, epi):
    """The v6 epilogues of ``v7_skinny_matmul``: the token-shift combine
    (:170-176), g = SiLU in f32 (:181-182), the decay exp(-exp(decay +
    s)) (:185-186) and x += rf * s (:222-223); a strided input for the
    combine, as the stack reads its five stages."""
    rng = np.random.default_rng(len(epi))
    B, K, Nout, cd = 3, 40, 64, JDT[name]
    xw = jnp.asarray(rng.standard_normal((B, 5 * K)), cd)
    W = jnp.asarray(0.2 * rng.standard_normal((K, Nout)), cd)
    xa = jnp.asarray(rng.standard_normal((B, Nout)), cd)
    dx = jnp.asarray(rng.standard_normal((B, Nout)), cd)
    mix = jnp.asarray(0.3 * rng.standard_normal((1, Nout)), cd)
    bias = (0.5 * rng.standard_normal(Nout)).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.standard_normal((B, Nout))))).astype(
        np.float32)
    y0 = rng.standard_normal((B, Nout)).astype(np.float32)
    x = xw[:, 2 * K:3 * K]  # a strided view, as the stack's stage 2

    s = jnp.dot(x, W, preferred_element_type=jnp.float32)
    tx = as_torch(xw, TDT[name])[:, 2 * K:3 * K]
    assert not tx.is_contiguous()
    prod = tv7d.Product(tx, as_torch(W, TDT[name]))
    if epi == "shift_combine":
        want = xa + dx * (mix.astype(cd) + s.astype(cd))
        prod.out, prod.xa, prod.dx = "mix", as_torch(xa, TDT[name]), \
            as_torch(dx, TDT[name])
        prod.mix = as_torch(mix[0], TDT[name])
    elif epi == "silu_gate":
        want = s * jax.nn.sigmoid(s)
        prod.act, prod.out = "silu", "f32"
    elif epi == "decay":
        want = jnp.exp(-jnp.exp(bias[None] + s))
        prod.act, prod.out, prod.bias = "expexp", "f32", as_torch(bias)
    else:
        want = y0 + gate * s
        y = as_torch(y0)
        prod.out, prod.y, prod.gate = "gadd", y, as_torch(gate)
    (got,) = tv7d.v7_skinny_matmul([prod])
    if epi == "gated_residual":
        assert got is y  # added in place
    rounded = name == "bfloat16" and epi == "shift_combine"
    assert got.dtype == (TDT[name] if epi == "shift_combine"
                         else torch.float32)
    # f32: the sum's order; rounded bf16: one ulp where that order flips it.
    assert rel(to_np(got), np.asarray(want.astype(jnp.float32))) <= (
        2.0 ** -7 if rounded else 5e-6)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_wkv_gn_plain_equals_kernel_lines(name):
    """v6_decode_pallas._kernel lines 187-208, head by head."""
    rng = np.random.default_rng(9)
    B, H, cd = 3, C // N, JDT[name]

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = rnd(B, C)
    g = g / (1 + np.exp(-g))
    w = np.exp(-np.exp(rnd(B, C, scale=0.5))).astype(np.float32)
    vecs = rnd(6, C, scale=0.5)
    S = rnd(B, H, N, N)
    active = np.array([True, False, True])

    def vec(nm):
        return vecs[jfd._VEC_IDX[nm]][None]

    S_want, y_n = np.empty_like(S), np.empty((B, C), np.float32)
    for h in range(H):
        sl = slice(h * N, (h + 1) * N)
        s = S[:, h]
        a = k[:, sl][:, :, None] * v[:, sl][:, None, :]
        y_h = np.sum((s + vec("first")[:, sl][:, :, None] * a)
                     * r[:, sl][:, :, None], axis=1)
        S_want[:, h] = np.where(active[:, None, None],
                                w[:, sl][:, :, None] * s + a, s)
        y_n[:, sl] = (y_h - y_h.mean(-1, keepdims=True)) / np.sqrt(
            y_h.var(-1, keepdims=True) + GN_EPS)
    yf = jnp.asarray(y_n * vec("lnx_w") + vec("lnx_b")).astype(cd) \
        .astype(jnp.float32)
    want = np.asarray((yf * g).astype(cd).astype(jnp.float32))

    St = as_torch(S)
    got = tfd.v6_wkv_gn(*(as_torch(t) for t in (r, k, v, w, g)),
                        as_torch(vecs[:4]), torch.from_numpy(active), St,
                        TDT[name])
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= (2e-5 if name == "float32" else 2.0 ** -7)
    assert rel(St.numpy(), S_want) <= 2e-6
    np.testing.assert_array_equal(St.numpy()[1], S[1])


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_forward_dispatches_on_the_layout(monkeypatch):
    """models/v6.forward at T=1: the fused path with the layout, the layer
    path without, and the two agree within the JAX package's own tolerances
    for its fused kernel: hidden as tests/test_fused_decode_v456.py:54-55,
    states as :146-151 (atol 1e-3: the f32 sums run in another order on the
    two paths, and the decay exp(-exp(.)) amplifies that in near-zero state
    entries; measured 5.7e-4 on one entry of 98304)."""
    _, info, jparams, tparams = make_pair("float32")
    B = 4
    state = advanced_state(info, jparams, B)
    t1 = torch.from_numpy(
        np.random.default_rng(1).integers(0, V, (B, 1)).astype(np.int32))
    l1 = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    calls = []
    real = tfd.forward_t1
    monkeypatch.setattr(tfd, "forward_t1",
                        lambda *a: calls.append(1) or real(*a))

    plain = {k: v for k, v in tparams.items() if k != tfd.FUSED_KEY}
    assert not tfd.supports(plain) and tfd.supports(tparams)
    s_layer = torch_state(state)
    h_ref, s_ref = tv6.forward(plain, s_layer, t1, l1)
    assert not calls and s_ref is not s_layer
    s_fused = torch_state(state)
    h_f, s_f = tv6.forward(tparams, s_fused, t1, l1)
    assert calls == [1] and s_f is s_fused
    # T > 1 keeps to the layer path even with the layout installed.
    tv6.forward(tparams, torch_state(state), t1.repeat(1, 2), l1 * 2)
    assert calls == [1]

    np.testing.assert_allclose(h_f.numpy(), h_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    for k in s_ref:
        np.testing.assert_allclose(s_f[k].numpy(), s_ref[k].numpy(),
                                   rtol=3e-3, atol=1e-3, err_msg=k)
        np.testing.assert_array_equal(s_f[k].numpy()[:, 2], state[k][:, 2])


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_can_fuse_is_about_the_model(mode):
    """Head size 64, one dtype, the eight big projections uniformly plain
    or uniformly of one mode; a model whose layers are partly quantized
    keeps to the layer path (JAX: more than one layer group)."""
    info = tiny_info(ModelVersion.V6, num_layer=2, num_emb=64, head_size=16,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)
    small_heads = params_from_numpy(
        jax.tree.map(np.asarray, make_params(info, raw, dtype=np.float32)),
        "cpu")
    assert not tfd.can_fuse(small_heads)  # the kernels take head size 64
    assert not tfd.can_fuse({"layers": []})
    assert tfused.module_for("V6") is tfd
    assert not tfd.can_fuse(make_pair("float32")[3] | {"layers": [
        {"att": {"r_k": None}}]})  # a v7 layer is not a v6 one
    info = _info()
    raw = make_raw_weights(info, seed=1, dtype=np.float32)

    def both(quant):
        jp = make_params(info, raw, dtype=np.float32, quant=quant)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    jp, tp = both({i: mode for i in range(L)})
    assert jfd.can_fuse(jp) and tfd.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd._BIG_SRC) == mode
    layout = tfd.make_fused_layout(tp)
    assert {"Wg_q", "frec_q", "frec_s"} <= set(layout)
    jp, tp = both({0: mode})
    assert not jfd.can_fuse(jp) and not tfd.can_fuse(tp)
