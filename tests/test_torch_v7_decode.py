"""The port's fused RWKV-7 decode step against the JAX package's.

A tiny v7 (3 layers, C=128, head 64, vocab 64; weights and tokens from
numpy seeds) goes through ``ai00_server_tpu.ops.v7_decode_pallas`` — the
Pallas kernel itself, in interpret mode — and through the port's
``ops/v7_decode`` on CPU tensors, where every wrapper runs its kernel's
plain version.

Tolerances, relative to each tensor's largest magnitude:

* f32: 2e-5.  Both sides do the same arithmetic at the same rounding
  points; only the order of the sums in the products, the norms and the
  transcendental functions' last bits differ (measured ~2e-6).
* bf16 weights and activations, f32 state: 2^-7 on the hidden (one bf16
  ulp of the largest value), 2e-3 on the state.  A different summation
  order can move an f32 sum across a bf16 rounding boundary and flip one
  bf16 ulp of an activation, which the following layers carry on.  Here
  none flips (measured 0 on the hidden, ~3e-7 on the state); a wrong
  rounding point shows as whole percents.

The same in the kernel's int8 mode (``-int8`` cases): every layer's six big
projections quantized by the JAX loader (``quant={i: "int8"}``), the codes
and scales carried across with ``params_from_numpy``, so both sides compute
from the same codes; same tolerances (measured: f32 ~2e-6; bf16 0 on the
hidden).

The same in the kernel's 4-bit modes (``-nf4``, ``-int4`` cases; ``sf4``
differs from ``nf4`` only in its 16 levels and is held at the level of the
products, ``test_skinny_matmul_4bit_plain_equals_kernel_lines``): packed
codes from the JAX loader, carried across.  f32 as above.  In bf16 the first
step agrees exactly (measured 0 on hidden and state: the rounding points
are the kernel's), but from the second step of the chain single bf16 ulps
do flip (the two frameworks sum the products in different orders), so the
state's tolerance is one bf16 ulp of an activation per step, 2^-8 (measured
9.3e-3 after three steps), and the hidden's stays 2^-7.

An inactive row's state must be bit-identical in every case.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.models.common import GN_EPS, LN_EPS
from ai00_server_tpu.ops import fused_decode as jfdc
from ai00_server_tpu.ops import v7_decode_pallas as jfd
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import v7 as tv7
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import v7_decode as tfd
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

L, C, N, V = 3, 128, 64, 64
TOL = {"float32": {"hidden": 2e-5, "state": 2e-5},
       "bfloat16": {"hidden": 2.0 ** -7, "state": 2e-3}}
TOL_4BIT_BF16 = {"hidden": 2.0 ** -7, "state": 2.0 ** -8}


def tol(name, tparams):
    """The case's tolerances (module docstring)."""
    codes = tparams[tfd.FUSED_KEY].get("Wr_q")
    if name == "bfloat16" and codes and codes[0].dtype == torch.uint8:
        return TOL_4BIT_BF16
    return TOL[name]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@functools.lru_cache(maxsize=None)
def make_pair(case):
    """(dtype name, info, JAX params with layout, port params with layout)
    for a case ``"<dtype>"`` or ``"<dtype>-<mode>"`` (int8, nf4, int4)."""
    name, _, mode = case.partition("-")
    info = tiny_info(ModelVersion.V7, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
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
                                        "float32-nf4", "bfloat16-nf4",
                                        "float32-int4", "bfloat16-int4"])
def pair(request):
    return make_pair(request.param)


def advanced_state(info, jparams, B, seed=0):
    """An f32 state after a 5-token prefill through the JAX layer path."""
    rng = np.random.default_rng(seed)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    toks = jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32)
    _, state = jax.jit(jv7.forward)(plain, jv7.init_state(info, B), toks,
                                    jnp.full((B,), 5, jnp.int32))
    return jax.tree.map(np.asarray, state)


def torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def test_layout_equals_jax_array_for_array(pair):
    _, _, jparams, tparams = pair
    jl, tl = jparams[jfd.FUSED_KEY], tparams[tfd.FUSED_KEY]
    assert set(jl) == set(tl)
    quantized = "Wr_q" in jl
    for key in jfdc.expand_keys(jfd._FUSED_KEYS, jfd._BIG, jl):
        want = np.asarray(jl[key].astype(jnp.float32))
        got = tl[key]
        if isinstance(got, list):
            layer = [p["att" if key[0] in "Wwavg" else "ffn"]
                     for p in tparams["layers"]]
            if key[-2:] in ("_q", "_s"):
                # Views into the group's stacked codes / scales: no copy.
                part, name = jfd._BIG_SRC[key[:-2]]
                qlin = tparams["layers"][0][part][name].qlin
                whole = qlin.q if key.endswith("_q") else qlin.scale
                assert all(t.data_ptr() == whole[i].data_ptr()
                           for i, t in enumerate(got)), key
            else:  # the params' own per-layer tensors
                assert all(any(t is v for v in p.values())
                           for t, p in zip(got, layer)), key
            got = torch.stack(got)
        assert str(got.dtype) == "torch." + str(jl[key].dtype), key
        np.testing.assert_array_equal(to_np(got), want, err_msg=key)
    assert tl["vecs"].dtype == torch.float32
    assert quantized == ("Wr" not in tl)


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
        <= tol(name, tparams)["hidden"]
    for k in state:
        assert rel(ts[k].numpy(), js[k]) <= tol(name, tparams)["state"], k
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
    for _ in range(3):
        t1 = rng.integers(0, V, (B, 1)).astype(np.int32)
        jh, js = jfd.forward_t1(jparams, js, jnp.asarray(t1),
                                jnp.asarray(ones), interpret=True)
        th, _ = tfd.forward_t1_plain(tparams, ts, torch.from_numpy(t1),
                                     torch.from_numpy(ones))
        assert rel(to_np(th), np.asarray(jh.astype(jnp.float32))) \
            <= 3 * tol(name, tparams)["hidden"]
    for k in state:
        assert rel(ts[k].numpy(), js[k]) <= 3 * tol(name, tparams)["state"], k


# ---------------------------------------------------------------------------
# Each plain kernel version against the matching lines of the Pallas kernel
# ---------------------------------------------------------------------------

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_mix", [6, 1])
def test_ln_mix_plain_equals_kernel_lines(name, n_mix):
    """v7_decode_pallas._kernel lines 175-186 and 251 (255-258, 263)."""
    rng = np.random.default_rng(n_mix)
    B, cd = 3, JDT[name]
    x = rng.standard_normal((B, C)).astype(np.float32) * 2
    prev = rng.standard_normal((B, C)).astype(np.float32)
    ln = jnp.asarray(1 + 0.1 * rng.standard_normal((2, C)), cd)
    mix = jnp.asarray(0.3 * rng.standard_normal((n_mix, C)), cd)
    active = np.array([True, False, True])

    lnv = jfd._ln(jnp.asarray(x), ln[0:1], ln[1:2], LN_EPS)
    xa, dx = lnv.astype(cd), (jnp.asarray(prev) - lnv).astype(cd)
    want = jnp.stack([xa + dx * mix[i:i + 1].astype(cd)
                      for i in range(n_mix)])
    want_shift = jnp.where(active[:, None], lnv, prev)

    shift = as_torch(prev)
    got = tfd.v7_ln_mix(as_torch(x), as_torch(ln, TDT[name]), shift,
                        as_torch(mix, TDT[name]), torch.from_numpy(active))
    assert got.shape == (n_mix, B, C) and got.dtype == TDT[name]
    # One ulp of the activation dtype: rsqrt / mean differ in their last bit.
    tol = 2e-6 if name == "float32" else 2.0 ** -7
    assert rel(to_np(got), np.asarray(want.astype(jnp.float32))) <= tol
    assert rel(shift.numpy(), want_shift) <= 2e-6
    np.testing.assert_array_equal(shift.numpy()[1], prev[1])


EPILOGUES = {
    # name -> (act, bias?, round_cd, out), the JAX lines it stands for
    "rkv": ("none", False, True, "f32"),          # :189-191
    "lora_down_tanh": ("tanh", False, False, "cd"),     # :193
    "lora_down_sigmoid": ("sigmoid", False, False, "cd"),  # :201
    "w_decay": ("wdecay", True, False, "f32"),    # :194-195
    "a_gate": ("sigmoid", True, True, "f32"),     # :198-199, :208-209
    "g": ("none", False, False, "f32"),           # :202
    "ffn_key": ("relu2", False, False, "cd"),     # :259-260
    "residual": ("none", False, False, "add"),    # :248-249, :261
}


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("epi", sorted(EPILOGUES))
def test_skinny_matmul_plain_equals_kernel_lines(name, epi):
    act, has_bias, round_cd, out = EPILOGUES[epi]
    rng = np.random.default_rng(len(epi))
    B, K, Nout, cd = 3, 96, 40, JDT[name]
    x = jnp.asarray(rng.standard_normal((B, K)), cd)
    W = jnp.asarray(0.2 * rng.standard_normal((K, Nout)), cd)
    bias = (0.5 * rng.standard_normal(Nout)).astype(np.float32)
    y0 = rng.standard_normal((B, Nout)).astype(np.float32)

    s = jnp.dot(x, W, preferred_element_type=jnp.float32)
    if has_bias:
        s = bias[None] + s
    s = {"none": lambda v: v, "tanh": jnp.tanh, "sigmoid": jax.nn.sigmoid,
         "wdecay": lambda v: jnp.exp(-jfd.W_SCALE * jax.nn.sigmoid(v)),
         "relu2": lambda v: jnp.square(jnp.maximum(v, 0.0))}[act](s)
    if out == "add":
        want = y0 + s
    elif out == "cd" or round_cd:
        want = s.astype(cd).astype(jnp.float32)
    else:
        want = s

    y = as_torch(y0)
    (got,) = tfd.v7_skinny_matmul([tfd.Product(
        as_torch(x, TDT[name]), as_torch(W, TDT[name]), act=act,
        bias=as_torch(bias) if has_bias else None, round_cd=round_cd,
        out=out, y=y if out == "add" else None)])
    assert got.dtype == (TDT[name] if out == "cd" else torch.float32)
    if out == "add":
        assert got is y  # added in place
    rounded = name == "bfloat16" and (out == "cd" or round_cd)
    # f32: the sum's order; rounded bf16: one ulp where that order flips it.
    assert rel(to_np(got), want) <= (2.0 ** -7 if rounded else 5e-6)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("epi", ["rkv", "ffn_key", "residual"])
def test_skinny_matmul_int8_plain_equals_kernel_lines(name, epi):
    """The same epilogues on int8 codes: the weight is what
    ``fused_decode.make_W`` hands the Pallas kernel (:106-117)."""
    from ai00_server_tpu.ops import quant as jquant

    act, _, round_cd, out = EPILOGUES[epi]
    rng = np.random.default_rng(len(epi))
    B, K, Nout, cd = 3, 256, 40, JDT[name]
    x = jnp.asarray(rng.standard_normal((B, K)), cd)
    jq = jquant.quantize_int8(
        (0.2 * rng.standard_normal((K, Nout))).astype(np.float32))
    y0 = rng.standard_normal((B, Nout)).astype(np.float32)

    W = jfdc.make_W({"W_q": jq.q[None], "W_s": jq.scale[None]}, "int8", None,
                    cd)("W")
    assert W.dtype == cd and W.shape == (K, Nout)
    s = jnp.dot(x, W, preferred_element_type=jnp.float32)
    if act == "relu2":
        s = jnp.square(jnp.maximum(s, 0.0))
    if out == "add":
        want = y0 + s
    else:
        want = s.astype(cd).astype(jnp.float32)

    y = as_torch(y0)
    (got,) = tfd.v7_skinny_matmul([tfd.Product(
        as_torch(x, TDT[name]), torch.from_numpy(np.array(jq.q)),
        scale=torch.from_numpy(np.array(jq.scale)), act=act,
        round_cd=round_cd, out=out, y=y if out == "add" else None)])
    assert got.dtype == (TDT[name] if out == "cd" else torch.float32)
    rounded = name == "bfloat16" and out != "add"
    assert rel(to_np(got), want) <= (2.0 ** -7 if rounded else 5e-6)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["nf4", "sf4", "int4"])
@pytest.mark.parametrize("epi", ["rkv", "ffn_key", "residual"])
def test_skinny_matmul_4bit_plain_equals_kernel_lines(name, mode, epi):
    """The same epilogues on packed 4-bit codes: the weight is what
    ``fused_decode.make_W`` hands the Pallas kernel (:118-121), with the
    table ``mode_packs`` gives it (:94-103)."""
    from ai00_server_tpu.ops import quant as jquant

    act, _, round_cd, out = EPILOGUES[epi]
    rng = np.random.default_rng(len(epi))
    B, K, Nout, cd = 3, 192, 40, JDT[name]
    x = jnp.asarray(rng.standard_normal((B, K)), cd)
    jq = jquant.QUANTIZERS[mode](
        (0.2 * rng.standard_normal((K, Nout))).astype(np.float32))
    y0 = rng.standard_normal((B, Nout)).astype(np.float32)

    packs = (jquant.pack_table8(jquant.NF4_TABLE8 if mode == "nf4"
                                else jquant.SF4_TABLE8)
             if mode != "int4" else None)
    W = jfdc.make_W({"W_q": jq.q[None], "W_s": jq.scale[None]}, mode, packs,
                    cd)("W")
    assert W.dtype == cd and W.shape == (K, Nout)
    s = jnp.dot(x, W, preferred_element_type=jnp.float32)
    if act == "relu2":
        s = jnp.square(jnp.maximum(s, 0.0))
    if out == "add":
        want = y0 + s
    else:
        want = s.astype(cd).astype(jnp.float32)

    y = as_torch(y0)
    prod = tfd.Product(
        as_torch(x, TDT[name]), torch.from_numpy(np.array(jq.q)),
        scale=torch.from_numpy(np.array(jq.scale)), mode=mode, act=act,
        round_cd=round_cd, out=out, y=y if out == "add" else None)
    assert prod.KN == (K, Nout)
    (got,) = tfd.v7_skinny_matmul([prod])
    assert got.dtype == (TDT[name] if out == "cd" else torch.float32)
    rounded = name == "bfloat16" and out != "add"
    assert rel(to_np(got), want) <= (2.0 ** -7 if rounded else 5e-6)


def test_product_mode_defaults():
    x, w = torch.zeros(1, 128), torch.zeros(128, 8)
    assert tfd.Product(x, w).weight_mode == "none"
    q, s = torch.zeros(1, 128, 8, dtype=torch.int8), torch.ones(1, 1, 8)
    assert tfd.Product(x, q, scale=s).weight_mode == "int8"
    assert tfd.Product(x, q, scale=s, mode="nf4").weight_mode == "nf4"
    late = tfd.Product(x, w)
    late.W, late.scale = q, s  # codes put in after construction
    assert late.weight_mode == "int8"


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_first", [True, False])
def test_wkv_gn_plain_equals_kernel_lines(name, is_first):
    """v7_decode_pallas._kernel lines 204-248, head by head."""
    rng = np.random.default_rng(int(is_first))
    B, H, cd = 3, C // N, JDT[name]

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
    w = np.exp(-jfd.W_SCALE / (1 + np.exp(-rnd(B, C)))).astype(np.float32)
    a, vmix = (1 / (1 + np.exp(-rnd(B, C))) for _ in range(2))
    vecs = rnd(8, C, scale=0.5)
    S = rnd(B, H, N, N)
    active = np.array([True, False, True])
    act = active[:, None]

    def vec(nm):
        return vecs[jfd._VEC_IDX[nm]][None]

    kk_full = k * vec("k_k")
    k2 = k * (1.0 + (a - 1.0) * vec("k_a"))
    v2 = v if is_first else v + (vf - v) * vmix
    rk = r * k2 * vec("r_k")
    wdec = np.where(act, w, 1.0)
    k2 = np.where(act, k2, 0.0)
    kk_full = np.where(act, kk_full, 0.0)
    S_want, y_n, bn = np.empty_like(S), np.empty((B, C)), np.empty((B, C))
    for h in range(H):
        sl = slice(h * N, (h + 1) * N)
        kk_h = jnp.asarray(kk_full[:, sl])
        kk_h = kk_h / jnp.maximum(
            jnp.sqrt(jnp.sum(kk_h * kk_h, axis=-1, keepdims=True)), 1e-12)
        kk_h = np.asarray(kk_h.astype(cd).astype(jnp.float32))
        s = S[:, h]
        skk = np.sum(s * kk_h[:, None, :], axis=-1)
        s_new = (s * wdec[:, sl][:, None, :]
                 - skk[:, :, None] * (kk_h * a[:, sl])[:, None, :]
                 + v2[:, sl][:, :, None] * k2[:, sl][:, None, :])
        S_want[:, h] = s_new
        y_h = np.sum(s_new * r[:, sl][:, None, :], axis=-1)
        y_n[:, sl] = (y_h - y_h.mean(-1, keepdims=True)) / np.sqrt(
            y_h.var(-1, keepdims=True) + GN_EPS)
        bn[:, sl] = np.sum(rk[:, sl], axis=-1, keepdims=True) * v2[:, sl]
    yf = (y_n * vec("lnx_w") + vec("lnx_b")) + bn
    want = np.asarray(jnp.asarray(yf * g, jnp.float32).astype(cd)
                      .astype(jnp.float32))

    St, vft = as_torch(S), as_torch(vf)
    got = tfd.v7_wkv_gn(*(as_torch(t) for t in (r, k, v, w, a, g, vmix)),
                        vft, as_torch(vecs), torch.from_numpy(active), St,
                        is_first, TDT[name])
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= (2e-5 if name == "float32" else 2.0 ** -7)
    assert rel(St.numpy(), S_want) <= 2e-6
    np.testing.assert_array_equal(St.numpy()[1], S[1])
    np.testing.assert_array_equal(vft.numpy(), v if is_first else vf)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_forward_dispatches_on_the_layout(monkeypatch):
    """models/v7.forward at T=1: the fused path with the layout, the layer
    path without, and the two agree within the JAX package's own tolerance
    for its fused kernel (tests/test_fused_decode.py:45-49)."""
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
    h_ref, s_ref = tv7.forward(plain, s_layer, t1, l1)
    assert not calls and s_ref is not s_layer
    s_fused = torch_state(state)
    h_f, s_f = tv7.forward(tparams, s_fused, t1, l1)
    assert calls == [1] and s_f is s_fused
    # T > 1 keeps to the layer path even with the layout installed.
    tv7.forward(tparams, torch_state(state), t1.repeat(1, 2), l1 * 2)
    assert calls == [1]

    np.testing.assert_allclose(h_f.numpy(), h_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    for k in s_ref:
        np.testing.assert_allclose(s_f[k].numpy(), s_ref[k].numpy(),
                                   rtol=3e-3, atol=2e-4, err_msg=k)
        np.testing.assert_array_equal(s_f[k].numpy()[:, 2], state[k][:, 2])


def test_can_fuse_is_about_the_model():
    info = tiny_info(ModelVersion.V7, num_layer=2, num_emb=48, head_size=12,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)
    small_heads = params_from_numpy(
        jax.tree.map(np.asarray, make_params(info, raw, dtype=np.float32)),
        "cpu")
    # the kernels take N % 8 == 0, 8 <= N <= 128
    assert not tfd.can_fuse(small_heads)
    assert not tfd.can_fuse({"layers": []})
    assert tfused.module_for("V7") is tfd
    keys = {tfused.module_for(v).FUSED_KEY for v in ("V7", "V6", "V5",
                                                      "V4")}
    assert len(keys) == 4  # v5 and v4, once refused by name, fuse too
    with pytest.raises(ValueError, match="unknown model version"):
        tfused.module_for("V3")


def test_can_fuse_uniform_int8_but_not_mixed():
    """As tests/test_fused_decode.py:81-93 holds the reference: uniformly
    int8 fuses, a model whose layers are partly int8 does not."""
    info = tiny_info(ModelVersion.V7, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)

    def both(quant):
        jp = make_params(info, raw, dtype=np.float32, quant=quant)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    jp, tp = both({i: "int8" for i in range(L)})
    assert jfd.can_fuse(jp) and tfd.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd._BIG_SRC) == "int8"
    jp, tp = both({0: "int8"})
    assert not jfd.can_fuse(jp) and not tfd.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd._BIG_SRC) == "int8"
    assert tfused.group_mode(tp["layers"][1], tfd._BIG_SRC) == "none"
    # One layer with only some of its projections quantized has no mode.
    from ai00_server_tpu_torch.ops import quant as tquant

    odd = {**tp["layers"][1], "att": dict(tp["layers"][1]["att"])}
    odd["att"]["key"] = tquant.QuantizedLayerView(
        tp["layers"][0]["att"]["key"].qlin, 0)
    assert tfused.group_mode(odd, tfd._BIG_SRC) is None
    assert not tfd.can_fuse({**tp, "layers": [odd]})


@pytest.mark.parametrize("mode", ["nf4", "sf4", "int4"])
def test_can_fuse_uniform_4bit_but_not_mixed(mode):
    """Uniformly nf4 / sf4 / int4 fuses, as in the reference; a model whose
    layers are partly 4-bit, or 4-bit in two modes, does not."""
    info = tiny_info(ModelVersion.V7, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=1, dtype=np.float32)

    def both(quant):
        jp = make_params(info, raw, dtype=np.float32, quant=quant)
        return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    jp, tp = both({i: mode for i in range(L)})
    assert jfd.can_fuse(jp) and tfd.can_fuse(tp)
    assert tfused.group_mode(tp["layers"][0], tfd._BIG_SRC) == mode
    layout = tfd.make_fused_layout(tp)
    assert layout["fkey_q"][1].dtype == torch.uint8
    assert tuple(layout["fkey_q"][1].shape) == (C // 64, 32, 4 * C)
    assert tuple(layout["fval_s"][1].shape) == (4 * C // 64, 1, C)
    jp, tp = both({0: mode})
    assert not jfd.can_fuse(jp) and not tfd.can_fuse(tp)
    other = "int4" if mode != "int4" else "sf4"
    jp, tp = both({0: mode, 1: other, 2: other})
    assert not jfd.can_fuse(jp) and not tfd.can_fuse(tp)
    assert [tfused.group_mode(p, tfd._BIG_SRC) for p in tp["layers"]] == [
        mode, other, other]
