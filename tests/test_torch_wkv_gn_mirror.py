"""The PyTorch mirrors of the decode WKV kernels' arithmetic
(``ops/v7_decode.v7_wkv_gn_mirror``, ``ops/v6_decode.v6_wkv_gn_mirror``) and
the orders of their sums, on the CPU.

Each sum helper (``halving_sum``, ``pair_sum``, ``quad_sum``) is held bit
for bit against a lane-by-lane replay of the kernels' shuffle trees in
numpy f32.  Each mirror is held, at several batch and head counts with
idle rows, against the JAX package's kernel lines (the Pallas decode
kernels' WKV and GroupNorm, computed with ``jax.numpy`` head by head) and
against the plain version.  Tolerances, relative to the largest magnitude:
the output 2e-5 in f32 and 2^-7 in bf16 (one ulp: another order of the f32
sums can move a value across a bf16 rounding boundary), the state 2e-6; an
inactive row's state and ``v_first`` exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models.common import GN_EPS
from ai00_server_tpu.ops import v7_decode_pallas as jfd
from ai00_server_tpu_torch.ops import v6_decode as tfd6
from ai00_server_tpu_torch.ops import v7_decode as tfd

N = 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, H, active rows): idle rows among them, one head, a wider batch.
SHAPES = [(3, 2, (True, False, True)), (1, 1, (True,)),
          (8, 4, (True, True, False, True, True, True, False, True))]
SHAPE_IDS = ["B3H2", "B1H1", "B8H4"]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def as_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def to_np(t):
    return t.float().numpy()


def out_tol(name):
    return 2e-5 if name == "float32" else 2.0 ** -7


# ---------------------------------------------------------------------------
# The orders of the sums, against the kernels' shuffle trees lane by lane
# ---------------------------------------------------------------------------


def shuffle_tree(vals, offsets):
    """Every lane of a warp adds the value of lane ``l ^ off`` for each
    ``off`` in turn (``__shfl_xor_sync``), in numpy f32: the lanes' results,
    one row per lane."""
    v = np.asarray(vals, np.float32).copy()
    lanes = np.arange(v.shape[-1])
    for off in offsets:
        v = (v + v[..., lanes ^ off]).astype(np.float32)
    return v


def _adversarial(seed, shape):
    """Values across many magnitudes, where the order of an f32 sum shows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * 2.0 ** rng.integers(-12, 12, shape)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_halving_sum_is_warp_sum_of_pairs(seed):
    """head_moments: lane l adds values l and l + 32, then warp_sum (lanes
    16 apart first, ... 1): every lane the same bits, those of
    halving_sum."""
    x = _adversarial(seed, (5, 64))
    lanes = shuffle_tree(x[:, :32] + x[:, 32:], (16, 8, 4, 2, 1))
    assert (lanes == lanes[:, :1]).all()
    got = tfd.halving_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, lanes[:, 0])


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
def test_pair_sum_is_the_xor_tree_from_one(lanes):
    """The row group sums (lanes xor 1, 2, 4, 8) give pair_sum's bits in
    every lane."""
    x = _adversarial(lanes, (7, lanes))
    out = shuffle_tree(x, [1 << i for i in range(lanes.bit_length() - 1)])
    assert (out == out[:, :1]).all()
    np.testing.assert_array_equal(
        tfd.pair_sum(torch.from_numpy(x)).numpy(), out[:, 0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quad_sum_is_the_v7_kernels_order(seed):
    """v7's norm and bonus: thread cq adds its channels 4 cq .. 4 cq + 3 as
    (e0 + e1) + (e2 + e3), then the 16 threads of a row group xor 1, 2, 4,
    8; the squares of the norm are not fused into the sums."""
    x = _adversarial(seed, (4, 64))
    t = x.reshape(4, 16, 4)
    own = ((t[..., 0] + t[..., 1]).astype(np.float32)
           + (t[..., 2] + t[..., 3]).astype(np.float32)).astype(np.float32)
    out = shuffle_tree(own, (1, 2, 4, 8))
    assert (out == out[:, :1]).all()
    np.testing.assert_array_equal(
        tfd.quad_sum(torch.from_numpy(x)).numpy(), out[:, 0])


def test_v6_y_tree_is_the_kernels_order():
    """v6's partial y: 16 row groups of four k rows, each group's rows
    added in order, then the groups xor 1 (the two of a warp), then the
    eight warps in pairs - pair_sum over the 16 groups."""
    x = _adversarial(5, (3, 64))
    t = x.reshape(3, 16, 4)
    own = (((t[..., 0] + t[..., 1]).astype(np.float32) + t[..., 2])
           .astype(np.float32) + t[..., 3]).astype(np.float32)
    warps = shuffle_tree(own, (1,))[:, 0::2]
    while warps.shape[-1] > 1:
        warps = (warps[:, 0::2] + warps[:, 1::2]).astype(np.float32)
    part = torch.from_numpy(own)
    np.testing.assert_array_equal(tfd.pair_sum(part).numpy(), warps[:, 0])


def test_halving_sum_is_the_kernels_tree():
    """Element i plus element i + n/2 first (the lanes 16 apart of a warp
    after each lane added its two values), down to one."""
    x = torch.tensor([2.0 ** 24, 1.0, -2.0 ** 24, 1.0])
    # (2^24 + -2^24) + (1 + 1) = 2, where left to right gives 1.
    assert float(tfd.halving_sum(x)) == 2.0
    y = torch.arange(64, dtype=torch.float32)
    assert float(tfd.halving_sum(y)) == float(y.sum())


# ---------------------------------------------------------------------------
# The mirrors against the JAX kernel lines and the plain versions
# ---------------------------------------------------------------------------


def _draw(seed, B, H, n_vecs):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return rnd, rnd(B, H, N, N), rnd(n_vecs, H * N, scale=0.5)


def jax_v7_lines(r, k, v, w, a, g, vmix, vf, vecs, S, active, is_first, cd):
    """ai00_server_tpu/ops/v7_decode_pallas.py:204-248, head by head."""
    H = S.shape[1]
    act = jnp.asarray(active)[:, None]

    def vec(nm):
        return jnp.asarray(vecs[jfd._VEC_IDX[nm]])[None]

    kk_full = k * vec("k_k")
    k2 = k * (1.0 + (a - 1.0) * vec("k_a"))
    v2 = v if is_first else v + (vf - v) * vmix
    rk = r * k2 * vec("r_k")
    wdec = jnp.where(act, w, 1.0)
    k2 = jnp.where(act, k2, 0.0)
    kk_full = jnp.where(act, kk_full, 0.0)
    S_new, y_n, bn = [], [], []
    for h in range(H):
        sl = slice(h * N, (h + 1) * N)
        kk_h = kk_full[:, sl]
        kk_h = kk_h / jnp.maximum(
            jnp.sqrt(jnp.sum(kk_h * kk_h, axis=-1, keepdims=True)), 1e-12)
        kk_h = kk_h.astype(cd).astype(jnp.float32)
        s = S[:, h]
        skk = jnp.sum(s * kk_h[:, None, :], axis=-1)
        s_new = (s * wdec[:, sl][:, None, :]
                 - skk[:, :, None] * (kk_h * a[:, sl])[:, None, :]
                 + v2[:, sl][:, :, None] * k2[:, sl][:, None, :])
        S_new.append(s_new)
        y_h = jnp.sum(s_new * r[:, sl][:, None, :], axis=-1)
        mean = jnp.mean(y_h, axis=-1, keepdims=True)
        var = jnp.var(y_h, axis=-1, keepdims=True)
        y_n.append((y_h - mean) * jax.lax.rsqrt(var + GN_EPS))
        bn.append(jnp.sum(rk[:, sl], axis=-1, keepdims=True) * v2[:, sl])
    yf = (jnp.concatenate(y_n, -1) * vec("lnx_w") + vec("lnx_b")) \
        + jnp.concatenate(bn, -1)
    out = (yf * g).astype(cd).astype(jnp.float32)
    return (np.asarray(out), np.asarray(jnp.stack(S_new, 1)),
            np.asarray(v if is_first else vf))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_first", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_v7_mirror_equals_kernel_lines_and_plain(shape, is_first, name):
    B, H, active = shape
    C = H * N
    active = np.array(active)
    rnd, S, vecs = _draw(7 + int(is_first) + 10 * B, B, H, 8)
    r, k, v, g, vf = (rnd(B, C, scale=0.5) for _ in range(5))
    w = np.exp(-jfd.W_SCALE / (1 + np.exp(-rnd(B, C)))).astype(np.float32)
    a, vmix = (1 / (1 + np.exp(-rnd(B, C))) for _ in range(2))
    a, vmix = a.astype(np.float32), vmix.astype(np.float32)
    want, S_want, vf_want = jax_v7_lines(
        *(jnp.asarray(t) for t in (r, k, v, w, a, g, vmix, vf)), vecs, S,
        active, is_first, JDT[name])
    targs = [as_torch(t) for t in (r, k, v, w, a, g, vmix, vf, vecs)]
    targs += [torch.from_numpy(active), as_torch(S)]
    got, S_got, vf_got = tfd.v7_wkv_gn_mirror(*targs, is_first, TDT[name])
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= out_tol(name)
    assert rel(S_got.numpy(), S_want) <= 2e-6
    np.testing.assert_array_equal(S_got.numpy()[~active], S[~active])
    np.testing.assert_array_equal(vf_got.numpy(), vf_want)
    p_out, p_S, p_vf = tfd.v7_wkv_gn_plain(*targs, is_first, TDT[name])
    assert rel(to_np(got), to_np(p_out)) <= out_tol(name)
    assert rel(S_got.numpy(), p_S.numpy()) <= 2e-6
    assert torch.equal(vf_got, p_vf)


def jax_v56_lines(r, k, v, w, g, vecs, S, active, cd, round_yf):
    """The WKV and GroupNorm of ai00_server_tpu/ops/v6_decode_pallas.py:
    187-206 (``w`` the dense decay) or v5_decode_pallas.py:163-183 (``w`` the
    static decay row), with ``round_yf``; without it the phased kernel's
    f32 gate, v56_phased_pallas.py:337-369 (``ln_x`` times ``g`` in f32,
    rounded only as Wo's input)."""
    B, H = S.shape[:2]
    act3 = jnp.asarray(active)[:, None, None]
    u_full = jnp.asarray(vecs[1])[None]
    wdec = jnp.broadcast_to(w, (B, H * N))
    S_new, y_n = [], []
    for h in range(H):
        sl = slice(h * N, (h + 1) * N)
        s = S[:, h]
        a = k[:, sl][:, :, None] * v[:, sl][:, None, :]
        y_h = jnp.sum((s + u_full[:, sl][:, :, None] * a)
                      * r[:, sl][:, :, None], axis=1)
        S_new.append(jnp.where(act3, wdec[:, sl][:, :, None] * s + a, s))
        mean = jnp.mean(y_h, axis=-1, keepdims=True)
        var = jnp.var(y_h, axis=-1, keepdims=True)
        y_n.append((y_h - mean) * jax.lax.rsqrt(var + GN_EPS))
    yf = jnp.concatenate(y_n, -1) * jnp.asarray(vecs[2])[None] \
        + jnp.asarray(vecs[3])[None]
    if round_yf:
        yf = yf.astype(cd).astype(jnp.float32)
    out = (yf * g).astype(cd).astype(jnp.float32)
    return np.asarray(out), np.asarray(jnp.stack(S_new, 1))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "dense f32 gate", "static"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_v56_mirror_equals_kernel_lines_and_plain(shape, mode, name):
    B, H, active = shape
    C = H * N
    active = np.array(active)
    rnd, S, vecs = _draw(9 + 10 * B, B, H, 4)
    r, k, v = (rnd(B, C, scale=0.5) for _ in range(3))
    g = rnd(B, C)
    g = (g / (1 + np.exp(-g))).astype(np.float32)
    if mode == "static":
        vecs[0] = np.exp(-np.exp(vecs[0]))
        w = None
        jw = jnp.asarray(vecs[0])[None]
    else:
        w = np.exp(-np.exp(rnd(B, C, scale=0.5))).astype(np.float32)
        jw = jnp.asarray(w)
    round_yf = mode != "dense f32 gate"
    want, S_want = jax_v56_lines(
        *(jnp.asarray(t) for t in (r, k, v)), jw, jnp.asarray(g), vecs,
        jnp.asarray(S), active, JDT[name], round_yf)
    targs = [as_torch(r), as_torch(k), as_torch(v),
             None if w is None else as_torch(w), as_torch(g), as_torch(vecs),
             torch.from_numpy(active), as_torch(S)]
    got, S_got = tfd6.v6_wkv_gn_mirror(*targs, TDT[name], round_yf)
    assert got.dtype == TDT[name] and got.shape == (B, C)
    assert rel(to_np(got), want) <= out_tol(name)
    assert rel(S_got.numpy(), S_want) <= 2e-6
    np.testing.assert_array_equal(S_got.numpy()[~active], S[~active])
    p_out, p_S = tfd6.v6_wkv_gn_plain(*targs, TDT[name], round_yf)
    assert rel(to_np(got), to_np(p_out)) <= out_tol(name)
    assert rel(S_got.numpy(), p_S.numpy()) <= 2e-6
