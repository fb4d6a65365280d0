"""The chunk kernels' arithmetic (``ops/wkv_chunk.wkv7_chunk_wy``,
``wkv56_chunk_ss``: the WY and suffix-sum forms in the kernels' order, one
sub-chunk of ``SUB`` steps after the other) against the JAX package, and
the wrappers' rules in Python: ``plan`` (blocks per head of the state
pass) and ``sequential`` (v5/v6 chunks of one sub-chunk take the
step-by-step kernel).

The same numpy inputs go through the JAX scans (``models/v7._wkv_scan``,
``models/v5.wkv_scan``), its chunked forms (``ops/wkv_chunked.*_chunk_mm``)
and its Pallas kernels in interpret mode (``ops/wkv_pallas.*_chunk``), and
through the port's forms on CPU tensors.  T runs over one sub-chunk, a
ragged one and several; the masks are ragged, with a masked step inside a
row and an idle row whose state must come back bit for bit.  v7 is also
held at its decay floor exp(-exp(-0.5)) (the WY form's precondition: its
largest 1 / A), v5/v6 at the extreme decays of ``tests/test_wkv_chunked.py``
(log w down to ~ -e^4) and with RWKV-5's static (H, N) decay.

Tolerance rtol 1e-4 with atol 1e-5 (v7) / 5e-5 (v5/v6), as
``tests/test_wkv_chunked.py`` holds the JAX chunked forms to the scans: the
chunked forms sum the same f32 terms in another association (products of
R x R factor matrices, a triangular solve, exponentials of summed
log-decays), which moves results by a few f32 ulps of the state's scale.

v7's y is compared at every step (a masked step reads the kept state in all
of them).  v5/v6's y is compared at every step with the scan and the port's
plain version, and at valid steps only with the JAX chunked and Pallas
forms, which fold the mask into k = 0 and so drop a masked step's bonus.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.models import v5 as jv5
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.ops import wkv_pallas as jp
from ai00_server_tpu.ops.wkv_chunked import wkv56_chunk_mm, wkv7_chunk_mm

from ai00_server_tpu_torch.ops import wkv_chunk as wc

TOL7 = dict(rtol=1e-4, atol=1e-5)
TOL56 = dict(rtol=1e-4, atol=5e-5)
STEPS = [1, 5, 16, 23, 40, 128]
W_FLOOR = float(np.exp(-np.exp(-0.5)))


def _mask(T, B=3):
    """Row 0 whole but one step inside, row 1 five steps short, the last
    row idle."""
    lengths = np.array([T, max(T - 5, 0)] + [T] * (B - 3) + [0])
    mask = np.arange(T)[None, :] < lengths[:, None]
    if T > 3:
        mask[0, 2] = False
    return mask


def _v7_inputs(rng, B, T, H, N, floor=False):
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, k, v = ((rng.standard_normal((B, T, H, N)) * 0.4).astype(np.float32)
               for _ in range(3))
    # v7's decay: w = exp(-exp(-0.5) sigmoid(.)) in [0.5452, 1).
    z = rng.standard_normal((B, T, H, N)) * 3
    w = np.exp(-np.exp(-0.5) / (1 + np.exp(-z)))
    if floor:
        w = np.full_like(w, W_FLOOR)
    kk = rng.standard_normal((B, T, H, N))
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, T, H, N)) * 2))
    return S, [x.astype(np.float32) for x in (r, w, k, v, kk, a)]


def _v56_inputs(rng, B, T, H, N, decay="dense"):
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, k, v = ((rng.standard_normal((B, T, H, N)) * 0.4).astype(np.float32)
               for _ in range(3))
    shape = (H, N) if decay == "static" else (B, T, H, N)
    scale = 2.0 if decay == "extreme" else 0.5
    w = np.exp(-np.exp(rng.standard_normal(shape) * scale)).astype(np.float32)
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    return S, [r, k, v, w], u


def _port(fn, S, seqs, mask, *extra):
    S_t, y_t = fn(torch.from_numpy(S), *map(torch.from_numpy, seqs),
                  *map(torch.from_numpy, extra), torch.from_numpy(mask))
    return S_t.numpy(), y_t.numpy()


@pytest.mark.parametrize("T", STEPS)
def test_wkv7_wy_matches_jax(T):
    rng = np.random.default_rng(300 + T)
    B, H, N = 3, 2, 16
    S, seqs = _v7_inputs(rng, B, T, H, N)
    mask = _mask(T)
    S_t, y_t = _port(wc.wkv7_chunk_wy, S, seqs, mask)
    j = [jnp.asarray(x) for x in (S, *seqs, mask)]
    refs = {"scan": jv7._wkv_scan(*j), "chunk_mm": wkv7_chunk_mm(*j),
            "pallas": jp.wkv7_chunk(*j, t_block=8, interpret=True)}
    for name, (S_j, y_j) in refs.items():
        np.testing.assert_allclose(S_t, np.asarray(S_j), **TOL7, err_msg=name)
        np.testing.assert_allclose(y_t, np.asarray(y_j), **TOL7, err_msg=name)
    np.testing.assert_array_equal(S_t[2], S[2])  # the idle row


@pytest.mark.parametrize("T,N", [(16, 64), (40, 64), (128, 16)])
def test_wkv7_wy_at_the_decay_floor(T, N):
    rng = np.random.default_rng(400 + T)
    B, H = 3, 2
    S, seqs = _v7_inputs(rng, B, T, H, N, floor=True)
    mask = _mask(T)
    S_t, y_t = _port(wc.wkv7_chunk_wy, S, seqs, mask)
    S_j, y_j = jv7._wkv_scan(*(jnp.asarray(x) for x in (S, *seqs, mask)))
    np.testing.assert_allclose(S_t, np.asarray(S_j), **TOL7)
    np.testing.assert_allclose(y_t, np.asarray(y_j), **TOL7)
    S_p, y_p = _port(wc.wkv7_chunk_plain, S, seqs, mask)
    np.testing.assert_allclose(S_t, S_p, **TOL7)
    np.testing.assert_allclose(y_t, y_p, **TOL7)
    np.testing.assert_array_equal(S_t[2], S[2])


def _check_v56(S, seqs, u, mask, T, with_jax_chunked=True):
    S_t, y_t = _port(wc.wkv56_chunk_ss, S, seqs, mask, u)
    w = seqs[3]
    if w.ndim == 2:  # the JAX forms take the decay per step
        w = np.broadcast_to(w, seqs[0].shape).copy()
    j = [jnp.asarray(x) for x in (S, *seqs[:3], w, u, mask)]
    S_s, y_s = jv5.wkv_scan(*j)
    np.testing.assert_allclose(S_t, np.asarray(S_s), **TOL56)
    np.testing.assert_allclose(y_t, np.asarray(y_s), **TOL56)
    if with_jax_chunked:
        m = mask[:, :, None, None]
        for name, (S_j, y_j) in {
                "chunk_mm": wkv56_chunk_mm(*j),
                "pallas": jp.wkv56_chunk(*j, t_block=8,
                                         interpret=True)}.items():
            np.testing.assert_allclose(S_t, np.asarray(S_j), **TOL56,
                                       err_msg=name)
            np.testing.assert_allclose(y_t * m, np.asarray(y_j) * m,
                                       **TOL56, err_msg=name)
    np.testing.assert_array_equal(S_t[-1], S[-1])  # the idle row
    return S_t, y_t


@pytest.mark.parametrize("T", STEPS)
def test_wkv56_ss_matches_jax(T):
    rng = np.random.default_rng(500 + T)
    S, seqs, u = _v56_inputs(rng, 3, T, 2, 16)
    _check_v56(S, seqs, u, _mask(T), T)


@pytest.mark.parametrize("T", [16, 23, 128])
def test_wkv56_ss_extreme_decay(T):
    rng = np.random.default_rng(600 + T)
    S, seqs, u = _v56_inputs(rng, 2, T, 3, 16, decay="extreme")
    _check_v56(S, seqs, u, _mask(T, B=3)[[0, 2]], T, with_jax_chunked=False)


@pytest.mark.parametrize("T,N", [(5, 64), (40, 16)])
def test_wkv56_ss_static_decay(T, N):
    rng = np.random.default_rng(700 + T)
    S, seqs, u = _v56_inputs(rng, 3, T, 2, N, decay="static")
    _check_v56(S, seqs, u, _mask(T), T)


@pytest.mark.parametrize("decay", ["dense", "extreme", "static"])
def test_wkv56_ss_masked_steps_match_plain(decay):
    """y at masked steps (the bonus from the real k) as the plain version
    gives it, every other step too."""
    rng = np.random.default_rng(800)
    T = 37
    S, seqs, u = _v56_inputs(rng, 4, T, 2, 16, decay=decay)
    mask = rng.random((4, T)) < 0.6
    mask[3] = False
    S_t, y_t = _port(wc.wkv56_chunk_ss, S, seqs, mask, u)
    S_p, y_p = _port(wc.wkv56_chunk_plain, S, seqs, mask, u)
    np.testing.assert_allclose(S_t, S_p, **TOL56)
    np.testing.assert_allclose(y_t, y_p, **TOL56)
    np.testing.assert_array_equal(S_t[3], S[3])


@pytest.mark.parametrize("B,H,sms,slices", [
    (8, 16, 132, 1),   # v7 / v5 0.4B served at B = 8: 128 blocks
    (8, 32, 132, 1),   # v6 1B6 at B = 8: 256 blocks
    (1, 16, 132, 4),   # one prompt at 0.4B: 64 blocks
    (1, 32, 132, 4),   # one prompt at 1B6: 128 blocks
    (2, 16, 132, 4),   # 32 heads
    (3, 16, 132, 2),   # 48 heads: 96 blocks
    (4, 16, 132, 2),   # 64 heads: 128 blocks
    (5, 16, 132, 1),   # 80 heads
    (64, 40, 132, 1),  # wide batches at 2.9B
    (2, 16, 114, 2),   # a smaller card
])
def test_plan(B, H, sms, slices):
    assert wc.plan(B, H, sms) == slices


@pytest.mark.parametrize("B", range(1, 17))
def test_plan_takes_the_fewest_slices_that_half_fill_the_card(B):
    for H in (16, 32, 40):
        s = wc.plan(B, H, 132)
        assert s in (1, 2, 4)
        # Fewer slices than s would leave more than every other SM idle.
        assert all(2 * B * H * fewer < 132 for fewer in (1, 2) if fewer < s)


@pytest.mark.parametrize("T,seq", [(1, True), (5, True), (16, True),
                                   (17, False), (23, False), (256, False)])
def test_short_v56_chunks_take_the_sequential_kernel(T, seq):
    assert wc.sequential(T) is seq
