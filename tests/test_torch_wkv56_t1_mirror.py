"""The PyTorch mirror of ``csrc/wkv56.cu:wkv56_t1_kernel``
(``ops/wkv_t1.wkv56_t1_mirror``), its split plan ``plan56`` and the port's
``wkv56_t1`` on bf16 vectors, on the CPU.

The mirror is held against the JAX package's ``wkv56_t1`` (the Pallas
kernel in interpret mode) and against the port's plain version at B = 1, 3
and 8 with idle rows, at every split of a head, on RWKV-6's dense decay and
RWKV-5's static (H, N) one (the JAX function takes it broadcast to (B, H,
N)), on f32 and on bf16 vectors (the same numpy values rounded through
bf16; the JAX function widens them to f32 first, as the kernel does):
tolerance 1e-5, relative and absolute, as ``tests/test_torch_wkv56.py``
uses (the same f32 recurrence, sums in another order); an idle row's state
exactly.  Its readout is held bit for bit against a lane-by-lane replay of
the kernel's order in numpy f32 (a thread's four k rows in order, then the
16 row groups by shuffles xor 1, 2, 4, 8), and its splits against each
other.  The port's ``wkv56_t1`` on CPU tensors with the layer path's
vectors (r, k, v, u bf16, w f32) equals it on their f32 widening bit for
bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.ops.wkv_t1 import wkv56_t1 as j_t1
from ai00_server_tpu_torch.ops import _build
from ai00_server_tpu_torch.ops import wkv_t1 as tw
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

N = 64
TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def inputs(seed, B, H, vec, static, N=N):
    """(S, [r, k, v, w, u] as f32 numpy rounded through ``vec``, mask with
    every third row idle from row 1).  ``w`` is (H, N) when ``static``."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, k, v = (rng.standard_normal((B, H, N)) * 0.3 for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((H, N) if static else (B, H, N))
                       * 0.5))
    u = rng.standard_normal((H, N)) * 0.5
    vecs = [torch.from_numpy(x.astype(np.float32)).to(TDT[vec]).float()
            .numpy() for x in (r, k, v, w, u)]
    mask = np.arange(B) % 3 != 1
    return S, vecs, mask


def as_vec(x, vec):
    return torch.from_numpy(x).to(TDT[vec])


def jax_t1(S, vecs, mask, vec):
    """The JAX Pallas kernel (interpret mode) on ``vecs`` in ``vec``, the
    static decay broadcast to (B, H, N) as the JAX model feeds it."""
    r, k, v, w, u = vecs
    w = np.broadcast_to(w, r.shape)
    return j_t1(jnp.asarray(S),
                *(jnp.asarray(np.ascontiguousarray(x)).astype(JDT[vec])
                  for x in (r, k, v, w, u)),
                jnp.asarray(mask), interpret=True)


@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("vec", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_mirror_matches_jax_kernel_and_plain(B, vec, slices, static):
    S, vecs, mask = inputs(B + 10 * static, B, 2, vec, static)
    S_j, y_j = jax_t1(S, vecs, mask, vec)
    args = (torch.from_numpy(S), *(as_vec(x, vec) for x in vecs),
            torch.from_numpy(mask))
    S_m, y_m = tw.wkv56_t1_mirror(*args, slices=slices)
    S_p, y_p = tw.wkv56_t1_plain(*args)
    for S_ref, y_ref in ((np.asarray(S_j), np.asarray(y_j)),
                         (S_p.numpy(), y_p.numpy())):
        np.testing.assert_allclose(S_m.numpy(), S_ref, **TOL)
        # Every row gets its y, the idle ones included.
        np.testing.assert_allclose(y_m.numpy(), y_ref, **TOL)
    for b in np.flatnonzero(~mask):
        np.testing.assert_array_equal(S_m[b].numpy(), S[b])


@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_mirror_splits_agree_bit_for_bit(B, static):
    """Value columns are independent and the readout's tree is one in every
    split: 1, 2 and 4 blocks a head give the same bits."""
    S, vecs, mask = inputs(20 + B, B, 3, "f32", static)
    args = (torch.from_numpy(S), *(torch.from_numpy(x) for x in vecs),
            torch.from_numpy(mask))
    S1, y1 = tw.wkv56_t1_mirror(*args, slices=1)
    for slices in (2, 4):
        S2, y2 = tw.wkv56_t1_mirror(*args, slices=slices)
        assert torch.equal(S1, S2) and torch.equal(y1, y2)


def lane_replay(S, r):
    """The kernel's readout sum_k r_k S[k][v] in numpy f32, lane by lane:
    a thread of row group rg adds its rows 4 rg .. 4 rg + 3 in order, then
    every row group adds rg ^ 1, ^ 2, ^ 4, ^ 8 (lanes CG apart by shuffles,
    then the warps in pairs: the same tree; 16 groups at N = 64,
    head_tile(N) / 4 at another N, those past the head holding 0); every
    row group must end with the same bits."""
    n = S.shape[0]
    rg = _build.head_tile(n) // 4
    p = (S * r[:, None]).astype(np.float32).reshape(n // 4, 4, n)
    own = (((p[:, 0] + p[:, 1]).astype(np.float32) + p[:, 2])
           .astype(np.float32) + p[:, 3]).astype(np.float32)
    own = np.concatenate([own, np.zeros((rg - n // 4, n), np.float32)])
    groups = np.arange(rg)
    off = 1
    while off < rg:
        own = (own + own[groups ^ off]).astype(np.float32)
        off *= 2
    assert (own == own[:1]).all()
    return own[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_readout_is_the_kernels_order(seed, N=N):
    """With k = 0 the bonus drops out and y is the readout's sums r S
    alone: bit for bit the lane replay's."""
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((1, 1, N, N))
         * 2.0 ** rng.integers(-10, 10, (1, 1, N, N))).astype(np.float32)
    r = (rng.standard_normal((1, 1, N))
         * 2.0 ** rng.integers(-8, 8, (1, 1, N))).astype(np.float32)
    zeros, ones = np.zeros_like(r), np.ones_like(r)
    for slices in tw.splits(N):
        _, y = tw.wkv56_t1_mirror(
            torch.from_numpy(S), *(torch.from_numpy(x) for x in
                                   (r, zeros, ones, ones, ones[0])),
            torch.ones(1, dtype=torch.bool), slices=slices)
        np.testing.assert_array_equal(y[0, 0].numpy(),
                                      lane_replay(S[0, 0], r[0, 0]))


@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_port_layer_vectors_equal_their_f32_widening(B, static):
    """``wkv56_t1`` on CPU tensors with the layer path's vectors (r, k, v
    from bf16 products, w f32, u a bf16 parameter) gives the bits of the
    same call on their f32 widening, and both hold the JAX kernel's
    tolerance."""
    S, vecs, mask = inputs(30 + B, B, 2, "bf16", static)
    dts = ["bf16", "bf16", "bf16", "f32", "bf16"]
    narrow = [as_vec(x, d) for x, d in zip(vecs, dts)]
    wide = [t.float() for t in narrow]
    S_t, m = torch.from_numpy(S), torch.from_numpy(mask)
    S_a, y_a = tw.wkv56_t1(S_t, *narrow, m)
    S_b, y_b = tw.wkv56_t1(S_t, *wide, m)
    assert torch.equal(S_a, S_b) and torch.equal(y_a, y_b)
    S_j, y_j = jax_t1(S, [t.numpy() for t in wide], mask, "f32")
    np.testing.assert_allclose(S_a.numpy(), np.asarray(S_j), **TOL)
    np.testing.assert_allclose(y_a.numpy(), np.asarray(y_j), **TOL)
    for b in np.flatnonzero(~mask):
        np.testing.assert_array_equal(S_a[b].numpy(), S[b])


@pytest.mark.parametrize("B,H,want", [
    (8, 32, 1), (1, 32, 4), (64, 32, 1),   # RWKV-6 1B6 serving
    (8, 16, 1), (4, 16, 4),                # its tp places (H / 2)
    (8, 8, 4), (4, 8, 4),                  # RWKV-5 0.4B's (H / 2)
])
def test_plan56_at_the_serving_and_tp_shapes(B, H, want):
    """On an H100's 132 SMs."""
    assert tw.plan56(B, H, 132) == want


def test_mirror_refuses_other_splits():
    S = torch.zeros(1, 1, N, N)
    v = torch.zeros(1, 1, N)
    with pytest.raises(ValueError, match="slices"):
        tw.wkv56_t1_mirror(S, v, v, v, v, v[0], torch.ones(1, dtype=bool),
                           slices=3)


# Head sizes other than 64 (the kernel built with -DHEAD_N): 32, 40 (laid
# out at 64: six of 16 row groups past the head) and 128.
HEADS = (32, 40, 128)


@pytest.mark.parametrize("static", [False, True], ids=["dense", "static"])
@pytest.mark.parametrize("vec", ["f32", "bf16"])
@pytest.mark.parametrize("N_,slices", [(n, s) for n in HEADS
                                       for s in tw.splits(n)])
def test_mirror_matches_jax_kernel_and_plain_at_other_head_sizes(
        N_, slices, vec, static):
    S, vecs, mask = inputs(N_ + slices, 3, 2, vec, static, N=N_)
    S_j, y_j = jax_t1(S, vecs, mask, vec)
    args = (torch.from_numpy(S), *(as_vec(x, vec) for x in vecs),
            torch.from_numpy(mask))
    S_m, y_m = tw.wkv56_t1_mirror(*args, slices=slices)
    S_p, y_p = tw.wkv56_t1_plain(*args)
    for S_ref, y_ref in ((np.asarray(S_j), np.asarray(y_j)),
                         (S_p.numpy(), y_p.numpy())):
        np.testing.assert_allclose(S_m.numpy(), S_ref, **TOL)
        np.testing.assert_allclose(y_m.numpy(), y_ref, **TOL)
    for b in np.flatnonzero(~mask):
        np.testing.assert_array_equal(S_m[b].numpy(), S[b])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("N_", HEADS)
def test_mirror_readout_is_the_kernels_order_at_other_head_sizes(N_, seed):
    test_mirror_readout_is_the_kernels_order(seed, N=N_)


@pytest.mark.parametrize("N_,want", [(8, 2), (32, 2), (40, 4), (128, 4)])
def test_plan56_at_other_head_sizes(N_, want):
    """Four blocks a head where two SMs have a head, but at N <= 32, whose
    head is 64 threads, two (a block at least a warp)."""
    assert tw.plan56(1, 16, 132, N_) == want
    assert tw.plan56(64, 16, 132, N_) == 1
