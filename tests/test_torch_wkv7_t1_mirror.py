"""The PyTorch mirror of ``csrc/wkv7.cu:wkv7_t1_kernel``
(``ops/wkv_t1.wkv7_t1_mirror``), its split plan and the port's ``wkv7_t1``
on bf16 vectors, on the CPU.

The mirror's row sums are held bit for bit against a lane-by-lane replay
of the kernel's order in numpy f32 (a thread's four columns in order, then
the 16 threads of a row group by shuffles xor 1, 2, 4, 8), and its splits
of a head against each other.  The mirror is held against the JAX
package's ``wkv7_t1`` (the Pallas kernel in interpret mode) at B = 1, 3
and 8 with idle rows, on f32 and on bf16 vectors (the JAX function widens
them to f32 first, as the kernel does): tolerance 1e-5, relative and
absolute, as ``tests/test_torch_wkv.py`` uses (the same f32 recurrence,
sums in another order); an idle row's state exactly.  The port's
``wkv7_t1`` on CPU tensors with bf16 vectors equals it on their f32
widening bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.ops.wkv_t1 import wkv7_t1 as j_t1
from ai00_server_tpu_torch.ops import _build
from ai00_server_tpu_torch.ops import wkv_t1 as tw
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

N = 64
TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def inputs(seed, B, H, vec, N=N):
    """(S, vecs as f32 numpy rounded through ``vec``, mask with every
    third row idle from row 1)."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, w, k, v, kk, a = ((rng.standard_normal((B, H, N)) * 0.3)
                         .astype(np.float32) for _ in range(6))
    w = np.exp(-0.6065306597126334 / (1.0 + np.exp(-w)))
    kk = kk / np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1.0 / (1.0 + np.exp(-a))
    vecs = [torch.from_numpy(x.astype(np.float32)).to(TDT[vec]).float()
            .numpy() for x in (r, w, k, v, kk, a)]
    mask = np.arange(B) % 3 != 1
    return S, vecs, mask


def as_vec(x, vec):
    return torch.from_numpy(x).to(TDT[vec])


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("vec", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_mirror_matches_jax_kernel(B, vec, slices):
    S, vecs, mask = inputs(B, B, 2, vec)
    S_j, y_j = j_t1(jnp.asarray(S),
                    *(jnp.asarray(x).astype(JDT[vec]) for x in vecs),
                    jnp.asarray(mask), interpret=True)
    S_m, y_m = tw.wkv7_t1_mirror(torch.from_numpy(S),
                                 *(as_vec(x, vec) for x in vecs),
                                 torch.from_numpy(mask), slices=slices)
    np.testing.assert_allclose(S_m.numpy(), np.asarray(S_j), **TOL)
    np.testing.assert_allclose(y_m.numpy(), np.asarray(y_j), **TOL)
    for b in np.flatnonzero(~mask):
        np.testing.assert_array_equal(S_m[b].numpy(), S[b])


@pytest.mark.parametrize("B", [1, 3, 8])
def test_mirror_splits_agree_bit_for_bit(B):
    """Rows are independent: 1, 2 and 4 blocks a head give the same bits."""
    S, vecs, mask = inputs(10 + B, B, 3, "f32")
    args = (torch.from_numpy(S), *(torch.from_numpy(x) for x in vecs),
            torch.from_numpy(mask))
    S1, y1 = tw.wkv7_t1_mirror(*args, slices=1)
    for slices in (2, 4):
        S2, y2 = tw.wkv7_t1_mirror(*args, slices=slices)
        assert torch.equal(S1, S2) and torch.equal(y1, y2)


def lane_replay(M, x):
    """The kernel's row sums of M . x in numpy f32, lane by lane: thread cq
    of a row group adds its columns 4 cq .. 4 cq + 3 in order, then every
    lane adds lane ^ 1, ^ 2, ^ 4, ... (16 lanes at N = 64; head_tile(N) / 4
    at another N, the lanes past the head holding 0); every lane must end
    with the same bits."""
    n = M.shape[1]
    cq = _build.head_tile(n) // 4
    p = (M * x[None, :]).astype(np.float32).reshape(M.shape[0], n // 4, 4)
    own = (((p[..., 0] + p[..., 1]).astype(np.float32) + p[..., 2])
           .astype(np.float32) + p[..., 3]).astype(np.float32)
    own = np.concatenate(
        [own, np.zeros((M.shape[0], cq - n // 4), np.float32)], axis=1)
    lanes = np.arange(cq)
    off = 1
    while off < cq:
        own = (own + own[:, lanes ^ off]).astype(np.float32)
        off *= 2
    assert (own == own[:, :1]).all()
    return own[:, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirror_row_sums_are_the_kernels_order(seed, N=N):
    """With w = 1, k = 0 and a = 0 the step leaves S as it is, so y is the
    readout's row sums S r alone: bit for bit the lane replay's."""
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((1, 1, N, N))
         * 2.0 ** rng.integers(-10, 10, (1, 1, N, N))).astype(np.float32)
    r = (rng.standard_normal((1, 1, N))
         * 2.0 ** rng.integers(-8, 8, (1, 1, N))).astype(np.float32)
    ones, zeros = np.ones_like(r), np.zeros_like(r)
    vecs = [r, ones, zeros, zeros, zeros, zeros]
    _, y = tw.wkv7_t1_mirror(torch.from_numpy(S),
                             *(torch.from_numpy(x) for x in vecs),
                             torch.ones(1, dtype=torch.bool))
    np.testing.assert_array_equal(y[0, 0].numpy(),
                                  lane_replay(S[0, 0], r[0, 0]))


@pytest.mark.parametrize("B", [1, 3, 8])
def test_port_bf16_vectors_equal_their_f32_widening(B):
    """``wkv7_t1`` on CPU tensors with the layer path's vectors (w f32, the
    rest bf16) gives the bits of the same call on their f32 widening, and
    both hold the JAX kernel's tolerance."""
    S, vecs, mask = inputs(20 + B, B, 2, "bf16")
    dts = ["bf16", "f32", "bf16", "bf16", "bf16", "bf16"]
    narrow = [as_vec(x, d) for x, d in zip(vecs, dts)]
    wide = [t.float() for t in narrow]
    S_t = torch.from_numpy(S)
    m = torch.from_numpy(mask)
    S_a, y_a = tw.wkv7_t1(S_t, *narrow, m)
    S_b, y_b = tw.wkv7_t1(S_t, *wide, m)
    assert torch.equal(S_a, S_b) and torch.equal(y_a, y_b)
    S_j, y_j = j_t1(jnp.asarray(S), *(jnp.asarray(t.numpy()) for t in wide),
                    jnp.asarray(mask), interpret=True)
    np.testing.assert_allclose(S_a.numpy(), np.asarray(S_j), **TOL)
    np.testing.assert_allclose(y_a.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("B,want", [(1, 4), (4, 4), (5, 2), (8, 2),
                                    (16, 2), (17, 2), (64, 2)])
def test_plan_splits_small_batches(B, want):
    """At the 0.4B width (H = 16) on an H100's 132 SMs."""
    assert tw.plan(B, 16, 132) == want


def test_mirror_refuses_other_splits():
    S = torch.zeros(1, 1, N, N)
    v = torch.zeros(1, 1, N)
    with pytest.raises(ValueError, match="slices"):
        tw.wkv7_t1_mirror(S, v, v, v, v, v, v, torch.ones(1, dtype=bool),
                          slices=3)


# Head sizes other than 64 (the kernel built with -DHEAD_N): 32 (a head's
# 64 threads), 40 (laid out at 64: six of a row group's 16 lanes past the
# head) and 128 (32 lanes a row group).
HEADS = (32, 40, 128)


@pytest.mark.parametrize("vec", ["f32", "bf16"])
@pytest.mark.parametrize("N_,slices", [(n, s) for n in HEADS
                                       for s in tw.splits(n)])
def test_mirror_matches_jax_kernel_at_other_head_sizes(N_, slices, vec):
    S, vecs, mask = inputs(N_ + slices, 3, 2, vec, N=N_)
    S_j, y_j = j_t1(jnp.asarray(S),
                    *(jnp.asarray(x).astype(JDT[vec]) for x in vecs),
                    jnp.asarray(mask), interpret=True)
    S_m, y_m = tw.wkv7_t1_mirror(torch.from_numpy(S),
                                 *(as_vec(x, vec) for x in vecs),
                                 torch.from_numpy(mask), slices=slices)
    np.testing.assert_allclose(S_m.numpy(), np.asarray(S_j), **TOL)
    np.testing.assert_allclose(y_m.numpy(), np.asarray(y_j), **TOL)
    S_p, y_p = tw.wkv7_t1_plain(torch.from_numpy(S),
                                *(as_vec(x, vec) for x in vecs),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(S_m.numpy(), S_p.numpy(), **TOL)
    np.testing.assert_allclose(y_m.numpy(), y_p.numpy(), **TOL)
    for b in np.flatnonzero(~mask):
        np.testing.assert_array_equal(S_m[b].numpy(), S[b])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("N_", HEADS)
def test_mirror_row_sums_are_the_kernels_order_at_other_head_sizes(N_, seed):
    test_mirror_row_sums_are_the_kernels_order(seed, N=N_)


@pytest.mark.parametrize("N_,want", [(8, 1), (32, 1), (40, 4), (128, 4)])
def test_plan_at_other_head_sizes(N_, want):
    """Blocks of 64 threads where two SMs have a head (B = 1, H = 16; a
    head of N <= 32 is 64 threads, of 128 is 1024), the splits the kernel
    takes: a block at least a warp."""
    assert tw.plan(1, 16, 132, N_) == want
    assert tw.splits(N_) == ((1, 2) if N_ <= 32 else (1, 2, 4))
