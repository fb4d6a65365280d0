"""The port's v5/v6 WKV plain versions against the JAX package's kernels.

The same numpy inputs go through ``ai00_server_tpu.ops.wkv_t1.wkv56_t1`` /
``ops.wkv_pallas.wkv56_chunk`` (Pallas in interpret mode), the JAX scan
``models.v5.wkv_scan`` and the port's ``wkv56_t1`` / ``wkv56_chunk`` on CPU
tensors (their plain versions).  The state is k-major ``(B, H, N_k, N_v)``
on both sides.  Tolerance rtol/atol 1e-5 in f32, as the JAX package's own
kernel tests use: both sides run the same f32 recurrence, and only the
order of the N-term sums differs.

The Pallas chunk wrapper folds the mask into ``w = 1, k = 0``, so a masked
step's ``y`` there is ``r S`` without the bonus, where ``wkv_scan`` (and
the port) give ``r (S + u k v^T)``: ``y`` is compared at valid steps only,
the state everywhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.models import v5 as jv5
from ai00_server_tpu.ops.wkv_pallas import wkv56_chunk as j_chunk
from ai00_server_tpu.ops.wkv_t1 import wkv56_t1 as j_t1

from ai00_server_tpu_torch.ops.wkv_chunk import wkv56_chunk
from ai00_server_tpu_torch.ops.wkv_t1 import wkv56_t1
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, T, H, N):
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, k, v = ((rng.standard_normal((B, T, H, N)) * 0.3).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N)) * 0.5))
    u = (rng.standard_normal((H, N)) * 0.5).astype(np.float32)
    return S, (r, k, v, w.astype(np.float32)), u


@pytest.mark.parametrize("N", [16, 64])
def test_wkv56_t1_matches_jax(N):
    rng = np.random.default_rng(N)
    B, H = 3, 2
    S, seqs, u = _inputs(rng, B, 1, H, N)
    mask = np.array([True, False, True])
    vecs = [x[:, 0] for x in seqs]

    S_k, y_k = j_t1(jnp.asarray(S), *map(jnp.asarray, vecs), jnp.asarray(u),
                    jnp.asarray(mask), interpret=True)
    S_s, y_s = jv5.wkv_scan(jnp.asarray(S), *map(jnp.asarray, seqs),
                            jnp.asarray(u), jnp.asarray(mask[:, None]))
    S_t, y_t = wkv56_t1(torch.from_numpy(S), *map(torch.from_numpy, vecs),
                        torch.from_numpy(u), torch.from_numpy(mask))
    assert S_t.shape == (B, H, N, N) and y_t.shape == (B, H, N)
    for S_ref, y_ref in ((S_k, y_k), (S_s, y_s[:, 0])):
        np.testing.assert_allclose(S_t.numpy(), np.asarray(S_ref), **TOL)
        # Every row gets its y, the inactive one included.
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_ref), **TOL)
    # The inactive row's state is its input, bit for bit.
    np.testing.assert_array_equal(S_t[1].numpy(), S[1])


@pytest.mark.parametrize("T", [1, 16, 23])
def test_wkv56_chunk_matches_jax(T):
    rng = np.random.default_rng(200 + T)
    B, H, N = 3, 2, 16
    S, seqs, u = _inputs(rng, B, T, H, N)
    lengths = np.array([T, max(T - 5, 0), 0])
    mask = np.arange(T)[None, :] < lengths[:, None]

    S_j, y_j = j_chunk(jnp.asarray(S), *map(jnp.asarray, seqs),
                       jnp.asarray(u), jnp.asarray(mask), t_block=8,
                       interpret=True)
    S_s, y_s = jv5.wkv_scan(jnp.asarray(S), *map(jnp.asarray, seqs),
                            jnp.asarray(u), jnp.asarray(mask))
    S_t, y_t = wkv56_chunk(torch.from_numpy(S), *map(torch.from_numpy, seqs),
                           torch.from_numpy(u), torch.from_numpy(mask))
    for S_ref in (S_j, S_s):
        np.testing.assert_allclose(S_t.numpy(), np.asarray(S_ref), **TOL)
    np.testing.assert_allclose(y_t.numpy()[mask], np.asarray(y_j)[mask],
                               **TOL)
    # Against the scan the masked steps agree too (the same semantics).
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_s), **TOL)
    np.testing.assert_array_equal(S_t[2].numpy(), S[2])


@pytest.mark.parametrize("T", [1, 9])
def test_wkv56_static_decay_matches_jax(T):
    """RWKV-5's static (H, N) decay, taken as it is, against the JAX scan on
    the decay broadcast to (B, T, H, N) as the JAX model feeds it."""
    rng = np.random.default_rng(300 + T)
    B, H, N = 3, 2, 16
    S, (r, k, v, _), u = _inputs(rng, B, T, H, N)
    w = np.exp(-np.exp(rng.standard_normal((H, N)) * 0.5)).astype(np.float32)
    lengths = np.array([T, T // 2, 0])
    mask = np.arange(T)[None, :] < lengths[:, None]
    dense = np.broadcast_to(w, (B, T, H, N))

    S_s, y_s = jv5.wkv_scan(*map(jnp.asarray, (S, r, k, v, dense, u, mask)))
    t = torch.from_numpy
    if T == 1:
        S_t, y_t = wkv56_t1(t(S), t(r[:, 0]), t(k[:, 0]), t(v[:, 0]), t(w),
                            t(u), t(mask[:, 0]))
        y_t = y_t[:, None]
    else:
        S_t, y_t = wkv56_chunk(t(S), t(r), t(k), t(v), t(w), t(u), t(mask))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_s), **TOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_s), **TOL)
    np.testing.assert_array_equal(S_t[2].numpy(), S[2])


def test_wkv56_wrappers_refuse_other_devices():
    S = torch.zeros((1, 1, 64, 64), device="meta")
    v = torch.zeros((1, 1, 64), device="meta")
    u = torch.zeros((1, 64), device="meta")
    m = torch.ones(1, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wkv56_t1(S, v, v, v, v, u, m)
    with pytest.raises(ValueError, match="unsupported device"):
        wkv56_chunk(S, v[:, None], v[:, None], v[:, None], v[:, None], u,
                    m[:, None])
