"""The port's v7 WKV plain versions against the JAX package's kernels.

The same numpy inputs go through ``ai00_server_tpu.ops.wkv_t1.wkv7_t1`` /
``ops.wkv_pallas.wkv7_chunk`` (Pallas in interpret mode), the JAX scan
``models.v7._wkv_scan`` and the port's ``wkv7_t1`` / ``wkv7_chunk`` on CPU
tensors (their plain versions).  Tolerance 1e-5 in f32, as the JAX
package's own kernel tests use: both sides run the same f32 recurrence, and
only the order of the N-term sums differs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.ops.wkv_pallas import wkv7_chunk as j_chunk
from ai00_server_tpu.ops.wkv_t1 import wkv7_t1 as j_t1

from ai00_server_tpu_torch.ops.wkv_chunk import wkv7_chunk
from ai00_server_tpu_torch.ops.wkv_t1 import wkv7_t1

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, T, H, N):
    S = rng.standard_normal((B, H, N, N)).astype(np.float32)
    r, w, k, v, kk, a = (
        (rng.standard_normal((B, T, H, N)) * 0.3).astype(np.float32)
        for _ in range(6))
    w = 1.0 / (1.0 + np.exp(-w))  # decay in (0, 1)
    kk = kk / np.linalg.norm(kk, axis=-1, keepdims=True)
    a = 1.0 / (1.0 + np.exp(-a))
    return S, (r, w.astype(np.float32), k, v, kk.astype(np.float32),
               a.astype(np.float32))


@pytest.mark.parametrize("N", [16, 64])
def test_wkv7_t1_matches_jax(N):
    rng = np.random.default_rng(N)
    B, H = 3, 2
    S, seqs = _inputs(rng, B, 1, H, N)
    mask = np.array([True, True, False])
    vecs = [x[:, 0] for x in seqs]

    S_k, y_k = j_t1(jnp.asarray(S), *map(jnp.asarray, vecs),
                    jnp.asarray(mask), interpret=True)
    S_s, y_s = jv7._wkv_scan(jnp.asarray(S), *map(jnp.asarray, seqs),
                             jnp.asarray(mask[:, None]))
    S_t, y_t = wkv7_t1(torch.from_numpy(S), *map(torch.from_numpy, vecs),
                       torch.from_numpy(mask))
    for S_ref, y_ref in ((S_k, y_k), (S_s, y_s[:, 0])):
        np.testing.assert_allclose(S_t.numpy(), np.asarray(S_ref), **TOL)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_ref), **TOL)
    # The inactive row's state is its input, bit for bit.
    np.testing.assert_array_equal(S_t[2].numpy(), S[2])


@pytest.mark.parametrize("T", [1, 16, 23])
def test_wkv7_chunk_matches_jax(T):
    rng = np.random.default_rng(100 + T)
    B, H, N = 3, 2, 16
    S, seqs = _inputs(rng, B, T, H, N)
    lengths = np.array([T, max(T - 5, 0), 0])
    mask = np.arange(T)[None, :] < lengths[:, None]

    S_j, y_j = j_chunk(jnp.asarray(S), *map(jnp.asarray, seqs),
                       jnp.asarray(mask), t_block=8, interpret=True)
    S_t, y_t = wkv7_chunk(torch.from_numpy(S), *map(torch.from_numpy, seqs),
                          torch.from_numpy(mask))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), **TOL)
    np.testing.assert_allclose(y_t.numpy()[mask], np.asarray(y_j)[mask],
                               **TOL)
    np.testing.assert_array_equal(S_t[2].numpy(), S[2])


def test_wrappers_refuse_other_devices():
    S = torch.zeros((1, 1, 64, 64), device="meta")
    v = torch.zeros((1, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wkv7_t1(S, v, v, v, v, v, v, torch.ones(1, dtype=torch.bool,
                                                device="meta"))
