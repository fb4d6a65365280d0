"""The port's sampler against the JAX package's, token for token.

Both get the same logits, penalties, bias, allowed mask and uniforms
(numpy, from a seed), so the sampled tokens must be EQUAL for every kind,
in the top-k fast path and the full-vocab bucket; the new sampler state
agrees to f32 rounding (1e-5: the penalty update is the same elementwise
f32 arithmetic, and mirostat's surprise goes through log2 in both).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ai00_server_tpu.ops import sampling as js

from ai00_server_tpu_torch.ops import sampling as ts
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

B, V = 8, 300


def _case(seed, kinds_per_row, top_k):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    params = js.make_params(B)
    params["kind"][:] = kinds_per_row
    params["top_k"][:] = top_k
    params["top_p"][:] = rng.uniform(0.2, 0.95, B).astype(np.float32)
    params["temperature"][:] = rng.uniform(0.5, 1.5, B).astype(np.float32)
    pen = np.zeros((B, V), np.float32)
    seen = np.zeros((B, V), np.bool_)
    for b in range(B):
        prompt = rng.integers(0, V, size=20)
        pen[b], seen[b] = js.init_penalties_host(
            list(prompt), V, 0.3, 0.3, 0.99654026)
    state = {"penalties": pen, "seen": seen,
             "max_surprise": rng.uniform(3.0, 9.0, B).astype(np.float32)}
    bias = np.zeros((B, V), np.float32)
    bias[:, rng.integers(0, V, 10)] = rng.standard_normal(10) * 2
    allowed = rng.random((B, V)) > 0.1
    rand = rng.random(B).astype(np.float32)
    return logits, params, state, bias, allowed, rand


def _both(case, kinds, k_cap):
    logits, params, state, bias, allowed, rand = case
    jt, jp, jst = js.sample_with_rand(
        jnp.asarray(rand), jnp.asarray(logits),
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()},
        bias=jnp.asarray(bias), allowed_mask=jnp.asarray(allowed),
        kinds=kinds, k_cap=k_cap)
    tt, tp, tst = ts.sample_with_rand(
        torch.from_numpy(rand), torch.from_numpy(logits),
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v.copy()) for k, v in state.items()},
        bias=torch.from_numpy(bias), allowed_mask=torch.from_numpy(allowed),
        kinds=kinds, k_cap=k_cap)
    return (np.asarray(jt), np.asarray(jp), jst), (tt.numpy(), tp.numpy(),
                                                   tst)


KIND_ROWS = [js.KIND_NUCLEUS, js.KIND_TYPICAL, js.KIND_MIROSTAT,
             js.KIND_GREEDY] * 2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("top_k,k_cap", [(5, 128), (0, V)],
                         ids=["fast_path", "full_vocab"])
def test_tokens_equal_jax(seed, top_k, k_cap):
    case = _case(seed, KIND_ROWS, top_k)
    assert ts.k_cap_key(case[1]["top_k"], V) == js.k_cap_key(
        case[1]["top_k"], V) == k_cap
    kinds = ts.kinds_key(case[1]["kind"])
    assert kinds == js.kinds_key(case[1]["kind"])
    (jt, jp, jst), (tt, tp, tst) = _both(case, kinds, k_cap)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tst["seen"].numpy(),
                                  np.asarray(jst["seen"]))
    for k in ("penalties", "max_surprise"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", [js.KIND_NUCLEUS, js.KIND_TYPICAL,
                                  js.KIND_MIROSTAT, js.KIND_GREEDY])
def test_single_kind_batches_equal_jax(kind):
    for seed in range(4):
        case = _case(10 + seed, [kind] * B, 128)
        (jt, _, _), (tt, _, _) = _both(case, (kind,), 128)
        np.testing.assert_array_equal(tt, jt)


def test_k_cap_key_buckets():
    assert ts.k_cap_key([1, 5]) == 128
    assert ts.k_cap_key([129]) == 256
    assert ts.k_cap_key([1024]) == ts.TOP_K_CAP
    assert ts.k_cap_key([0, 3], vocab=V) == V
    assert ts.k_cap_key([ts.TOP_K_CAP + 1], vocab=V) == V
