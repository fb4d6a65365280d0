"""The port's RWKV-7 forward against the JAX package's, on a tiny f32 model.

One random model (``ai00_server_tpu.testing.make_tiny_model``) is loaded
three ways: the JAX loader, the port's loader (from the same ``.st``
file) and ``params_from_numpy`` (the JAX params carried across).  The same
tokens go through ``ai00_server_tpu.models.v7.forward`` and the port's
``forward`` on CPU tensors.  Tolerance 2e-4 relative to each tensor's scale
in f32: the two frameworks sum the matmuls in different orders, and three
layers of LayerNorm/GroupNorm amplify that to a few 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu import loader as jloader
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.testing import make_tiny_model

from ai00_server_tpu_torch import loader as tloader
from ai00_server_tpu_torch import testing as ttesting
from ai00_server_tpu_torch.models import v7 as tv7

from test_loader import to_converted_layout

RTOL = 2e-4


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (
        float(np.abs(got - want).max()), scale)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    info, raw, jparams = make_tiny_model(ModelVersion.V7, seed=11,
                                         dtype=np.float32)
    path = str(tmp_path_factory.mktemp("m") / "tiny.st")
    jloader.save_safetensors(to_converted_layout(raw), path,
                             dtype=np.float32)
    from_file = tloader.load_model(path, dtype=torch.float32, device="cpu")
    carried = tloader.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return info, jparams, {"file": from_file.params, "carried": carried}


def _tokens(rng, info, B, T):
    return rng.integers(1, info.num_vocab, size=(B, T)).astype(np.int32)


def _run_jax(params, state, toks, lens):
    h, s = jv7.forward(params, state, jnp.asarray(toks), jnp.asarray(lens))
    return np.asarray(h), jax.tree.map(np.asarray, s)


def _run_torch(params, state, toks, lens):
    h, s = tv7.forward(params, state, torch.from_numpy(toks),
                       torch.from_numpy(lens))
    return h.numpy(), {k: v.numpy() for k, v in s.items()}


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.mark.parametrize("how", ["file", "carried"])
def test_ragged_prefill_then_decode(models, how):
    info, jparams, tparams = models
    params = tparams[how]
    rng = np.random.default_rng(3)
    B, T = 3, 7
    toks = _tokens(rng, info, B, T)
    lens = np.array([7, 4, 0], np.int32)

    js = jv7.init_state(info, B)
    ts = tv7.init_state(info, B)
    jh, js = _run_jax(jparams, js, toks, lens)
    th, ts = _run_torch(params, ts, toks, lens)
    mask = np.arange(T)[None, :] < lens[:, None]
    close(th[mask], jh[mask])
    for k in js:
        close(ts[k], js[k])

    # T=1 decode with an idle row: its state must not move.
    for _ in range(3):
        t1 = _tokens(rng, info, B, 1)
        l1 = np.array([1, 1, 0], np.int32)
        jh, js = _run_jax(jparams, js, t1, l1)
        prev_idle = {k: v[:, 2].copy() for k, v in ts.items()}
        th, ts = _run_torch(params, _torch_state(ts), t1, l1)
        close(th[:2], jh[:2])
        for k in js:
            close(ts[k], js[k])
            np.testing.assert_array_equal(ts[k][:, 2], prev_idle[k])


def test_chunked_prefill_equals_full(models):
    info, _, tparams = models
    params = tparams["file"]
    rng = np.random.default_rng(5)
    B, T = 2, 12
    toks = _tokens(rng, info, B, T)
    full = np.full(B, T, np.int32)
    h_full, s_full = _run_torch(params, tv7.init_state(info, B), toks, full)

    s = tv7.init_state(info, B)
    hs = []
    for lo in (0, 5):
        hi = T if lo else 5
        part = np.zeros((B, 8), np.int32)
        part[:, : hi - lo] = toks[:, lo:hi]
        h, s = tv7.forward(params, s, torch.from_numpy(part),
                           torch.full((B,), hi - lo, dtype=torch.int32))
        hs.append(h.numpy()[:, : hi - lo])
    close(np.concatenate(hs, axis=1), h_full)
    for k in s_full:
        close(s[k].numpy(), s_full[k])


def test_port_testing_weights_equal_jax():
    from ai00_server_tpu.testing import make_raw_weights, tiny_info

    jinfo = tiny_info(ModelVersion.V7)
    tinfo = ttesting.tiny_info()
    for dtype in (np.float32, np.float64):
        want = make_raw_weights(jinfo, seed=4, dtype=dtype)
        got = ttesting.make_raw_weights(tinfo, seed=4, dtype=dtype)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
