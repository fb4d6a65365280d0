"""The port's embedding and scoring reads against the JAX engine's.

Both engines hold the same tiny model (the JAX params carried across with
``params_from_numpy``) and take the same ragged merged prefill steps; then
``hsum_pool`` (the masked hidden sums step() adds), ``read_row_embed``
(the pooled state), ``mean_hidden_embed`` and ``position_logps`` (from a
row and from an explicit state) are compared.  RWKV-7 on the layer path
(head 16) and on the fused path (head 64), RWKV-6, -5 and -4 (a state
without ``wkv``).  Tolerances: f32 2e-4 of the value's scale (another
summation order, as in test_torch_engine); bf16 2^-4 of the scale, the
families' stated bf16 tolerance (XLA fuses away some bf16 roundings that
the port keeps, test_torch_models_v5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.testing import make_params, make_raw_weights, tiny_info

from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

B, CHUNK = 4, 8
F32_TOL, BF16_TOL = 2e-4, 2.0 ** -4
# version, head size, weight dtype
CASES = {"v7": ("V7", 16, np.float32), "v7-fused": ("V7", 64, np.float32),
         "v6": ("V6", 16, np.float32), "v5": ("V5", 16, np.float32),
         "v4": ("V4", 1, np.float32), "v7-bf16": ("V7", 16, jnp.bfloat16)}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [7, 8, 9], [3] * 8, []]


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def make_engines(case, seed=80):
    version, head, dtype = CASES[case]
    info = tiny_info(ModelVersion[version], num_layer=2, num_emb=128,
                     head_size=head, num_vocab=64)
    params = make_params(info, make_raw_weights(info, seed=seed,
                                                dtype=np.float32),
                         dtype=dtype)
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=B, token_chunk_size=CHUNK)
    t = TEngine(TLoaded(info=info, params=params_from_numpy(
        jax.tree.map(np.asarray, j.model.params), "cpu")),
        max_batch=B, token_chunk_size=CHUNK, device="cpu")
    for b in range(B):
        j.load_row_state(b, None)
        t.load_row_state(b, None, hidden_sums=True)  # JAX sums every row
    return j, t, (F32_TOL if dtype == np.float32 else BF16_TOL)


def prefill(eng, prompts=PROMPTS):
    """Ragged merged steps until every prompt is in (the last chunk of
    each row its own length), then one T=1 step on rows 1 and 2."""
    rest = [list(p) for p in prompts]
    while any(rest):
        toks = np.zeros((B, CHUNK), np.int32)
        lens = np.zeros(B, np.int32)
        for b, p in enumerate(rest):
            n = min(len(p), CHUNK)
            toks[b, :n] = p[:n]
            lens[b] = n
            del p[:n]
        eng.step(toks, lens, np.zeros(B, np.bool_))
    lens = np.array([0, 1, 1, 0], np.int32)
    eng.step(np.full((B, 1), 5, np.int32), lens, np.zeros(B, np.bool_))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hidden_sums_equal_jax(case):
    j, t, tol = make_engines(case)
    for eng in (j, t):
        prefill(eng)
    jh, th = np.asarray(j.hsum_pool), t.read_hidden_sums()
    close(th, jh, tol)
    assert np.all(th[3] == 0)  # an idle row adds nothing
    for b in range(B):
        close(t.read_row_hidden_sum(b), jh[b], tol)
    # Loading a row zeroes its sums and bumps the serial.
    serial = t.hsum_serial
    t.load_row_state(0, None)
    assert t.hsum_serial == serial + 1
    assert np.all(t.read_row_hidden_sum(0) == 0)


@pytest.mark.parametrize("case", ["v7", "v7-fused"])
def test_only_tracked_rows_add_hidden_sums(case):
    """Rows loaded without hidden_sums add nothing; a step with no tracked
    row leaves the pool and its serial as they were."""
    j, t, tol = make_engines(case)
    for b in (1, 3):
        t.load_row_state(b, None)
    for eng in (j, t):
        prefill(eng)
    th = t.read_hidden_sums()
    close(th[[0, 2]], np.asarray(j.hsum_pool)[[0, 2]], tol)
    assert not th[[1, 3]].any()
    t.load_row_state(0, None)
    t.load_row_state(2, None)
    serial = t.hsum_serial
    prefill(t)
    assert t.hsum_serial == serial and not t.read_hidden_sums().any()


@pytest.mark.parametrize("case", ["v7", "v4"])
def test_decode_chunk_adds_no_hidden_sums(case):
    """JAX's decode_chunk does not accumulate; neither does the port's."""
    _, t, _ = make_engines(case)
    prefill(t)
    before = t.read_hidden_sums()
    t.decode_chunk(np.array([1, 2, 3, 4], np.int32),
                   np.array([True, True, False, True]), 3)
    np.testing.assert_array_equal(t.read_hidden_sums(), before)


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_embed_equals_jax(case):
    j, t, tol = make_engines(case)
    for eng in (j, t):
        prefill(eng)
    for b in range(3):
        jv, tv = np.asarray(j.read_row_embed(b)), t.read_row_embed(b)
        assert tv.shape == jv.shape
        close(tv, jv, tol)
        assert abs(float(np.linalg.norm(tv)) - 1.0) < 1e-5


@pytest.mark.parametrize("case", ["v7", "v7-fused", "v6", "v4"])
def test_mean_hidden_embed_equals_jax(case):
    j, t, tol = make_engines(case)
    for toks in ([5, 9, 2, 7, 1, 1, 3, 4, 8, 2, 6, 3, 9], [4]):
        close(t.mean_hidden_embed(toks), np.asarray(j.mean_hidden_embed(
            toks)), tol)


def test_mean_hidden_embed_equals_the_serving_readout():
    """The serving path (hidden sums of a fresh-state prefill through
    step(), divided by the token count) gives the offline recipe's
    vector."""
    _, t, _ = make_engines("v7")
    prefill(t)
    v = t.read_row_hidden_sum(0) / len(PROMPTS[0])
    close(v / np.linalg.norm(v), t.mean_hidden_embed(PROMPTS[0]), 1e-5)


@pytest.mark.parametrize("case", ["v7", "v7-fused", "v6", "v4", "v7-bf16"])
def test_position_logps_equal_jax(case):
    j, t, tol = make_engines(case)
    for eng in (j, t):
        prefill(eng)
    before = {k: v.clone() for k, v in t.state_pool.items()}
    for toks in ([3, 1, 4, 1, 5], [9, 2]):
        for b in (0, 1):
            close(t.position_logps(toks, b=b),
                  np.asarray(j.position_logps(toks, b=b)), tol)
        init = jax.tree.map(np.asarray, j.fresh_row_state())
        close(t.position_logps([0] + toks, state=init),
              np.asarray(j.position_logps([0] + toks, state=init)), tol)
    assert t.position_logps([7], b=0).shape == (0,)
    # Scoring never advances the pool.
    for k, v in t.state_pool.items():
        assert torch.equal(v, before[k])
