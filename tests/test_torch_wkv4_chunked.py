"""RWKV-4's chunked WKV form (``ops/wkv4.wkv4_chunk_mirror``: the arithmetic
of ``csrc/wkv4.cu``'s chunk kernel in PyTorch), its launch plan
(``ops/wkv4.plan``) and ``v4_wkv_plain``, on the CPU.

The mirror cuts each channel's chunk into runs of R steps, steps each run
from the zero state, scans the runs (a state followed by a run of n valid
steps: ``p = pp + n w; q = max(p, pp_s)``, the two triples scaled by
``e^(p - q)`` and ``e^(pp_s - q)``) and steps each run again from its start
state for y.  It is held against the JAX package's ``models/v4._wkv_scan``
(the sequential ``lax.scan``) on the same numpy inputs: B = 1 and 3, T = 1
to 64, R = 4, 8 (the kernel's runs) and 16, f32 and bf16 k and v,
``time_decay`` in [-5, 5) (w down to -148), a fresh row at ``PP_INIT``, an
idle row and masks with holes (not a suffix).  Tolerances, relative to
max(1, the largest magnitude): y 2e-5 and the state 2e-6 (the scan rounds
in another order than the chain; the largest errors seen are 3e-7 on y and
1.5e-6 on the state, aa at T = 64 in 16 runs of 4, where the plain chain
reads under 1e-6); the idle row and ``PP_INIT`` entries exactly.  ``v4_wkv_plain`` is held
against the Pallas v4 kernel's WKV lines
(``ai00_server_tpu/ops/v4_decode_pallas.py:142-166``) at B = 1, 3, 8 as
``tests/test_torch_v4_decode.py`` holds it at B = 3.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai00_server_tpu.models import v4 as jv4
from ai00_server_tpu_torch.ops import v4_decode as tfd4
from ai00_server_tpu_torch.ops import wkv4
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

C = 40
Y_TOL, STATE_TOL = 2e-5, 2e-6
KV = {"float32": (np.float32, jnp.float32, torch.float32),
      "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def case(B, T, kv):
    """Numpy inputs from a seed and JAX ``_wkv_scan``'s results.  Row 0 is
    advanced, row 1 fresh (PP_INIT), row 2 idle (B = 3); B = 1 is one fresh
    row.  k and v are rounded to bf16 first for ``kv = "bfloat16"``."""
    rng = np.random.default_rng(100 * B + T)

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    aa, bb, pp = rnd(B, C), np.abs(rnd(B, C)) + 0.5, rnd(B, C)
    fresh = 1 if B > 1 else 0
    aa[fresh], bb[fresh], pp[fresh] = 0.0, 0.0, jv4.PP_INIT
    k, v = rnd(B, T, C, scale=2.0), rnd(B, T, C)
    if kv == "bfloat16":
        k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                for x in (k, v))
    w = -np.exp(rng.uniform(-5.0, 5.0, C)).astype(np.float32)
    u = rnd(C, scale=0.5)
    mask = rng.random((B, T)) > 0.3
    mask[0, T // 2] = False  # a hole, whatever the draw
    if B > 2:
        mask[2] = False
    jk, jv = (jnp.asarray(x).astype(KV[kv][1]) for x in (k, v))
    (jaa, jbb, jpp), jy = jv4._wkv_scan(jnp.asarray(aa), jnp.asarray(bb),
                                        jnp.asarray(pp), jk, jv,
                                        jnp.asarray(w), jnp.asarray(u),
                                        jnp.asarray(mask))
    inputs = (aa, bb, pp, k, v, w, u, mask)
    want = tuple(np.asarray(x) for x in (jaa, jbb, jpp, jy))
    return inputs, want


def torch_inputs(inputs, kv):
    aa, bb, pp, k, v, w, u, mask = (torch.from_numpy(np.array(x))
                                    for x in inputs)
    return aa, bb, pp, k.to(KV[kv][2]), v.to(KV[kv][2]), w, u, mask


def held(got, want, start, B):
    """got / want: (aa, bb, pp, y) as numpy; start: (aa, bb, pp)."""
    for name, g, w, tol in zip(("aa", "bb", "pp", "y"), got, want,
                               (STATE_TOL,) * 3 + (Y_TOL,)):
        init = np.abs(w) >= 1e29  # PP_INIT: kept exactly
        np.testing.assert_array_equal(g[init], w[init], err_msg=name)
        g, w = g[~init].astype(np.float64), w[~init].astype(np.float64)
        if w.size:
            err = float(np.abs(g - w).max()) / max(1.0,
                                                   float(np.abs(w).max()))
            assert err <= tol, (name, err)
    if B > 2:  # the idle row keeps its bits
        for g, s in zip(got[:3], start):
            np.testing.assert_array_equal(g[2], s[2])


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [4, 8, 16])
@pytest.mark.parametrize("T", [1, 5, 16, 23, 64])
@pytest.mark.parametrize("B", [1, 3])
def test_mirror_equals_jax_scan(B, T, R, kv):
    inputs, want = case(B, T, kv)
    (aa, bb, pp), y = wkv4.wkv4_chunk_mirror(*torch_inputs(inputs, kv), R)
    got = tuple(t.numpy() for t in (aa, bb, pp, y))
    held(got, want, inputs[:3], B)
    assert all(np.isfinite(g).all() for g in got)


@pytest.mark.parametrize("T", [1, 9, 16])
def test_one_run_is_the_plain_chain(T):
    """R >= T: one run, no scan; the mirror steps the chain as the plain
    version does, bit for bit."""
    inputs, _ = case(3, T, "float32")
    ts = torch_inputs(inputs, "float32")
    (aa, bb, pp), y = wkv4.wkv4_chunk_mirror(*ts, 16)
    (aa_p, bb_p, pp_p), y_p = wkv4.wkv4_chunk_plain(*ts)
    for g, p in ((aa, aa_p), (bb, bb_p), (pp, pp_p), (y, y_p)):
        assert torch.equal(g, p)


def test_run_without_a_valid_step_is_the_identity():
    """A run of masked steps (n = 0) leaves any state as it is, bit for
    bit; a fresh state followed by a run is that run, bit for bit."""
    rng = np.random.default_rng(5)
    s = tuple(torch.from_numpy(rng.standard_normal(C).astype(np.float32))
              for _ in range(3)) + (torch.zeros(C, dtype=torch.int64),)
    w = -torch.exp(torch.from_numpy(rng.uniform(-5, 5, C).astype(np.float32)))
    empty = (torch.zeros(C), torch.zeros(C), torch.full((C,), wkv4.PP_INIT),
             torch.zeros(C, dtype=torch.int64))
    for got, want in zip(wkv4._after(s, empty, w), s):
        assert torch.equal(got, want)
    run = s[:3] + (torch.full((C,), 7, dtype=torch.int64),)
    for got, want in zip(wkv4._after(empty, run, w), run):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [17, 23, 33, 64, 65, 128, 129, 255, 256, 257,
                               4096])
def test_plan_covers_the_chunk(T):
    """NS a power of two, at least 2, the least whose runs of RUN_STEPS
    cover T (else MAX_RUNS and several windows), as the mirror takes it;
    blocks of THREADS, G channels x NS runs."""
    assert not wkv4.sequential(T)
    G, NS = wkv4.plan(T)
    assert NS == wkv4.runs(wkv4.RUN_STEPS, T) and NS & (NS - 1) == 0
    assert 2 <= NS <= wkv4.MAX_RUNS
    assert NS * wkv4.RUN_STEPS >= T or NS == wkv4.MAX_RUNS
    assert NS == 2 or NS * wkv4.RUN_STEPS < 2 * T  # no window of empty runs
    assert G * NS == wkv4.THREADS


@pytest.mark.parametrize("C", [768, 1024, 2048, 2560, 4096])
def test_plan_fills_the_card_at_one_row(C):
    """B = 1 at the served chunk (T = 256) and every RWKV-4 width from
    169M to 7B: ceil(C / G) blocks of THREADS give each of an H100's 132
    SMs at least 4 warps (one thread a channel, the step-by-step form,
    gave C / 32: under one warp an SM at C = 1024)."""
    G, NS = wkv4.plan(256)
    blocks = -(-C // G)
    assert blocks * wkv4.THREADS // 32 >= 4 * 132


@pytest.mark.parametrize("T", [1, 2, 8, 16])
def test_short_chunks_are_sequential(T):
    """T = 1 (the layer path) and chunks up to SEQ_STEPS take the
    step-by-step kernel, whose chain the mirror's one run repeats."""
    assert wkv4.sequential(T) and T <= wkv4.SEQ_STEPS


def test_plan_runs_by_chunk_length():
    """Runs of 8 steps at every T: the served chunk (256) in one window of
    32 runs, a ragged one (23) in 4, and longer chunks in windows of 256
    steps."""
    assert wkv4.plan(256) == (8, 32)
    assert wkv4.plan(23) == (64, 4)
    assert wkv4.plan(257) == (8, 32)
    assert wkv4.plan(128) == (16, 16)


# ---------------------------------------------------------------------------
# v4_wkv_plain against the Pallas kernel's WKV lines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_v4_wkv_plain_equals_kernel_lines(B, name):
    """``v4_decode_pallas._kernel`` lines 142-166 in ``jax.numpy``: row 0
    fresh at PP_INIT, every third row from 1 inactive.  f32 outputs 2e-6
    relative (the last bit of ``exp``), the bf16 output one ulp (2^-7)."""
    rng = np.random.default_rng(20 + B)
    cd = KV[name]

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    Cw = 64
    r = 1 / (1 + np.exp(-rnd(B, Cw)))
    k, v = rnd(B, Cw), rnd(B, Cw)
    vecs = np.stack([-np.exp(rng.uniform(-5, 5, Cw).astype(np.float32)),
                     rnd(Cw, scale=0.5)])
    aa, bb, pp = rnd(B, Cw), np.abs(rnd(B, Cw)) + 0.5, rnd(B, Cw)
    aa[0], bb[0], pp[0] = 0.0, 0.0, jv4.PP_INIT
    active = np.array([b % 3 != 1 for b in range(B)])

    jw, ju = jnp.asarray(vecs[0:1]), jnp.asarray(vecs[1:2])
    jk, jvv = jnp.asarray(k), jnp.asarray(v)
    ww = ju + jk
    q = jnp.maximum(pp, ww)
    e1, e2 = jnp.exp(pp - q), jnp.exp(ww - q)
    wkv = (e1 * aa + e2 * jvv) / (e1 * bb + e2)
    ww2 = pp + jw
    q2 = jnp.maximum(ww2, jk)
    e1u, e2u = jnp.exp(ww2 - q2), jnp.exp(jk - q2)
    act = active[:, None]
    want_state = [np.asarray(jnp.where(act, e1u * aa + e2u * jvv, aa)),
                  np.asarray(jnp.where(act, e1u * bb + e2u, bb)),
                  np.asarray(jnp.where(act, q2, pp))]
    want = np.asarray((jnp.asarray(r) * wkv).astype(cd[1])
                      .astype(jnp.float32))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    out, *state = tfd4.v4_wkv_plain(t(r), t(k), t(v), t(vecs),
                                    torch.from_numpy(active), t(aa), t(bb),
                                    t(pp), cd[2])
    assert out.dtype == cd[2] and out.shape == (B, Cw)
    err = float(np.abs(out.float().numpy() - want).max())
    assert err <= (2e-6 if name == "float32" else 2.0 ** -7) * max(
        1.0, float(np.abs(want).max()))
    for g, w, start in zip(state, want_state, (aa, bb, pp)):
        g = g.numpy()
        init = np.abs(w) >= 1e29
        np.testing.assert_array_equal(g[init], w[init])
        err = float(np.abs(g[~init] - w[~init]).max())
        assert err <= 2e-6 * max(1.0, float(np.abs(w[~init]).max()))
        for b in range(B):
            if not active[b]:
                np.testing.assert_array_equal(g[b], start[b])
        assert np.isfinite(g).all()
