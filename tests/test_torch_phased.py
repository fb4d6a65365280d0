"""The port's phased RWKV-7 decode step and its products against the JAX
package's.

A small v7 (2 layers, C=512, F=2048, head 64, vocab 64; weights and tokens
from numpy seeds) goes through ``ai00_server_tpu.ops.v7_phased_pallas`` —
the Pallas kernel itself, in interpret mode, ``na=1`` and ``na=2`` — and
through the port's ``ops/v7_phased`` on CPU tensors, where every wrapper
runs its kernel's plain version, at B=12 (above the 8 rows of the fused
products) with one inactive row, whose state must keep its bits.

Tolerances, relative to each tensor's largest magnitude:

* f32: 2e-5 (measured ~4e-6: the same arithmetic at the same rounding
  points, the sums in another order).
* bf16 weights and activations, f32 state: 2^-6 on the hidden and the
  state (measured 8.6e-3 on the hidden and 6.5e-3 on the state with plain
  weights, 4.3e-3 / 5.0e-3 with int8 codes, 8.4e-3 / 4.8e-3 with int4: at
  C=512 a different summation order moves f32 sums across bf16 rounding
  boundaries, and the flipped ulps are carried through the layers; the
  port's fused stack shows the same 8.6e-3 against this kernel with plain
  weights).  Where a stack applies the scales of codes shows in the
  hidden's MEAN error relative to its mean magnitude: the phased stack
  reads at most 1.4e-3 against this kernel, the fused one (codes scaled in
  bf16 before one sum) 1.2e-2 or more; the line is 2^-8
  (``test_fused_stack_is_not_the_phased_arithmetic``).

``phased_matmul_plain`` is held against a numpy reckoning of the TPU
kernel's ``_mono_dot`` (each scale block's f32 sub-dot times its scale, the
blocks added in order) to 1e-6 of scale, and shown to differ from the
weight-side scaling of the fused products.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.engine import Engine as JEngine
from ai00_server_tpu.loader import LoadedModel as JLoaded
from ai00_server_tpu.models import ModelVersion
from ai00_server_tpu.models import v7 as jv7
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.ops import v7_decode_pallas as jfd
from ai00_server_tpu.ops import v7_phased_pallas as jpd
from ai00_server_tpu.testing import (make_params, make_raw_weights,
                                     make_tiny_model, tiny_info)

from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import v7 as tv7
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import phased_matmul as pm
from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.ops import v7_decode as tfd
from ai00_server_tpu_torch.ops import v7_phased as tpd
from ai00_server_tpu_torch.ops.v7_decode import Product

L, C, N, V, B = 2, 512, 64, 64, 12
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
MEAN_LINE = 2.0 ** -8
INACTIVE = 3


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean()) / float(np.abs(want).mean())


def to_np(t):
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def make_pair(case):
    """(dtype name, info, JAX params with layout, port params with layout)
    for ``"<dtype>"`` or ``"<dtype>-<mode>"`` (int8, int4, nf4, sf4)."""
    name, _, mode = case.partition("-")
    info = tiny_info(ModelVersion.V7, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    jparams = make_params(info, raw, dtype=jdt,
                          quant={i: mode for i in range(L)} if mode else None)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jparams = dict(jparams)
    jparams[jfd.FUSED_KEY] = jfd.make_fused_layout(jparams)
    tparams[tfd.FUSED_KEY] = tfd.make_fused_layout(tparams)
    return name, info, jparams, tparams


def advanced_state(info, jparams, seed=0):
    """An f32 state after a 5-token prefill through the JAX layer path."""
    rng = np.random.default_rng(seed)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    toks = jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32)
    _, state = jax.jit(jv7.forward)(plain, jv7.init_state(info, B), toks,
                                    jnp.full((B,), 5, jnp.int32))
    return jax.tree.map(np.asarray, state)


def step_inputs(seed=1):
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, V, (B, 1)).astype(np.int32)
    l1 = np.ones(B, np.int32)
    l1[INACTIVE] = 0
    return t1, l1


def torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def jax_phased(jparams, state, t1, l1, na=1):
    jh, js = jpd.forward_t1(jparams, jax.tree.map(jnp.asarray, state),
                            jnp.asarray(t1), jnp.asarray(l1), na=na,
                            interpret=True)
    return np.asarray(jh.astype(jnp.float32)), jax.tree.map(np.asarray, js)


def check_step(name, state, t1, l1, jh, js, th, ts):
    act = l1 > 0
    assert rel(to_np(th)[act], jh[act]) <= TOL[name]
    for k in state:
        assert rel(ts[k].numpy(), js[k]) <= TOL[name], k
        np.testing.assert_array_equal(ts[k].numpy()[:, INACTIVE],
                                      state[k][:, INACTIVE])
        assert not np.array_equal(ts[k].numpy()[:, 0], state[k][:, 0])


@pytest.mark.parametrize("case", ["float32", "bfloat16", "float32-int8",
                                  "bfloat16-int8", "float32-int4",
                                  "bfloat16-int4"])
def test_step_with_inactive_row_equals_jax_phased(case):
    name, info, jparams, tparams = make_pair(case)
    assert jpd.can_phase(jparams, batch=B, na=1)
    assert tpd.can_phase(tparams, B)
    state = advanced_state(info, jparams)
    t1, l1 = step_inputs()
    jh, js = jax_phased(jparams, state, t1, l1)
    ts = torch_state(state)
    th, ts_out = tpd.forward_t1(tparams, ts, torch.from_numpy(t1),
                                torch.from_numpy(l1))
    assert ts_out is ts  # updated in place
    assert th.shape == (B, 1, C) and str(th.dtype) == "torch." + name
    check_step(name, state, t1, l1, jh, js, th, ts)


def test_step_equals_jax_phased_two_tiles():
    """``na=2``: the TPU kernel accumulates every C-input product over two
    K tiles (plain f32 weights: int8 / int4 windows need C=1024 there)."""
    name, info, jparams, tparams = make_pair("float32")
    state = advanced_state(info, jparams, seed=4)
    t1, l1 = step_inputs(seed=5)
    jh, js = jax_phased(jparams, state, t1, l1, na=2)
    ts = torch_state(state)
    th, _ = tpd.forward_t1_plain(tparams, ts, torch.from_numpy(t1),
                                 torch.from_numpy(l1))
    check_step(name, state, t1, l1, jh, js, th, ts)


@pytest.mark.parametrize("case", ["bfloat16-int8", "bfloat16-int4"])
def test_fused_stack_is_not_the_phased_arithmetic(case):
    """Against the TPU's phased kernel the hidden's mean relative error is
    under 2^-8 for the phased stack and over it for the fused one, which
    scales codes in bf16 before one sum (module docstring)."""
    name, info, jparams, tparams = make_pair(case)
    state = advanced_state(info, jparams)
    t1, l1 = step_inputs()
    jh, _ = jax_phased(jparams, state, t1, l1)
    act = l1 > 0
    err = {}
    for stack in (tpd, tfd):
        h, _ = stack.forward_t1(tparams, torch_state(state),
                                torch.from_numpy(t1), torch.from_numpy(l1))
        err[stack] = mean_rel(to_np(h)[act], jh[act])
    assert err[tpd] <= MEAN_LINE < err[tfd]


# ---------------------------------------------------------------------------
# phased_matmul_plain against the TPU kernel's _mono_dot, in numpy
# ---------------------------------------------------------------------------


def bf16_np(a):
    """Round an f32 array to bf16 (nearest even), kept as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
    ).numpy()


def mono_dot_np(x, codes, scale, cd):
    """``_mono_dot`` in numpy: x and the codes cast to the activation type,
    each block's sub-dot in f32 (here f64, rounded), times its f32 scale,
    the blocks added in order.  codes: (nb, blk, N) values; scale: (nb, 1,
    N)."""
    cast = bf16_np if cd == "bfloat16" else (lambda a: np.float32(a))
    xc = cast(x).astype(np.float64)
    nb, blk, _ = codes.shape
    acc = None
    for j in range(nb):
        sub = (xc[:, j * blk:(j + 1) * blk] @ cast(codes[j]).astype(
            np.float64)).astype(np.float32)
        pj = sub * scale[j]
        acc = pj if acc is None else (acc + pj).astype(np.float32)
    return acc


def mm_case(mode, cd, K=512, Nout=256, Bx=12, seed=3):
    """A product of ``mode`` weights in ``cd``: (x tensor, W, scale, codes
    (nb, blk, N) as values, scales) from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bx, K)).astype(np.float32)
    w = rng.standard_normal((K, Nout)).astype(np.float32) / np.sqrt(K)
    dt = torch.float32 if cd == "float32" else torch.bfloat16
    xt = torch.from_numpy(x).to(dt)
    if mode == "none":
        W = torch.from_numpy(w).to(dt)
        codes = W.float().numpy()[None]
        return xt, W, None, codes, np.ones((1, 1, Nout), np.float32)
    q = tquant.QUANTIZERS[mode](w)
    if mode == "int8":
        codes = q.q.numpy().astype(np.float32)
    else:
        packed = q.q.numpy().astype(np.int16)
        codes = np.concatenate([(packed & 15) - 8, (packed >> 4) - 8],
                               axis=-2).astype(np.float32)
    return xt, q.q, q.scale, codes, q.scale.numpy()


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_phased_matmul_plain_equals_mono_dot(mode, cd):
    xt, W, scale, codes, s = mm_case(mode, cd)
    (got,) = pm.phased_matmul_plain([Product(xt, W, scale=scale, mode=mode
                                             if mode != "none" else "",
                                             out="f32")])
    want = mono_dot_np(xt.float().numpy(), codes, s, cd)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) <= 1e-6


def test_phased_matmul_plain_scales_the_f32_sub_sums():
    """In bf16 the f32 sub-sum scaling (the TPU's phased kernel) and the
    weight-side scaling in bf16 (the fused products) give different sums:
    the plain version is the former, to 1e-6, and stays 1e-3 or more away
    from the latter."""
    xt, W, scale, codes, s = mm_case("int8", "bfloat16", K=1024)
    prod = Product(xt, W, scale=scale, mode="int8", out="f32")
    (got,) = pm.phased_matmul_plain([prod])
    sub_sums = mono_dot_np(xt.float().numpy(), codes, s, "bfloat16")
    # The fused products' dequantization: bf16(code * bf16(scale)).
    weight_side = xt.float().numpy().astype(np.float64) @ bf16_np(
        codes * bf16_np(s)).reshape(1024, -1).astype(np.float64)
    (fused,) = tfd.v7_skinny_matmul_plain([prod])
    assert rel(got.numpy(), sub_sums) <= 1e-6
    assert rel(got.numpy(), weight_side) >= 1e-3
    assert rel(fused.numpy(), weight_side) <= 1e-6


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_phased_matmul_plain_epilogues_equal_skinny(cd):
    """Plain weights: the same sums as ``v7_skinny_matmul_plain``, through
    the same epilogues, in place for ``add`` / ``gadd``."""
    rng = np.random.default_rng(11)
    dt = torch.float32 if cd == "float32" else torch.bfloat16

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    K, Nout = 128, 64
    prods = [Product(t(B, K, dtype=dt), t(K, Nout, dtype=dt) / 8, act=act,
                     bias=t(Nout), round_cd=rc, out=out)
             for act, rc, out in (("tanh", False, "cd"),
                                  ("sigmoid", True, "f32"),
                                  ("wdecay", False, "f32"),
                                  ("relu2", False, "cd"),
                                  ("silu", False, "f32"),
                                  ("expexp", False, "f32"))]
    want = tfd.v7_skinny_matmul_plain(prods)
    got = pm.phased_matmul(prods)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    y, gate = t(B, Nout), t(B, Nout)
    for out in ("add", "gadd"):
        y0 = y.clone()
        prod = Product(t(B, K, dtype=dt), t(K, Nout, dtype=dt), out=out,
                       y=y0, gate=gate if out == "gadd" else None)
        (want,) = tfd.v7_skinny_matmul_plain([prod])
        (got,) = pm.phased_matmul([prod])
        assert got is y0 and torch.equal(y0, want)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,batch,stack", [
    ("float32", 8, "fused"), ("float32", 9, "phased"),
    ("bfloat16-int8", 1, "fused"), ("bfloat16-int8", 64, "phased"),
    ("float32-int4", 12, "phased"), ("float32-nf4", 12, "fused"),
    ("float32-sf4", 64, "fused")])
def test_stack_for_picks_phased_above_eight_rows(case, batch, stack):
    """Phased above the fused products' 8 rows, for plain, int8 and int4
    weights; nf4 / sf4 keep the fused stack at any batch (the TPU's phased
    kernel reads them only as int8 surrogate codes, which the port does not
    carry)."""
    _, _, _, tparams = make_pair(case)
    want = tpd if stack == "phased" else tfd
    assert tfused.stack_for("V7", tparams, batch) is want
    assert tpd.can_phase(tparams, batch) == (stack == "phased")


def test_stack_for_mixed_and_small_heads_take_the_layer_path():
    info = tiny_info(ModelVersion.V7, num_layer=L, num_emb=C, head_size=N,
                     num_vocab=V)
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    mixed = params_from_numpy(jax.tree.map(np.asarray, make_params(
        info, raw, dtype=np.float32, quant={0: "int8"})), "cpu")
    assert tfused.stack_for("V7", mixed, 12) is None
    _, _, small = make_tiny_model(ModelVersion.V7, seed=1, dtype=np.float32,
                                  num_layer=2, num_emb=64, head_size=16,
                                  num_vocab=V)
    small = params_from_numpy(jax.tree.map(np.asarray, small), "cpu")
    assert not tpd.can_phase(small, 12)
    assert tfused.stack_for("V7", small, 12) is None


@pytest.mark.parametrize("case", ["float32-int8", "bfloat16-int4"])
def test_model_forward_dispatches_on_the_batch(case):
    """``models/v7.forward`` at T=1: the phased stack above 8 rows, the
    fused one at 8 or fewer (the two differ in bits for codes)."""
    name, info, jparams, tparams = make_pair(case)
    state = advanced_state(info, jparams)
    t1, l1 = step_inputs()
    for rows, stack in ((B, tpd), (8, tfd)):
        args = (torch.from_numpy(t1[:rows]), torch.from_numpy(l1[:rows]))
        sub = {k: v[:, :rows] for k, v in state.items()}
        h, _ = tv7.forward(tparams, torch_state(sub), *args)
        want, _ = stack.forward_t1_plain(tparams, torch_state(sub), *args)
        other, _ = (tfd if stack is tpd else tpd).forward_t1_plain(
            tparams, torch_state(sub), *args)
        assert torch.equal(h, want) and not torch.equal(h, other)


# ---------------------------------------------------------------------------
# The slice end to end: an engine with max_batch = 12
# ---------------------------------------------------------------------------

GREEDY = {"kind": jsampling.KIND_GREEDY, "presence": 0.0, "frequency": 0.0}
ENGINE_ROWS, CHUNK = 12, 8


def test_engine_max_batch_12_decodes_as_jax(monkeypatch):
    """A CPU engine of 12 rows (phased stack; its plain versions on the CPU)
    and the JAX engine, greedy, on the same f32 weights: a ragged prefill of
    five requests (the other rows idle), then a 6-token decode chunk.
    Tokens equal, row states within 2e-4 of their scale (f32, another
    summation order)."""
    info, _, params = make_tiny_model(ModelVersion.V7, seed=71,
                                      dtype=np.float32, num_layer=L,
                                      num_emb=128, head_size=N, num_vocab=V)
    j = JEngine(JLoaded(info=info, params=params, init_wkv=None),
                max_batch=ENGINE_ROWS, token_chunk_size=CHUNK)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    t = TEngine(TLoaded(info=info, params=tparams), max_batch=ENGINE_ROWS,
                token_chunk_size=CHUNK, device="cpu")
    calls = []
    phased = tpd.forward_t1
    monkeypatch.setattr(tpd, "forward_t1",
                        lambda *a: calls.append(1) or phased(*a))
    prompts = {0: [1, 2, 3, 4, 5], 2: [7, 8, 9], 5: [3] * 8, 7: [11, 4],
               11: [9, 9, 1, 2]}
    toks = np.zeros((ENGINE_ROWS, CHUNK), np.int32)
    lens = np.zeros(ENGINE_ROWS, np.int32)
    for b, p in prompts.items():
        toks[b, :len(p)], lens[b] = p, len(p)
    firsts = []
    for eng in (j, t):
        for b in range(ENGINE_ROWS):
            eng.load_row_state(b, None)
            eng.set_row_sampler(b, GREEDY, prompt_tokens=prompts.get(b, []))
            eng.set_row_bias(b, None)
        firsts.append(eng.step(toks, lens, lens > 0).tokens)
    active = lens > 0
    np.testing.assert_array_equal(firsts[1][active], firsts[0][active])
    jt, _ = j.decode_chunk(firsts[0], active, 6)
    tt, _ = t.decode_chunk(firsts[1], active, 6)
    assert calls, "the 12-row engine never took the phased stack"
    np.testing.assert_array_equal(tt[:, active], jt[:, active])
    for b in range(ENGINE_ROWS):
        jr, tr = j.read_row_state(b), t.read_row_state(b)
        for k in jr:
            assert rel(tr[k], jr[k]) <= 2e-4, (b, k)
