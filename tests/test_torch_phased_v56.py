"""The port's phased RWKV-6 / RWKV-5 decode step against the JAX package's.

A small v6 and v5 (2 layers, C=512, F=1792, head 64, vocab 64; weights and
tokens from numpy seeds) go through
``ai00_server_tpu.ops.v56_phased_pallas.forward_t1`` — the Pallas kernel,
in interpret mode, ``na=1`` — and through the port's ``ops/v56_phased`` on
CPU tensors (every wrapper runs its kernel's plain version), at B=12 with
one inactive row, whose state must keep its bits.

Tolerances, relative to each tensor's largest magnitude:

* f32: 1e-4 (measured up to 1.8e-5 on the hidden and 4.7e-5 on the v6
  state: v6's data-dependent decay exp(-exp(.)) amplifies the summation
  order's last bits, as the JAX phased tests note; v5 ~2e-6).
* bf16: 2^-6 (measured up to 6.6e-3 on the hidden, 4.0e-3 on the state:
  flipped bf16 ulps of sums taken in another order), and 2^-5 on the v6
  state (measured 1.9e-2 on the WKV state with plain weights: one flipped
  ulp in the decay LoRA moves exp(-exp(.)) and with it whole state rows).
* The phased kernel gates the f32 ``ln_x`` output where the fused one
  rounds it first, and scales codes on the f32 sub-sums: the hidden's MEAN
  error relative to its mean magnitude tells the two apart.  The phased
  stack reads at most 2.1e-3 against this kernel, the port's fused stack
  8.2e-3 or more; the line is 2^-8
  (``test_fused_stack_is_not_the_phased_arithmetic``).
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
from ai00_server_tpu.models import v5 as jv5
from ai00_server_tpu.models import v6 as jv6
from ai00_server_tpu.ops import sampling as jsampling
from ai00_server_tpu.ops import v5_decode_pallas as jfd5
from ai00_server_tpu.ops import v6_decode_pallas as jfd6
from ai00_server_tpu.ops import v56_phased_pallas as jpd
from ai00_server_tpu.testing import (make_params, make_raw_weights,
                                     make_tiny_model, tiny_info)

from ai00_server_tpu_torch.engine import Engine as TEngine
from ai00_server_tpu_torch.loader import LoadedModel as TLoaded
from ai00_server_tpu_torch.loader import params_from_numpy
from ai00_server_tpu_torch.models import v5 as tv5
from ai00_server_tpu_torch.models import v6 as tv6
from ai00_server_tpu_torch.ops import fused_decode as tfused
from ai00_server_tpu_torch.ops import v4_decode as tfd4
from ai00_server_tpu_torch.ops import v5_decode as tfd5
from ai00_server_tpu_torch.ops import v6_decode as tfd6
from ai00_server_tpu_torch.ops import v56_phased as tpd

L, C, N, V, B = 2, 512, 64, 64, 12
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
TOL_V6_BF16_STATE = 2.0 ** -5
MEAN_LINE = 2.0 ** -8
INACTIVE = 3
VER = {"V6": (jv6, jfd6, tv6, tfd6), "V5": (jv5, jfd5, tv5, tfd5)}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean()) / float(np.abs(want).mean())


@functools.lru_cache(maxsize=None)
def make_pair(case):
    """(dtype name, info, JAX params with layout, port params with layout)
    for ``"<V6|V5>-<dtype>"`` or ``"<V6|V5>-<dtype>-<mode>"``."""
    version, name, mode = (case.split("-") + [""])[:3]
    _, jfd, _, tfd = VER[version]
    info = tiny_info(ModelVersion(version), num_layer=L, num_emb=C,
                     head_size=N, num_vocab=V)
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    jparams = make_params(info, raw, dtype=jdt,
                          quant={i: mode for i in range(L)} if mode else None)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jparams = dict(jparams)
    jparams[jfd.FUSED_KEY] = jfd.make_fused_layout(jparams)
    tparams[tfd.FUSED_KEY] = tfd.make_fused_layout(tparams)
    return version, name, info, jparams, tparams


def advanced_state(version, info, jparams, seed=0):
    """An f32 state after a 5-token prefill through the JAX layer path."""
    jm, jfd, _, _ = VER[version]
    rng = np.random.default_rng(seed)
    plain = {k: v for k, v in jparams.items() if k != jfd.FUSED_KEY}
    toks = jnp.asarray(rng.integers(0, V, (B, 5)), jnp.int32)
    _, state = jax.jit(jm.forward)(plain, jm.init_state(info, B), toks,
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


def jax_phased(version, jparams, state, t1, l1):
    jh, js = jpd.forward_t1(jparams, jax.tree.map(jnp.asarray, state),
                            jnp.asarray(t1), jnp.asarray(l1), version, na=1,
                            interpret=True)
    return np.asarray(jh.astype(jnp.float32)), jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("case", [
    f"{v}-{c}" for v in ("V6", "V5")
    for c in ("float32", "bfloat16", "float32-int8", "bfloat16-int8",
              "float32-int4", "bfloat16-int4")])
def test_step_with_inactive_row_equals_jax_phased(case):
    version, name, info, jparams, tparams = make_pair(case)
    assert jpd.can_phase(jparams, B, version, na=1)
    assert tpd.can_phase(tparams, B, version)
    state = advanced_state(version, info, jparams)
    t1, l1 = step_inputs()
    jh, js = jax_phased(version, jparams, state, t1, l1)
    ts = torch_state(state)
    th, ts_out = tpd.forward_t1(tparams, ts, torch.from_numpy(t1),
                                torch.from_numpy(l1))
    assert ts_out is ts  # updated in place
    assert th.shape == (B, 1, C) and str(th.dtype) == "torch." + name
    act = l1 > 0
    assert rel(th.float().numpy()[act], jh[act]) <= TOL[name]
    tol_state = (TOL_V6_BF16_STATE if (version, name) == ("V6", "bfloat16")
                 else TOL[name])
    for k in state:
        assert rel(ts[k].numpy(), js[k]) <= tol_state, k
        np.testing.assert_array_equal(ts[k].numpy()[:, INACTIVE],
                                      state[k][:, INACTIVE])
        assert not np.array_equal(ts[k].numpy()[:, 0], state[k][:, 0])


@pytest.mark.parametrize("case", ["V6-bfloat16", "V5-bfloat16",
                                  "V6-bfloat16-int8", "V5-bfloat16-int4"])
def test_fused_stack_is_not_the_phased_arithmetic(case):
    """Against the TPU's phased kernel the hidden's mean relative error is
    under 2^-8 for the phased stack and over it for the fused one, which
    rounds ``ln_x`` before the gate and scales codes in bf16 (module
    docstring)."""
    version, _, info, jparams, tparams = make_pair(case)
    state = advanced_state(version, info, jparams)
    t1, l1 = step_inputs()
    jh, _ = jax_phased(version, jparams, state, t1, l1)
    act = l1 > 0
    err = {}
    for stack in (tpd, VER[version][3]):
        h, _ = stack.forward_t1(tparams, torch_state(state),
                                torch.from_numpy(t1), torch.from_numpy(l1))
        err[stack] = mean_rel(h.float().numpy()[act], jh[act])
    assert err[tpd] <= MEAN_LINE < err[VER[version][3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_gn_round_yf(dtype):
    """``round_yf=False`` (the phased stacks) gates the f32 ``ln_x`` output:
    the same as rounding it in f32, not in bf16."""
    rng = np.random.default_rng(2)
    Bx, H = 3, 2

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    r, k, v, g = (t(Bx, H * N) for _ in range(4))
    w = torch.exp(-torch.exp(t(Bx, H * N)))
    vecs, S = t(4, H * N), t(Bx, H, N, N)
    active = torch.tensor([True, False, True])
    outs = {rnd: tfd6.v6_wkv_gn_plain(r, k, v, w, g, vecs, active, S, dtype,
                                      round_yf=rnd) for rnd in (True, False)}
    assert torch.equal(outs[True][1], outs[False][1])
    assert torch.equal(outs[True][0], outs[False][0]) == (
        dtype == torch.float32)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,batch,stack", [
    ("V6-bfloat16", 8, "fused"), ("V6-bfloat16", 12, "phased"),
    ("V6-float32-int8", 64, "phased"), ("V6-float32-nf4", 12, "fused"),
    ("V5-bfloat16", 64, "phased"), ("V5-float32-int4", 9, "phased"),
    ("V5-float32-sf4", 64, "fused")])
def test_stack_for_picks_phased_above_eight_rows(case, batch, stack):
    version, _, _, _, tparams = make_pair(case)
    want = tpd if stack == "phased" else VER[version][3]
    assert tfused.stack_for(version, tparams, batch) is want
    assert tpd.can_phase(tparams, batch, version) == (stack == "phased")


@pytest.mark.parametrize("version", ["V6", "V5"])
def test_stack_for_mixed_takes_the_layer_path(version):
    info = tiny_info(ModelVersion(version), num_layer=L, num_emb=C,
                     head_size=N, num_vocab=V)
    raw = make_raw_weights(info, seed=7, dtype=np.float32)
    mixed = params_from_numpy(jax.tree.map(np.asarray, make_params(
        info, raw, dtype=np.float32, quant={0: "int8"})), "cpu")
    assert not tpd.can_phase(mixed, B, version)
    assert tfused.stack_for(version, mixed, B) is None


def test_v4_keeps_its_fused_stack_at_any_batch():
    """RWKV-4 has no phased kernel in the JAX package."""
    _, _, params = make_tiny_model(ModelVersion.V4, seed=3, dtype=np.float32,
                                   num_layer=L, num_emb=128, head_size=1,
                                   num_vocab=V)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert tfd4.can_fuse(tparams)
    assert tfused.stack_for("V4", tparams, 64) is tfd4
    assert not tpd.can_phase(tparams, 64, "V4")


@pytest.mark.parametrize("case", ["V6-float32-int8", "V5-bfloat16"])
def test_model_forward_dispatches_on_the_batch(case):
    """``models/v6|v5.forward`` at T=1: the phased stack above 8 rows, the
    fused one at 8 or fewer (the two differ in bits)."""
    version, _, info, jparams, tparams = make_pair(case)
    _, _, tmodel, tfd = VER[version]
    state = advanced_state(version, info, jparams)
    t1, l1 = step_inputs()
    for rows, stack in ((B, tpd), (8, tfd)):
        args = (torch.from_numpy(t1[:rows]), torch.from_numpy(l1[:rows]))
        sub = {k: v[:, :rows] for k, v in state.items()}
        h, _ = tmodel.forward(tparams, torch_state(sub), *args)
        want, _ = stack.forward_t1_plain(tparams, torch_state(sub), *args)
        other, _ = (tfd if stack is tpd else tpd).forward_t1_plain(
            tparams, torch_state(sub), *args)
        assert torch.equal(h, want) and not torch.equal(h, other)


# ---------------------------------------------------------------------------
# The slice end to end: an engine with max_batch = 12
# ---------------------------------------------------------------------------

GREEDY = {"kind": jsampling.KIND_GREEDY, "presence": 0.0, "frequency": 0.0}
ENGINE_ROWS, CHUNK = 12, 8


@pytest.mark.parametrize("version", ["V6", "V5"])
def test_engine_max_batch_12_decodes_as_jax(version, monkeypatch):
    """A CPU engine of 12 rows (the phased stack; its plain versions on the
    CPU) and the JAX engine, greedy, on the same f32 weights: a ragged
    prefill of five requests (the other rows idle), then a 6-token decode
    chunk.  Tokens equal, row states within 2e-4 of their scale."""
    info, _, params = make_tiny_model(ModelVersion(version), seed=72,
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
