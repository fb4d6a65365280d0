"""The port's int8 quantizer, dequantizing products and fused channel mix
against the JAX package's, on the CPU at tiny shapes.

Inputs come from numpy seeds and go through both packages.  The JAX side
is the Pallas kernel itself in interpret mode (``quant_pallas.matmul_int8``,
``matmul_int8_l``, ``ffn_pallas.ffn7_t1_l``); the port's side is each
wrapper on CPU tensors, i.e. the kernel's plain version.

Tolerances, relative to each result's largest magnitude:

* f32: 2e-5.  Both sides dequantize to the same f32 weight; only the order
  of the sums differs.
* bf16: 2^-7, one bf16 ulp of the output's scale.  Both sides round the
  scale to bf16, then the product, then sum in f32; a different summation
  order can move a sum across a rounding boundary of the bf16 output (or of
  the bf16 ``hk`` inside the channel mix).  A wrong rounding point — the
  scale applied in f32 — shows as several ulps on many elements.
* with ``out_dtype`` f32 from bf16 operands the sums are not rounded:
  2e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ai00_server_tpu.ops import ffn_pallas, quant_pallas
from ai00_server_tpu.ops import quant as jquant

from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.ops.ffn import ffn7_t1_l, ffn7_t1_l_plain
from ai00_server_tpu_torch.ops.quant_matmul import (matmul_int8,
                                                    matmul_int8_l,
                                                    matmul_int8_plain)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL, BF16_TOL = 2e-5, 2.0 ** -7


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def as_torch(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t if dtype is None else t.to(dtype)


def to_np(t):
    return t.float().numpy()


def weights(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
        np.float32)


def torch_codes(jq):
    """A JAX QuantizedLinear's codes and scales as torch tensors."""
    return (torch.from_numpy(np.array(jq.q)),
            torch.from_numpy(np.array(jq.scale)))


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------


def close_to_jax_device_quantizer(got, w):
    """The JAX package's device-side quantizer (``quantize_int8_jax``) is
    not bit-equal to its own numpy one on the CPU: XLA multiplies by 1/127
    where numpy (and the port, on the CPU and on the card) divide, so a
    scale may sit one f32 ulp off and a code on a rounding boundary may then
    move by one."""
    dev = jquant.quantize_int8_jax(w)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(dev.scale),
                               rtol=2.0 ** -23, atol=0)
    diff = np.abs(got.q.numpy().astype(np.int32) - np.asarray(dev.q))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("shape", [(256, 128), (128, 384), (3, 256, 200)])
@pytest.mark.parametrize("how", ["host", "device"])
def test_quantize_int8_codes_and_scales_equal_jax(shape, how):
    w = weights(len(shape), *shape)
    w[..., 3] = 0.0  # an all-zero column: the 1e-12 floor of the scale
    want = jquant.quantize_int8(w)
    got = tquant.quantize_int8(w if how == "host" else torch.from_numpy(w))
    assert got.mode == "int8" and got.shape == tuple(want.shape)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if how == "device":
        close_to_jax_device_quantizer(got, jnp.asarray(w))


def test_quantize_int8_of_a_bf16_head_equals_jax():
    """The engine quantizes the LM head from the activation dtype."""
    w = weights(9, 128, 64)
    w16 = jnp.asarray(w, jnp.bfloat16)
    want = jquant.quantize_int8(np.asarray(w16.astype(jnp.float32)))
    got = tquant.quantize_int8(torch.from_numpy(w).bfloat16())
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    close_to_jax_device_quantizer(got, w16)


def test_quantize_group_replaces_the_big_projections():
    rng = np.random.default_rng(0)
    L, C, F = 3, 128, 256
    stacked = {
        "ln1_w": rng.standard_normal((L, C)),
        "att": {k: rng.standard_normal((L, C, C))
                for k in ("receptance", "key", "value", "output")},
        "ffn": {"key": rng.standard_normal((L, C, F)),
                "value": rng.standard_normal((L, F, C)),
                "x_k": rng.standard_normal((L, C))},
    }
    stacked["att"]["w1"] = rng.standard_normal((L, C, 8))
    want = jquant.quantize_group(
        jax.tree.map(lambda x: x, stacked), "int8")
    got = tquant.quantize_group(stacked, "int8")
    for part in ("att", "ffn"):
        for k, leaf in want[part].items():
            if isinstance(leaf, jquant.QuantizedLinear):
                np.testing.assert_array_equal(got[part][k].q.numpy(),
                                              np.asarray(leaf.q))
                np.testing.assert_array_equal(got[part][k].scale.numpy(),
                                              np.asarray(leaf.scale))
            else:
                assert got[part][k] is stacked[part][k]
    assert isinstance(stacked["att"]["key"], np.ndarray)  # input untouched
    view = tquant.QuantizedLayerView(got["ffn"]["key"], 2)
    assert view.q.data_ptr() == got["ffn"]["key"].q[2].data_ptr()
    assert view.shape == (C, F) and view.mode == "int8"


@pytest.mark.parametrize("mode", ["nf4", "sf4", "int4"])
def test_4bit_modes_name_their_roadmap_item(mode):
    """The 4-bit modes quantize (they used to name a ROADMAP item): a group
    comes back with packed uint8 codes of that mode, equal to the JAX
    package's, and an unknown mode is a ValueError naming the four."""
    w = {"att": {"key": weights(1, 2, 128, 64)},
         "ffn": {"value": weights(2, 2, 256, 128)}}
    got = tquant.quantize_group(w, mode)
    want = jquant.quantize_group(
        {part: dict(leaves) for part, leaves in w.items()}, mode)
    for part, key in (("att", "key"), ("ffn", "value")):
        leaf = got[part][key]
        assert leaf.mode == mode and leaf.q.dtype == torch.uint8
        assert leaf.q.shape[-2] == 32 and leaf.shape == w[part][key].shape[1:]
        np.testing.assert_array_equal(leaf.q.numpy(),
                                      np.asarray(want[part][key].q))
        np.testing.assert_array_equal(leaf.scale.numpy(),
                                      np.asarray(want[part][key].scale))
    node = tquant.QuantizedLinear(mode, got["att"]["key"].q,
                                  got["att"]["key"].scale, (128, 64))
    assert node.dequant().shape == (2, 128, 64)
    with pytest.raises(ValueError, match="int8, nf4, sf4, int4"):
        tquant.QuantizedLinear(mode + "x", None, None, (128, 8))


# ---------------------------------------------------------------------------
# matmul_int8 / matmul_int8_l against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("R,out", [(1, 128), (3, 384), (8, 256)])
def test_matmul_int8_equals_pallas(name, out_f32, R, out):
    jq = jquant.quantize_int8(weights(R, 256, out))
    rng = np.random.default_rng(out)
    x = jnp.asarray(rng.standard_normal((R, 256)) * 0.5, JDT[name])
    want = quant_pallas.matmul_int8(
        x, jq.q, jq.scale, interpret=True,
        out_dtype=jnp.float32 if out_f32 else None)
    q, s = torch_codes(jq)
    got = matmul_int8(as_torch(x, TDT[name]), q, s,
                      out_dtype=torch.float32 if out_f32 else None)
    assert got.shape == (R, out)
    assert got.dtype == (torch.float32 if out_f32 else TDT[name])
    rounded = name == "bfloat16" and not out_f32
    assert rel(to_np(got), want.astype(jnp.float32)) <= (
        BF16_TOL if rounded else F32_TOL)
    assert torch.equal(got, matmul_int8_plain(
        as_torch(x, TDT[name]), q, s, torch.float32 if out_f32 else None))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_matmul_int8_l_equals_pallas(name, R):
    L, K, out = 3, 256, 128
    jq = jquant.quantize_int8(weights(R, L, K, out))
    rng = np.random.default_rng(R)
    x = jnp.asarray(rng.standard_normal((R, 1, K)) * 0.5, JDT[name])
    q, s = torch_codes(jq)
    tol = BF16_TOL if name == "bfloat16" else F32_TOL
    for l in range(L):
        want = quant_pallas.matmul_int8_l(x, jq.q, jq.scale, l,
                                          interpret=True)
        got = matmul_int8_l(as_torch(x, TDT[name]), q, s, l)
        assert got.shape == (R, 1, out) and got.dtype == TDT[name]
        assert rel(to_np(got), want.astype(jnp.float32)) <= tol
        # A layer's view takes the same road.
        view = tquant.QuantizedLayerView(
            tquant.QuantizedLinear("int8", q, s, (K, out)), l)
        assert torch.equal(view.matmul(as_torch(x, TDT[name])), got)


def test_bf16_dequant_rounds_the_scale_first():
    """The kernels' weight is bf16(q) * bf16(s) rounded to bf16, not the
    f32 product rounded once: the two differ on some elements, and the
    plain version must follow the kernels."""
    from ai00_server_tpu_torch.ops.quant_matmul import dequant_cd

    jq = jquant.quantize_int8(weights(4, 256, 128))
    q, s = torch_codes(jq)
    want = (jq.q.astype(jnp.bfloat16) * jq.scale.astype(jnp.bfloat16)
            ).reshape(256, 128).astype(jnp.float32)
    got = dequant_cd(q, s, torch.bfloat16)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    once = tquant.QuantizedLinear("int8", q, s, (256, 128)).dequant(
        torch.bfloat16)
    assert not torch.equal(once, got)


# ---------------------------------------------------------------------------
# The prefill form: dequantize once, one large product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_form_equals_jax_matmul(name, stacked):
    """Above ``KERNEL_ROWS`` rows both packages dequantize (f32 product,
    rounded once) and take one product; on the CPU the JAX package does so
    at any row count."""
    K, out, R = 256, 128, 520
    w = weights(2, 2, K, out) if stacked else weights(2, K, out)
    jq = jquant.quantize_int8(w)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((4, R // 4, K)) * 0.5, JDT[name])
    q, s = torch_codes(jq)
    tq = tquant.QuantizedLinear("int8", q, s, (K, out))
    if stacked:
        want = jquant.QuantizedLayerView(jq, 1).matmul(x)
        got = tquant.QuantizedLayerView(tq, 1).matmul(as_torch(x, TDT[name]))
    else:
        want = jq.matmul(x)
        got = tq.matmul(as_torch(x, TDT[name]))
    np.testing.assert_array_equal(
        to_np(tq.dequant(TDT[name])),
        np.asarray(jq.dequant(JDT[name]).astype(jnp.float32)))
    assert got.shape == (4, R // 4, out) and got.dtype == TDT[name]
    assert rel(to_np(got), want.astype(jnp.float32)) <= (
        BF16_TOL if name == "bfloat16" else F32_TOL)


# ---------------------------------------------------------------------------
# ffn7_t1_l against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_ffn7_t1_l_equals_pallas(name, B):
    L, C, F, l = 3, 128, 512, B % 3
    key = jquant.quantize_int8(weights(B, L, C, F))
    val = jquant.quantize_int8(weights(B + 1, L, F, C))
    rng = np.random.default_rng(B)
    xf = jnp.asarray(rng.standard_normal((B, C)), JDT[name])
    shift = rng.standard_normal((B, C)).astype(np.float32)
    mix = jnp.asarray(rng.standard_normal(C) * 0.3, JDT[name])
    active = np.ones(B, np.bool_)
    active[B // 2] = B == 1  # one inactive row (none when B = 1)
    want, want_shift = ffn_pallas.ffn7_t1_l(
        xf, jnp.asarray(shift), mix, jnp.asarray(active), key.q, key.scale,
        val.q, val.scale, l, qmode="int8", interpret=True)
    args = (as_torch(xf, TDT[name]), torch.from_numpy(shift.copy()),
            as_torch(mix, TDT[name]), torch.from_numpy(active),
            *torch_codes(key), *torch_codes(val), l)
    got, got_shift = ffn7_t1_l(*args)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    assert got_shift.dtype == torch.float32
    assert rel(got.numpy(), want) <= (BF16_TOL if name == "bfloat16"
                                      else F32_TOL)
    np.testing.assert_array_equal(got_shift.numpy(), np.asarray(want_shift))
    np.testing.assert_array_equal(args[1].numpy(), shift)  # not written
    if B > 1:  # the inactive row keeps its shift state bit for bit
        np.testing.assert_array_equal(got_shift.numpy()[B // 2],
                                      shift[B // 2])
        assert not np.array_equal(got_shift.numpy()[0], shift[0])
    plain, plain_shift = ffn7_t1_l_plain(*args)
    assert torch.equal(got, plain) and torch.equal(got_shift, plain_shift)
