"""The port's 4-bit quantizers (nf4 / sf4 / int4), dequantizing products and
fused channel mix against the JAX package's, on the CPU at tiny shapes.

Inputs come from numpy seeds and go through both packages.  The JAX side
is the Pallas kernel itself in interpret mode (``quant_pallas.matmul_4bit``,
``matmul_4bit_l``, ``ffn_pallas.ffn7_t1_l``); the port's side is each
wrapper on CPU tensors, i.e. the kernel's plain version.

Codes and scales must be EQUAL, bit for bit, from the host quantizer and
from the device one.  Tolerances of the products, relative to each result's
largest magnitude:

* f32: 2e-5.  Both sides dequantize to the same f32 weight; only the order
  of the sums differs.
* bf16: 2^-7, one bf16 ulp of the output's scale.  Both sides round the
  scale to bf16, then level x scale, then sum in f32; a different summation
  order can move a sum across a rounding boundary of the bf16 output (or of
  the bf16 ``hk`` inside the channel mix).  A wrong rounding point — the
  scale applied in f32 — shows as several ulps on many elements.
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
from ai00_server_tpu_torch.ops.quant_matmul import (dequant4_cd, matmul_4bit,
                                                    matmul_4bit_l,
                                                    matmul_4bit_l_plain,
                                                    matmul_4bit_plain)
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

MODES = ["nf4", "sf4", "int4"]
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
# The tables and the quantizers
# ---------------------------------------------------------------------------


def test_tables_equal_jax():
    assert tquant.NF4_BLOCK == jquant.NF4_BLOCK == 64
    for name in ("NF4_TABLE", "SF4_TABLE", "NF4_TABLE8", "SF4_TABLE8"):
        got, want = getattr(tquant, name), getattr(jquant, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tquant.LEVELS["nf4"] == tuple(jquant.NF4_TABLE8)
    assert tquant.LEVELS["sf4"] == tuple(jquant.SF4_TABLE8)
    assert tquant.LEVELS["int4"] == tuple(range(-8, 8))
    assert set(tquant.QUANTIZERS) == set(jquant.QUANTIZERS)
    assert tquant.MODES == ("int8", "nf4", "sf4", "int4")


def tie_weights(mode, shape):
    """Weights with values exactly ON decision boundaries: per block one
    element at the absmax, the others at midpoints between levels (nf4 /
    sf4) or at half-integers of the scale (int4), where side-left
    ``searchsorted`` and round-half-to-even decide."""
    rng = np.random.default_rng(5)
    w = weights(6, *shape)
    *lead, K, N = shape
    blocks = w.reshape(*lead, K // 64, 64, N)
    blocks[..., 0, :] = 2.0  # the absmax of every (block, column)
    if mode == "int4":
        ties = (np.arange(-8, 8) + 0.5) * (2.0 / 8.0)
    else:
        table8 = jquant.NF4_TABLE8 if mode == "nf4" else jquant.SF4_TABLE8
        eff = table8.astype(np.float32) / 127.0
        ties = ((eff[1:] + eff[:-1]) / 2).astype(np.float32) * 2.0
    pick = rng.integers(0, len(ties), blocks[..., 1:40, :].shape)
    blocks[..., 1:40, :] = ties[pick]
    return blocks.reshape(shape).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(128, 64), (64, 200), (3, 192, 72)])
@pytest.mark.parametrize("how", ["host", "device"])
def test_quantize_4bit_codes_and_scales_equal_jax(mode, shape, how):
    w = weights(len(shape), *shape)
    w[..., 3] = 0.0  # an all-zero column: the 1e-12 floor of the absmax
    for arr in (w, tie_weights(mode, shape)):
        want = jquant.QUANTIZERS[mode](arr)
        got = tquant.QUANTIZERS[mode](
            arr if how == "host" else torch.from_numpy(arr))
        assert got.mode == mode and got.shape == tuple(want.shape)
        assert got.q.dtype == torch.uint8
        assert got.scale.dtype == torch.float32
        assert tuple(got.q.shape) == (*shape[:-2], shape[-2] // 64, 32,
                                      shape[-1])
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        # The JAX package's device-side quantizer gives its host one's codes.
        dev = jquant.QUANTIZERS_JAX[mode](jnp.asarray(arr))
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(dev.q))
        for dtype in ("float32", "bfloat16"):
            np.testing.assert_array_equal(
                to_np(got.dequant(TDT[dtype])),
                np.asarray(want.dequant(JDT[dtype]).astype(jnp.float32)))


@pytest.mark.parametrize("mode", MODES)
def test_split_half_packing(mode):
    """Byte row ``i`` of a block holds block row ``i`` in its low nibble
    and row ``32 + i`` in its high nibble; levels decode as integers."""
    w = weights(2, 128, 8)
    ql = tquant.quantize_4bit(w, mode)
    codes = tquant.unpack_codes(ql.q)
    assert tuple(codes.shape) == (2, 64, 8)
    np.testing.assert_array_equal(codes[:, :32].numpy(),
                                  (ql.q & 15).numpy())
    np.testing.assert_array_equal(codes[:, 32:].numpy(), (ql.q >> 4).numpy())
    levels = np.array(tquant.LEVELS[mode], np.float32)
    want = levels[codes.numpy()] * ql.scale.numpy()
    np.testing.assert_array_equal(ql.dequant().numpy(),
                                  want.reshape(128, 8))
    # A 4-bit weight is within one level step of the original (int4 clips
    # +absmax, 8 steps, to its top level 7).
    step = np.abs(np.diff(levels)).max() * ql.scale.numpy().max()
    assert np.abs(ql.dequant().numpy() - w).max() <= step + 1e-6


@pytest.mark.parametrize("mode", MODES)
def test_quantize_group_replaces_the_big_projections(mode):
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
    want = jquant.quantize_group(jax.tree.map(lambda x: x, stacked), mode)
    got = tquant.quantize_group(stacked, mode)
    n = 0
    for part in ("att", "ffn"):
        for k, leaf in want[part].items():
            if isinstance(leaf, jquant.QuantizedLinear):
                n += 1
                assert got[part][k].mode == mode
                np.testing.assert_array_equal(got[part][k].q.numpy(),
                                              np.asarray(leaf.q))
                np.testing.assert_array_equal(got[part][k].scale.numpy(),
                                              np.asarray(leaf.scale))
            else:
                assert got[part][k] is stacked[part][k]
    assert n == 6
    view = tquant.QuantizedLayerView(got["ffn"]["key"], 2)
    assert view.q.data_ptr() == got["ffn"]["key"].q[2].data_ptr()
    assert view.shape == (C, F) and view.mode == mode


def test_unknown_modes_raise_value_error():
    with pytest.raises(ValueError, match="int8, nf4, sf4, int4"):
        tquant.quantize_group({"att": {}, "ffn": {}}, "fp4")
    with pytest.raises(ValueError, match="int8, nf4, sf4, int4"):
        tquant.QuantizedLinear("q5", None, None, (128, 8))
    with pytest.raises(ValueError, match="nf4, sf4, int4"):
        tquant.quantize_4bit(weights(0, 64, 8), "int8")
    with pytest.raises(ValueError, match="multiple of 64"):
        tquant.quantize_nf4(weights(0, 96, 8))


# ---------------------------------------------------------------------------
# matmul_4bit / matmul_4bit_l against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,out", [(1, 128), (3, 384), (8, 256)])
def test_matmul_4bit_equals_pallas(mode, name, R, out):
    jq = jquant.QUANTIZERS[mode](weights(R, 256, out))
    rng = np.random.default_rng(out)
    x = jnp.asarray(rng.standard_normal((R, 256)) * 0.5, JDT[name])
    want = quant_pallas.matmul_4bit(x, jq.q, jq.scale, mode=mode,
                                    interpret=True)
    q, s = torch_codes(jq)
    tx = as_torch(x, TDT[name])
    got = matmul_4bit(tx, q, s, mode=mode)
    assert got.shape == (R, out) and got.dtype == TDT[name]
    assert rel(to_np(got), want.astype(jnp.float32)) <= (
        BF16_TOL if name == "bfloat16" else F32_TOL)
    assert torch.equal(got, matmul_4bit_plain(tx, q, s, mode))
    # The unstacked weight's own matmul takes the same road at these rows.
    assert torch.equal(
        tquant.QuantizedLinear(mode, q, s, (256, out)).matmul(tx), got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 8])
def test_matmul_4bit_l_equals_pallas(mode, name, R):
    L, K, out = 3, 192, 128
    jq = jquant.QUANTIZERS[mode](weights(R, L, K, out))
    rng = np.random.default_rng(R)
    x = jnp.asarray(rng.standard_normal((R, 1, K)) * 0.5, JDT[name])
    q, s = torch_codes(jq)
    tx = as_torch(x, TDT[name])
    tol = BF16_TOL if name == "bfloat16" else F32_TOL
    for l in range(L):
        want = quant_pallas.matmul_4bit_l(x, jq.q, jq.scale, l, mode=mode,
                                          interpret=True)
        got = matmul_4bit_l(tx, q, s, l, mode=mode)
        assert got.shape == (R, 1, out) and got.dtype == TDT[name]
        assert rel(to_np(got), want.astype(jnp.float32)) <= tol
        assert torch.equal(got, matmul_4bit_l_plain(tx, q, s, l, mode))
        # A layer's view takes the same road.
        view = tquant.QuantizedLayerView(
            tquant.QuantizedLinear(mode, q, s, (K, out)), l)
        assert torch.equal(view.matmul(tx), got)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_dequant4_rounds_the_scale_first(mode):
    """The kernels' weight is bf16(level) * bf16(s) rounded to bf16
    (``quant_pallas.dequant4_tile``), not the f32 product rounded once: the
    two differ on some elements, and the plain version must follow the
    kernels."""
    jq = jquant.QUANTIZERS[mode](weights(4, 256, 128))
    q, s = torch_codes(jq)
    packs = (None if mode == "int4" else jquant.pack_table8(
        jquant.NF4_TABLE8 if mode == "nf4" else jquant.SF4_TABLE8))
    want = quant_pallas.dequant4_tile(jq.q, jq.scale, packs, jnp.bfloat16)
    got = dequant4_cd(q, s, mode, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (256, 128)
    np.testing.assert_array_equal(to_np(got),
                                  np.asarray(want.astype(jnp.float32)))
    once = tquant.QuantizedLinear(mode, q, s, (256, 128)).dequant(
        torch.bfloat16)
    assert not torch.equal(once, got)
    # In f32 the two forms are the same weight.
    assert torch.equal(dequant4_cd(q, s, mode, torch.float32),
                       tquant.QuantizedLinear(mode, q, s,
                                              (256, 128)).dequant())


# ---------------------------------------------------------------------------
# The prefill form: dequantize once, one large product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_form_equals_jax_matmul(mode, name, stacked, monkeypatch):
    """Above ``KERNEL_ROWS`` rows the port dequantizes (f32 product, rounded
    once) and takes one product, as the JAX package does off its own device
    at any row count; the wrappers are not called."""
    from ai00_server_tpu_torch.ops import quant_matmul

    def refuse(*a, **k):
        raise AssertionError("a decode kernel was asked for a prefill shape")

    monkeypatch.setattr(quant_matmul, "matmul_4bit", refuse)
    monkeypatch.setattr(quant_matmul, "matmul_4bit_l", refuse)
    K, out, R = 256, 128, 520
    w = weights(2, 2, K, out) if stacked else weights(2, K, out)
    jq = jquant.QUANTIZERS[mode](w)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((4, R // 4, K)) * 0.5, JDT[name])
    q, s = torch_codes(jq)
    tq = tquant.QuantizedLinear(mode, q, s, (K, out))
    if stacked:
        want = jquant.QuantizedLayerView(jq, 1).matmul(x)
        got = tquant.QuantizedLayerView(tq, 1).matmul(as_torch(x, TDT[name]))
    else:
        want = jq.matmul(x)
        got = tq.matmul(as_torch(x, TDT[name]))
    assert got.shape == (4, R // 4, out) and got.dtype == TDT[name]
    assert rel(to_np(got), want.astype(jnp.float32)) <= (
        BF16_TOL if name == "bfloat16" else F32_TOL)


# ---------------------------------------------------------------------------
# ffn7_t1_l in the 4-bit modes against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_ffn7_t1_l_4bit_equals_pallas(mode, name, B):
    L, C, F, l = 3, 128, 512, B % 3
    key = jquant.QUANTIZERS[mode](weights(B, L, C, F))
    val = jquant.QUANTIZERS[mode](weights(B + 1, L, F, C))
    rng = np.random.default_rng(B)
    xf = jnp.asarray(rng.standard_normal((B, C)), JDT[name])
    shift = rng.standard_normal((B, C)).astype(np.float32)
    mix = jnp.asarray(rng.standard_normal(C) * 0.3, JDT[name])
    active = np.ones(B, np.bool_)
    active[B // 2] = B == 1  # one inactive row (none when B = 1)
    want, want_shift = ffn_pallas.ffn7_t1_l(
        xf, jnp.asarray(shift), mix, jnp.asarray(active), key.q, key.scale,
        val.q, val.scale, l, qmode=mode, interpret=True)
    args = (as_torch(xf, TDT[name]), torch.from_numpy(shift.copy()),
            as_torch(mix, TDT[name]), torch.from_numpy(active),
            *torch_codes(key), *torch_codes(val), l)
    got, got_shift = ffn7_t1_l(*args, qmode=mode)
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
    plain, plain_shift = ffn7_t1_l_plain(*args, qmode=mode)
    assert torch.equal(got, plain) and torch.equal(got_shift, plain_shift)
    # The mode matters: another table gives another answer.
    other = "int4" if mode != "int4" else "nf4"
    assert not torch.equal(ffn7_t1_l_plain(*args, qmode=other)[0], plain)
