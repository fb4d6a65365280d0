"""The launch plan of the dequantizing products (``ops/quant_matmul.plan``)
at the served shapes.

``plan`` splits a ``(R, K) @ (K, N)`` product on int8 or packed 4-bit
codes into launches of up to 64 rows of x (each in the smallest row tile of
8, 16, 32 or 64 that holds them: the codes are read once per launch), tiles
of 128 output columns and K slices over the blocks of a thread block
cluster; the kernel (``csrc/quant.cu``) reads that split from its table and
runs nothing else.  These tests hold the split to what the kernel needs at
the quantized layers of RWKV-7 0.4B and 2.9B, RWKV-6 1B6, RWKV-5 and RWKV-4
0.4B and at the 65,536-column int8 LM head, in every code mode, at R = 1 to
8, 11, 16, 64, 65, 256 and 511: every (row, column, K row) falls in exactly
one block's work, slices start on the 128-row int8 and 64-row 4-bit scale
blocks and hold whole 64-row stages (so a 4-bit byte row's nibble pair i,
32 + i never straddles two blocks), clusters stay within 8 blocks and no
rank is left without rows of K.

``quant_sums_plain`` adds a product in the order the plan fixes (each
block's slice in 64-row stages, the blocks of a cluster in rank order); it
is held against one f32 ``torch.matmul`` at 1e-5 of the largest magnitude
(the same f32 products summed in another order: a few f32 ulps of sums of
up to 10240 terms), and against the Pallas kernels
(``quant_pallas.matmul_int8_l`` / ``matmul_4bit_l``) in interpret mode at a
tiny size with the tolerances of ``tests/test_torch_quant.py``: 2e-5 in
f32, one bf16 ulp (2^-7) of the output's scale on bf16 results.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ai00_server_tpu.ops import quant as jquant
from ai00_server_tpu.ops import quant_pallas

from ai00_server_tpu_torch.ops import quant_matmul as qm
from ai00_server_tpu_torch.ops.device import H100_SMS
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()

MODES = ("int8", "nf4", "sf4", "int4")
ROWS = (*range(1, 9), 11, 16, 64, 65, 256, 511)
QBLOCK = {"int8": 128, "nf4": 64, "sf4": 64, "int4": 64}


def v7_layer(C, F):
    return [(C, C), (C, F), (F, C)]


# The quantized products of a layer of each model at its served width (K,
# N), and the int8 LM head.
SHAPES = {
    "v7 0.4B": v7_layer(1024, 4096),
    "v7 2.9B": v7_layer(2560, 10240),
    "v6 1B6": v7_layer(2048, 7168),
    "v5 0.4B": v7_layer(1024, 3584),
    "v4 0.4B": v7_layer(1024, 4096),
    "head": [(1024, 65536), (2560, 65536)],
}


def check_launches(K, N, R, mode):
    launches = qm.plan(K, N, R, mode)
    # Launches of up to 64 rows cover rows 0 .. R in order, each in the
    # smallest row tile that holds its rows, all with the same split.
    assert len(launches) == -(-R // 64)
    assert [ln.r0 for ln in launches] == list(range(0, R, 64))
    assert [ln.rows for ln in launches] == [min(64, R - r0)
                                            for r0 in range(0, R, 64)]
    for ln in launches:
        assert ln.rt in qm.ROW_TILES and ln.rows <= ln.rt
        assert ln.rt == 8 or ln.rt // 2 < ln.rows
    assert len({(ln.cs, ln.tiles, ln.kb) for ln in launches}) == 1
    ln = launches[0]
    assert 1 <= ln.cs <= qm.MAX_CLUSTER
    assert ln.tiles == -(-N // qm.QTILE)
    assert ln.cs == 1 or ln.tiles * ln.cs <= H100_SMS
    assert ln.kb % QBLOCK[mode] == 0 and ln.kb % qm.QSTAGE == 0
    assert ln.kb * ln.cs >= K > ln.kb * (ln.cs - 1)  # no empty rank
    return ln


def check_coverage(ln, K, N, mode):
    items = qm.block_items(ln, K, N)
    assert len(items) == ln.tiles * ln.cs
    slices = {}
    for c0, c1, k0, k1 in items:
        assert c0 % qm.QTILE == 0 and c1 - c0 <= qm.QTILE
        # Slices start on scale blocks and hold whole stages: a 4-bit byte
        # row (rows i and 32 + i of a 64-row block) lies in one stage.
        assert k0 % QBLOCK[mode] == 0 and (k1 - k0) % qm.QSTAGE == 0
        slices.setdefault((c0, c1), []).append((k0, k1))
    cols = sorted(slices)
    # The tiles partition the columns ...
    assert cols[0][0] == 0 and cols[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    # ... and each tile's slices partition K, in rank order.
    for c in cols:
        ks = slices[c]
        assert ks[0][0] == 0 and ks[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", SHAPES)
def test_plan_covers_served_products(model, mode):
    for K, N in SHAPES[model]:
        for R in ROWS:
            ln = check_launches(K, N, R, mode)
        check_coverage(ln, K, N, mode)


def test_plan_reads_the_codes_once_per_64_rows():
    """The B=64 head is one launch, a 256-row product four; the (1024,
    1024) layer product splits K over a full cluster (8 tiles alone would
    fill 8 of 132 SMs) and the 512-tile head does not split."""
    assert len(qm.plan(1024, 65536, 64, "int8")) == 1
    assert len(qm.plan(1024, 4096, 256, "int8")) == 4
    ln = qm.plan(1024, 1024, 8, "int8")[0]
    assert ln.cs == 8 and ln.kb == 128
    ln = qm.plan(1024, 65536, 8, "int8")[0]
    assert ln.cs == 1 and ln.tiles == 512
    # Fewer SMs, a coarser split.
    assert qm.plan(1024, 4096, 8, "nf4", sms=64)[0].cs == 2


ORDER_CASES = [
    # (K, N, mode, R)
    (1024, 1024, "int8", 8),
    (4096, 1024, "int8", 64),
    (1024, 4096, "nf4", 11),
    (7168, 2048, "int8", 5),
    (2048, 7168, "int4", 1),
    (3584, 1024, "sf4", 65),
    (2560, 2560, "nf4", 16),
    (10240, 1024, "int8", 3),
    (256, 200, "int8", 511),  # ragged columns, ragged last launch
    (192, 64, "nf4", 7),
]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize(
    "K,N,mode,R", ORDER_CASES,
    ids=[f"{K}x{N}-{m}-R{R}" for K, N, m, R in ORDER_CASES])
def test_plan_order_sums(K, N, mode, R, dtype):
    rng = np.random.default_rng(K * 7 + N + R)
    x = torch.from_numpy(rng.standard_normal((R, K), dtype=np.float32))
    x = x.to(dtype).float()
    W = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    got = torch.cat([qm.quant_sums_plain(x, W, ln)
                     for ln in qm.plan(K, N, R, mode)])
    want = torch.matmul(x, W)
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", ("float32", "bfloat16"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("R", (3, 70))
def test_plan_sums_equal_pallas(mode, name, R):
    """The plan's sums of layer 1's dequantized weight (rounded as the
    kernel rounds it) against the Pallas kernel of the mode in interpret
    mode, 70 rows being two launches."""
    L, K, N = 2, 256, 128
    rng = np.random.default_rng(R)
    w = (rng.standard_normal((L, K, N)) / np.sqrt(K)).astype(np.float32)
    jq = jquant.QUANTIZERS[mode](w)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
    x = jnp.asarray(rng.standard_normal((R, K)) * 0.5, jdt)
    if mode == "int8":
        want = quant_pallas.matmul_int8_l(x, jq.q, jq.scale, 1,
                                          interpret=True)
    else:
        want = quant_pallas.matmul_4bit_l(x, jq.q, jq.scale, 1, mode=mode,
                                          interpret=True)
    q, s = torch.from_numpy(np.array(jq.q)), torch.from_numpy(
        np.array(jq.scale))
    W = qm.dequant_mode_cd(q[1], s[1], mode, tdt).float()
    tx = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    got = torch.cat([qm.quant_sums_plain(tx, W, ln)
                     for ln in qm.plan(K, N, R, mode)]).to(tdt)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    err = float(np.abs(got.double().numpy() - want).max())
    tol = 2.0 ** -7 if name == "bfloat16" else 2e-5
    assert err <= tol * max(float(np.abs(want).max()), 1e-6)
