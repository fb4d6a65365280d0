"""The launch plan of ``ops/phased_matmul`` and its plain arithmetic at edge
shapes.

``plan`` splits a ``phased_matmul`` call into launches of 64 rows, tiles of
output columns, K slices and a cluster size; the kernel
(``csrc/phased.cu``) reads that split from its table and runs nothing
else, so these tests hold the split to what the kernel needs at the served
shapes - RWKV-7 0.4B and 2.9B, RWKV-5 0.4B, RWKV-6 1B6 with its LoRA ranks
32 / 64 and the five strided token-shift products - in every weight mode
and at ragged batches: every (product, column, K row) falls in exactly one
block's work, slices start on scale-block, stage and k-step boundaries,
clusters stay within the portable limit of 8 blocks, and B above 64 runs as
64-row launches.

``block_sums_plain`` (the plain version the kernel is held to on the card)
is held against the TPU kernel's own ``_mono_dot``
(``ai00_server_tpu/ops/v7_phased_pallas.py``, called eagerly on the CPU)
at edge shapes: N of 32 / 96 / 320, K of a single scale block, ragged B.
Tolerance 2e-6 of the largest magnitude (measured 5.3e-7 in f32, 1.5e-7
with bf16 inputs): the same products in f32, summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ai00_server_tpu.ops.v7_phased_pallas import _mono_dot

from ai00_server_tpu_torch.ops import phased_matmul as pm
from ai00_server_tpu_torch.ops import quant as tquant
from ai00_server_tpu_torch.testing import cpu_test_threads

cpu_test_threads()


def v7_layer(C, F, lora):
    return {"rkv": [(C, C)] * 3, "wo": [(C, C)], "fkey": [(C, F)],
            "fval": [(F, C)],
            "lora_down": [(C, lora[k]) for k in "wavg"],
            "lora_up": [(lora[k], C) for k in "wavg"]}


def v56_layer(C, F):
    return {"rkvg": [(C, C)] * 4, "wo": [(C, C)],
            "fkey_frec": [(C, F), (C, C)], "fval": [(F, C)]}


# The product launches of a layer at the served widths; `lora_*` groups
# hold plain weights in every mode.
SERVED = {
    "v7 0.4B": v7_layer(1024, 4096, {"w": 64, "a": 64, "v": 32, "g": 128}),
    "v7 2.9B": v7_layer(2560, 10240, {"w": 96, "a": 96, "v": 64, "g": 320}),
    "v5 0.4B": v56_layer(1024, 3584),
    "v6 1B6": {**v56_layer(2048, 7168), "lora_mw1": [(2048, 5 * 32)],
               "lora_mw2": [(32, 2048)] * 5, "lora_dw1": [(2048, 64)],
               "lora_dw2": [(64, 2048)]},
}
QBLOCK = {"int8": 128, "int4": 64}


def check_plan(shapes, B, mode, dtype=torch.bfloat16):
    launches = pm.plan(shapes, B, mode, dtype)
    # One launch per 64 rows.
    assert [ln.b0 for ln in launches] == list(range(0, B, pm.ROWS))
    assert [ln.rows for ln in launches] == [
        min(pm.ROWS, B - b0) for b0 in range(0, B, pm.ROWS)]
    tile = pm.TILE[dtype]
    step = pm.step_rows(mode)
    for ln in launches:
        assert 1 <= ln.cs <= pm.MAX_CLUSTER
        assert ln.clusters == sum(-(-N // tile) for _, N in shapes)
        items = pm.work_items(ln, shapes, dtype)
        for p, (K, N) in enumerate(shapes):
            mine = [it for it in items if it[0] == p]
            # The product's tiles partition its columns ...
            cols = sorted({(c0, c1) for _, c0, c1, _, _ in mine})
            assert cols[0][0] == 0 and cols[-1][1] == N
            assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
            assert all(c1 - c0 <= tile for c0, c1 in cols)
            for c0, c1 in cols:
                # ... and each tile's slices partition K, once each.
                ks = sorted((k0, k1) for _, a, b, k0, k1 in mine
                            if (a, b) == (c0, c1))
                assert ks[0][0] == 0 and ks[-1][1] == K
                assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))
                assert len(ks) <= ln.cs
                for k0, k1 in ks:
                    assert k0 % step == 0 and k0 % 16 == 0 and k1 > k0
                    if mode in QBLOCK:
                        assert k0 % QBLOCK[mode] == 0
                        assert k1 % QBLOCK[mode] == 0
    return launches


@pytest.mark.parametrize("B", [9, 16, 17, 64, 65, 128])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("model", sorted(SERVED))
def test_plan_covers_every_served_launch(model, mode, B):
    for name, shapes in SERVED[model].items():
        check_plan(shapes, B, "none" if name.startswith("lora") else mode)


@pytest.mark.parametrize("B", [1, 64, 100])
@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_plan_f32_two_blocks_an_sm(mode, B):
    """f32 (the parity models): 128-column tiles and about two blocks an
    SM, as the FMA kernel fits."""
    for name, shapes in SERVED["v7 0.4B"].items():
        m = "none" if name.startswith("lora") else mode
        launches = check_plan(shapes, B, m, torch.float32)
        total = sum(-(-N // 128) for _, N in shapes)
        steps = max(-(-K // pm.step_rows(m)) for K, _ in shapes)
        assert launches[0].cs == max(1, min(8, steps, -(-264 // total)))


def test_plan_keeps_a_launch_to_one_wave_where_that_pays():
    """The card holds 15 clusters of 8 and 39 of 3 (``H100_CLUSTERS``): the
    2.9B fkey launch (40 tiles) takes 2-block clusters in one wave rather
    than 3- or 8-block ones in two or three; the Wo launch (10 tiles)
    takes 8-block clusters, one wave."""
    (fkey,) = pm.plan([(2560, 10240)], 64, "int8")
    assert (fkey.cs, fkey.clusters) == (2, 40)
    (wo,) = pm.plan([(2560, 2560)], 64, "int8")
    assert (wo.cs, wo.clusters) == (8, 10)
    # A card that holds half the clusters (11 of 5, 7 of 8) gets a coarser
    # split of Wo: 5-block clusters in one wave, not 8-block ones in two.
    half = {c: n // 2 for c, n in pm.H100_CLUSTERS.items()}
    (small,) = pm.plan([(2560, 2560)], 64, "int8", clusters=half)
    assert (small.cs, small.kb) == (5, (512,))


def test_plan_table_layout():
    shapes = SERVED["v7 0.4B"]["lora_up"]
    launches = pm.plan(shapes, 100, "none")
    table = list(pm.plan_table(launches))
    assert len(table) == len(launches) * (4 + 2 * pm.MAXP)
    for i, ln in enumerate(launches):
        row = table[i * 14:(i + 1) * 14]
        assert row[:4] == [ln.b0, ln.rows, ln.cs, ln.clusters]
        assert row[4:12:2] == list(ln.blk0) and row[5:13:2] == list(ln.kb)
        assert row[12:] == [0, 0]  # the fifth product's slot, unused


@pytest.mark.parametrize("mode,per_elem", [("none", 2), ("int8", 1),
                                           ("int4", 0.5)])
@pytest.mark.parametrize("B,nr", [(9, 16), (32, 32), (64, 64)])
def test_staged_x_bytes_per_weight_byte(mode, per_elem, B, nr):
    """x is staged once per 256 columns: 2 nr / (256 w) of the weight."""
    shapes = [(2560, 10240)]
    (ln,) = pm.plan(shapes, B, mode)
    x, w = pm.staged_bytes(ln, shapes, mode)
    assert x / w == pytest.approx(2 * nr / (256 * per_elem))


# ---------------------------------------------------------------------------
# block_sums_plain against the TPU kernel's _mono_dot
# ---------------------------------------------------------------------------


def mono_case(mode, cd, K, N, B, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    tdt = torch.float32 if cd == "float32" else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(cd)
    if mode == "none":
        W = torch.from_numpy(w).to(tdt)
        return xt, W, None, xj, jnp.asarray(W.float().numpy())[None], None
    q = tquant.QUANTIZERS[mode](w)
    return (xt, q.q, q.scale, xj, jnp.asarray(q.q.numpy())[None],
            jnp.asarray(q.scale.numpy())[None])


@pytest.mark.parametrize("B", [1, 9, 65])
@pytest.mark.parametrize("N", [32, 96, 320])
@pytest.mark.parametrize("mode,K", [("none", 40), ("int8", 128),
                                    ("int8", 384), ("int4", 64),
                                    ("int4", 192)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_block_sums_plain_equals_mono_dot(cd, mode, K, N, B):
    xt, W, scale, xj, wj, sj = mono_case(mode, cd, K, N, B)
    got = pm.block_sums_plain(xt, W, scale, mode).numpy()
    want = np.asarray(_mono_dot(xj, wj, sj, jnp.dtype(cd),
                                packed4=mode == "int4", transposed=False),
                      np.float32)
    assert got.shape == want.shape == (B, N)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
