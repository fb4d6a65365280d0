"""The launch plan of ``v7_skinny_matmul`` (``ops/v7_decode.plan``) at the
served shapes.

``plan`` splits a ``v7_skinny_matmul`` call into launches of 8 rows, tiles
of output columns (64 of bf16 weights, 128 of codes and in f32), K slices
over the blocks of a thread block cluster and, inside a block, runs of
16-row steps over its 8 warps; the kernel (``csrc/v7_decode.cu``) reads
that split from its table and runs nothing else.  These tests hold the
split to what the kernels need at the layers of every fused stack - RWKV-7
0.4B and 2.9B, RWKV-6 1B6 with its LoRA ranks 32 / 64 and the five strided
token-shift products, RWKV-5 and RWKV-4 0.4B - in every weight mode, in
bf16 and f32, at B = 1 to 8 and 11: every (product, column, K row) falls in
exactly one block's work and one warp's, slices start on the 128-row int8
and 64-row 4-bit scale blocks with each warp's 4-bit rows in nibble pairs
(i, 32 + i) of one block, clusters stay within 8 blocks, and B above 8 runs
as 8-row launches.

``plan_sums_plain`` adds a product in the order the plan fixes (each
warp's rows, the warps of a block in order, the blocks of a cluster in rank
order); it is held against one f32 ``torch.matmul``.  Tolerance 1e-5 of
the largest magnitude: the same f32 products summed in another order (the
difference is a few f32 ulps of sums of up to 7168 terms).
"""

import numpy as np
import pytest
import torch

from ai00_server_tpu_torch.ops import v7_decode as fd

MODES = ("none", "int8", "nf4", "sf4", "int4")
BATCHES = (*range(1, 9), 11)
QBLOCK = {"int8": 128, "nf4": 64, "sf4": 64, "int4": 64}


def v7_layer(C, F, lora):
    return {"rkv": [(C, C)] * 3, "wo": [(C, C)], "fkey": [(C, F)],
            "fval": [(F, C)],
            "lora_down": [(C, lora[k]) for k in "wavg"],
            "lora_up": [(lora[k], C) for k in "wavg"]}


def v56_layer(C, F, n_tm):
    return {"tm": [(C, C)] * n_tm, "wo": [(C, C)],
            "fkey_frec": [(C, F), (C, C)], "fval": [(F, C)]}


# The product launches of a layer of each fused stack at its served width;
# the `lora_*` groups hold plain weights in every mode.
STACKS = {
    "v7 0.4B": v7_layer(1024, 4096, {"w": 64, "a": 64, "v": 32, "g": 128}),
    "v7 2.9B": v7_layer(2560, 10240, {"w": 96, "a": 96, "v": 64, "g": 320}),
    "v6 1B6": {**v56_layer(2048, 7168, 4), "lora_mw1": [(2048, 5 * 32)],
               "lora_mw2": [(32, 2048)] * 5, "lora_dw1": [(2048, 64)],
               "lora_dw2": [(64, 2048)]},
    "v5 0.4B": v56_layer(1024, 3584, 4),
    "v4 0.4B": v56_layer(1024, 4096, 3),
}


def check_launches(shapes, B, mode, dtype):
    launches = fd.plan(shapes, B, mode, dtype)
    # One launch per 8 rows, all with the same split.
    assert [ln.b0 for ln in launches] == list(range(0, B, 8))
    assert [ln.rows for ln in launches] == [min(8, B - b0)
                                            for b0 in range(0, B, 8)]
    assert len({(ln.cs, ln.clusters, ln.blk0, ln.kb)
                for ln in launches}) == 1
    ln = launches[0]
    tile = fd.skinny_tile(shapes, dtype, mode)
    align = fd.slice_rows(mode)
    assert 1 <= ln.cs <= fd.MAX_CLUSTER
    assert ln.clusters == sum(-(-N // tile) for _, N in shapes)
    assert ln.blk0 == tuple(sum(-(-N // tile) for _, N in shapes[:i])
                            for i in range(len(shapes)))
    for (K, _), kb in zip(shapes, ln.kb):
        assert kb % align == 0 and kb * ln.cs >= K
    return ln


def check_coverage(ln, shapes, mode, dtype):
    tile = fd.skinny_tile(shapes, dtype, mode)
    items = fd.block_items(ln, shapes, dtype, mode)
    slices = {}
    for p, c0, c1, k0, k1 in items:
        assert c1 - c0 <= tile and c0 % tile == 0
        if mode in QBLOCK:  # slices start on scale blocks
            assert k0 % QBLOCK[mode] == 0
        slices.setdefault(p, {}).setdefault((c0, c1), []).append((k0, k1))
    for p, (K, N) in enumerate(shapes):
        cols = sorted(slices[p])
        # The product's tiles partition its columns ...
        assert cols[0][0] == 0 and cols[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
        # ... and each tile's slices partition K, once each.
        for c in cols:
            ks = sorted(slices[p][c])
            assert ks[0][0] == 0 and ks[-1][1] == K
            assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))
    # A block's warps take each row of its slice once; a warp's 4-bit rows
    # come in nibble pairs (i, 32 + i) of one 64-row block.
    for k0, k1 in {(k0, k1) for _, _, _, k0, k1 in items}:
        warps = fd.warp_rows(k0, k1, mode)
        assert len(warps) == fd.SKINNY_WARPS
        rows = sorted(r for w in warps for r in w)
        assert rows == list(range(k0, k1))
        if mode in ("nf4", "sf4", "int4"):
            for w in warps:
                lo = {r for r in w if r % 64 < 32}
                assert {r + 32 for r in lo} == set(w) - lo


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "f32"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stack", STACKS)
def test_plan_covers_served_layers(stack, mode, dtype):
    for group, shapes in STACKS[stack].items():
        gmode = "none" if group.startswith("lora") else mode
        for B in BATCHES:
            ln = check_launches(shapes, B, gmode, dtype)
        check_coverage(ln, shapes, gmode, dtype)


def test_plan_fills_the_card():
    """The single (1024, 1024) and (4096, 1024) bf16 products split K over
    a cluster (16 tiles alone would fill 16 of 132 SMs), and the wide v6
    key + receptance launch does not split far (its 144 tiles fill the
    card)."""
    for shapes in ([(1024, 1024)], [(4096, 1024)]):
        ln = fd.plan(shapes, 8, "none")[0]
        assert ln.cs == 8 and ln.clusters * ln.cs == 128
    ln = fd.plan([(2048, 7168), (2048, 2048)], 8, "none")[0]
    assert ln.clusters == 144 and ln.cs <= 2


ORDER_CASES = [
    # (K, N, mode, dtype, B)
    (1024, 1024, "none", torch.bfloat16, 8),
    (4096, 1024, "none", torch.bfloat16, 5),
    (1024, 64, "none", torch.bfloat16, 8),
    (32, 2048, "none", torch.bfloat16, 3),
    (2048, 160, "none", torch.bfloat16, 8),
    (7168, 2048, "none", torch.float32, 8),
    (4096, 1024, "int8", torch.bfloat16, 8),
    (1024, 4096, "int8", torch.float32, 1),
    (3584, 1024, "nf4", torch.bfloat16, 8),
    (1024, 1024, "int4", torch.bfloat16, 6),
    (2560, 10240, "sf4", torch.bfloat16, 8),
    (1500, 42, "none", torch.bfloat16, 11),  # ragged: the FMA kernel
]


@pytest.mark.parametrize(
    "K,N,mode,dtype,B", ORDER_CASES,
    ids=[f"{K}x{N}-{m}-{str(d)[6:]}-B{B}" for K, N, m, d, B in ORDER_CASES])
def test_plan_order_sums(K, N, mode, dtype, B):
    rng = np.random.default_rng(K * 7 + N + B)
    x = torch.from_numpy(rng.standard_normal((B, K), dtype=np.float32))
    W = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    ln = fd.plan([(K, N)], B, mode, dtype)[0]
    got = fd.plan_sums_plain(x, W, ln, 0, [(K, N)], dtype, mode)
    want = torch.matmul(x, W)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
