"""The products of the phased decode steps: every weight read once for up to
64 batch rows.

Port of the projection phases of ``ai00_server_tpu/ops/v7_phased_pallas.py``
and ``v56_phased_pallas.py`` (``_mono_dot``, the former's lines 200-242).
:func:`phased_matmul` takes the :class:`ops.v7_decode.Product` of
``v7_skinny_matmul`` — the same operands, epilogues and in-place outputs —
so the stacks swap one op for the other (``ops/v7_phased``,
``ops/v56_phased``).  Where ``v7_skinny_matmul`` holds 8 batch rows and
reads a weight again for every 8 rows, this kernel
(``csrc/phased.cu``; the note there says what bounds it and what its design
does about it) holds up to 64 rows, on the tensor cores (``wgmma``, the
weights fed by TMA) in bf16, and adds the slices of K in the shared memory
of a thread block cluster: it needs no work space.  :func:`plan` splits a
launch's work — tiles of output columns, K slices in whole scale blocks,
the cluster size and the order of the tiles — and the kernel reads it from
its descriptor table.

The arithmetic is the TPU kernel's, which differs from the fused stacks'
for codes: the x tile and the weight are cast to the activation dtype, the
sub-dot of each scale block (128 rows of int8 codes, 64 of packed int4) is
summed in f32, the block's scale multiplies that f32 sub-sum, and the
blocks are added in order.  The fused products instead scale the weight in
the activation dtype before one sum (``v7_decode.v7_skinny_matmul_plain``).
Weights are plain (in the activation dtype), int8 codes ``(K/128, 128, N)``
or packed int4 codes ``(K/64, 32, N)`` (split-half nibbles, ``code - 8``),
each with ``(K/blk, 1, N)`` f32 scales; nf4 / sf4 are not taken (the TPU's
phased kernel reads them only as int8 surrogate codes, which the port does
not carry).

:func:`phased_matmul_plain` is the same function in PyTorch ops; the
wrapper runs it only for CPU tensors and on a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .device import H100_SMS, sm_count
from .v7_decode import (_DTYPE_CODE, MAX_CLUSTER, Launch, _require, _stream,
                        epilogue_plain, launch_table, plan_table, store_adds)

ROWS = 64          # batch rows per launch
MAXP = 5           # products per launch
MODES = ("none", "int8", "int4")
TILE = {torch.bfloat16: 256, torch.float32: 128}  # output columns a block
KC = 64            # rows of K a bf16 stage holds (four wgmma k-steps)
# Clusters of 1..8 bf16 blocks (one an SM) an H100 SXM holds at once, from
# cudaOccupancyMaxActiveClusters (``phased_max_clusters``): a cluster stays
# inside one GPC, so 8-block clusters fill 120 of the 132 SMs.  The wrapper
# asks the card; this is the default of :func:`plan`.
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
FIXED_PASSES = 4   # a launch's fixed cost, counted in stages a block sums


def step_rows(mode: str) -> int:
    """The rows of K a slice holds a multiple of: whole scale blocks (128
    rows of int8 codes, 64 of packed int4) and whole bf16 stages (64)."""
    return 128 if mode == "int8" else KC


def plan(shapes, B: int, mode: str, dtype=torch.bfloat16,
         sms: int = H100_SMS, clusters=None) -> list:
    """The launches of one :func:`phased_matmul` call over ``shapes`` [(K,
    N)] in weight mode ``mode`` at ``B`` rows: one per 64 rows.  Tiles are
    ``TILE[dtype]`` columns, in the products' order, one cluster each.

    bf16: K is split over ``cs`` blocks a cluster, 1 to ``MAX_CLUSTER`` (and
    no more than the longest K has steps), chosen to minimise the waves of
    clusters the card runs (``clusters[cs]`` at once; default
    ``H100_CLUSTERS``) times the stages a block sums plus the launch's fixed
    cost (``FIXED_PASSES``; at equal cost the fewer waves, then the finer
    split): a second wave costs a whole block's time, and a finer split
    fills more SMs.  f32 (the parity models): blocks fit two
    an SM, so about ``2 sms`` of them, as many slices as that takes.  Each
    slice holds whole steps (:func:`step_rows`)."""
    tile, step = TILE[dtype], step_rows(mode)
    tiles = [-(-N // tile) for _, N in shapes]
    total = sum(tiles)
    steps = max(-(-K // step) for K, _ in shapes)

    def rows_of(cs):
        return tuple(-(-K // (cs * step)) * step for K, _ in shapes)

    if dtype == torch.float32:
        cs = max(1, min(MAX_CLUSTER, steps, -(-2 * sms // total)))
    else:
        held = clusters or H100_CLUSTERS

        def cost(cs):
            waves = -(-total // max(1, held[cs]))
            passes = max(-(-kb // KC) for kb in rows_of(cs))
            return waves * (passes + FIXED_PASSES), waves, -cs

        cs = min(range(1, min(MAX_CLUSTER, steps) + 1), key=cost)
    blk0 = tuple(sum(tiles[:i]) for i in range(len(shapes)))
    return [Launch(b0, min(ROWS, B - b0), cs, total, blk0, rows_of(cs))
            for b0 in range(0, B, ROWS)]


def work_items(launch: Launch, shapes, dtype=torch.bfloat16):
    """The (product, first column, end column, first K row, end K row) of
    every block of ``launch`` that sums something, as the kernel reads the
    plan."""
    tile = TILE[dtype]
    items = []
    for c in range(launch.clusters):
        p = max(i for i, b in enumerate(launch.blk0) if b <= c)
        K, N = shapes[p]
        col0 = (c - launch.blk0[p]) * tile
        for r in range(launch.cs):
            k0 = r * launch.kb[p]
            k1 = min(K, k0 + launch.kb[p])
            if k1 > k0:
                items.append((p, col0, min(N, col0 + tile), k0, k1))
    return items


def padded_rows(rows: int) -> int:
    """The rows the bf16 kernel computes for ``rows``: wgmma's N, 16, 32
    or 64."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


def staged_bytes(launch: Launch, shapes, mode: str) -> tuple:
    """(x bytes, weight bytes) the bf16 kernel's TMA boxes move into shared
    memory over ``launch``: every block stages a 64-row box of x (the rows
    padded to 16, 32 or 64) beside each stage of weight boxes of its 256
    columns."""
    nr = padded_rows(launch.rows)
    per_row = {"none": 2 * TILE[torch.bfloat16], "int8": TILE[torch.bfloat16],
               "int4": TILE[torch.bfloat16] // 2}[mode]
    x = w = 0
    for _, _, _, k0, k1 in work_items(launch, shapes):
        passes = -(-(k1 - k0) // KC)
        x += passes * nr * KC * 2
        w += passes * KC * per_row
    return x, w


@functools.lru_cache(maxsize=None)
def _clusters(index: int, wbits: int, rows: int) -> dict:
    """{cs: clusters of the bf16 kernel for ``rows`` padded rows the card
    ``index`` holds at once}."""
    lib = _build.library("phased")
    with torch.cuda.device(index):
        held = {cs: lib.phased_max_clusters(wbits, rows, cs)
                for cs in range(1, MAX_CLUSTER + 1)}
    for cs, n in held.items():
        _build.check(min(n, 0), f"phased_max_clusters({cs})")
    return held


def block_sums_plain(x, W, scale, mode: str):
    """``x @ W`` (B, N) f32 with the TPU kernel's arithmetic: x and the
    weight in x's dtype, each scale block's sub-dot in f32 times its scale,
    the blocks added in order."""
    cd = x.dtype
    xf = x.float()
    if mode == "none":
        return torch.matmul(xf, W.to(cd).float())
    if mode == "int8":
        codes = W.float()
    elif mode == "int4":
        q = W.to(torch.int16)
        codes = torch.cat([(q & 15) - 8, (q >> 4) - 8], dim=-2).float()
    else:
        raise ValueError(f"phased_matmul takes {MODES}, not {mode!r}")
    nb, blk, _ = codes.shape
    codes = codes.to(cd).float()
    sub = torch.einsum("bjk,jkn->jbn", xf.reshape(x.shape[0], nb, blk), codes)
    acc = sub[0] * scale[0]
    for j in range(1, nb):
        acc = acc + sub[j] * scale[j]
    return acc


def phased_matmul_plain(products):
    """The plain PyTorch version of :func:`phased_matmul`, functional:
    returns the list of results (for ``out="add"``, ``y + x @ W``)."""
    return [epilogue_plain(p, block_sums_plain(p.x, p.W, p.scale,
                                               p.weight_mode))
            for p in products]


def _matmul_inplace_plain(products):
    return store_adds(products, phased_matmul_plain(products))


def phased_matmul(products):
    """Up to five :class:`ops.v7_decode.Product` in one launch per 64 rows;
    returns their results in order (for ``out="add"`` / ``"gadd"`` the
    tensor that was added into).  Every weight byte is read once for up to
    64 rows; the sums' order is fixed, so equal inputs give equal bits.
    ``W`` and the rows of ``x`` must be 16-byte aligned, N a multiple of 16,
    K and the row stride of ``x`` multiples of 8.  No work space: the
    kernel's partial sums stay in shared memory."""
    if products[0].x.device.type == "cpu":
        return _matmul_inplace_plain(products)
    _require(1 <= len(products) <= MAXP, f"1 to {MAXP} products per launch")
    table, outs, mode, B, dev = launch_table(products, MODES)
    for p in products:
        K, N = p.KN
        _require(N % 16 == 0 and p.W.data_ptr() % 16 == 0,
                 f"W needs 16-byte aligned rows: N={N} a multiple of 16")
        _require(K % 8 == 0 and p.x.stride(0) % 8 == 0
                 and p.x.data_ptr() % 16 == 0,
                 "x needs 16-byte aligned rows: K and its row stride "
                 "multiples of 8")
    cd = products[0].x.dtype
    wbits = {"none": 0, "int8": 8, "int4": 4}[mode]
    held = (_clusters(dev.index, wbits, padded_rows(min(B, ROWS)))
            if cd == torch.bfloat16 else None)
    launches = plan([p.KN for p in products], B, mode, cd,
                    sm_count(dev.index), held)
    ptab = plan_table(launches)
    status = _build.library("phased").phased_matmul_launch(
        ctypes.addressof(table), len(products), ctypes.addressof(ptab),
        len(launches), _DTYPE_CODE[cd], wbits, _stream(dev))
    _build.check(status, "phased_matmul")
    n = len(launches)
    phased_matmul.launches += n
    if mode == "int8":
        phased_matmul.int8_launches += n
    elif mode == "int4":
        phased_matmul.int4_launches += n
    return outs


phased_matmul.launches = 0
phased_matmul.int8_launches = 0  # those of them on int8 codes
phased_matmul.int4_launches = 0  # those of them on packed int4 codes
