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
does about it) holds up to 64 rows, on the tensor cores in bf16, and adds
the slices of K in the shared memory of a thread block cluster: it needs
no work space.

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

import torch

from . import _build
from .v7_decode import (_DTYPE_CODE, _require, _stream, epilogue_plain,
                        launch_table, store_adds)

ROWS = 64          # batch rows per launch
MAXP = 5           # products per launch
MODES = ("none", "int8", "int4")


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


def _matmul_inplace_plain(products, workspace=None):
    return store_adds(products, phased_matmul_plain(products))


def phased_matmul(products, workspace=None):
    """Up to five :class:`ops.v7_decode.Product` in one launch per 64 rows;
    returns their results in order (for ``out="add"`` / ``"gadd"`` the
    tensor that was added into).  Every weight byte is read once for up to
    64 rows; the sums' order is fixed, so equal inputs give equal bits.
    ``W`` and the rows of ``x`` must be 16-byte aligned, N a multiple of 16,
    K and the row stride of ``x`` multiples of 8.  ``workspace`` is the
    stacks' calling convention (``v7_skinny_matmul``'s) and must be None:
    the kernel's partial sums stay in shared memory."""
    if products[0].x.device.type == "cpu":
        return _matmul_inplace_plain(products)
    _require(1 <= len(products) <= MAXP, f"1 to {MAXP} products per launch")
    _require(workspace is None, "phased_matmul takes no work space")
    table, outs, mode, B, dev = launch_table(products, MODES)
    for p in products:
        K, N = p.KN
        _require(N % 16 == 0 and p.W.data_ptr() % 16 == 0,
                 f"W needs 16-byte aligned rows: N={N} a multiple of 16")
        _require(K % 8 == 0 and p.x.stride(0) % 8 == 0
                 and p.x.data_ptr() % 16 == 0,
                 "x needs 16-byte aligned rows: K and its row stride "
                 "multiples of 8")
    status = _build.library("phased").phased_matmul_launch(
        ctypes.addressof(table), len(products), B,
        _DTYPE_CODE[products[0].x.dtype],
        {"none": 0, "int8": 8, "int4": 4}[mode], _stream(dev))
    _build.check(status, "phased_matmul")
    n = -(-B // ROWS)
    phased_matmul.launches += n
    if mode == "int8":
        phased_matmul.int8_launches += n
    elif mode == "int4":
        phased_matmul.int4_launches += n
    return outs


phased_matmul.launches = 0
phased_matmul.int8_launches = 0  # those of them on int8 codes
phased_matmul.int4_launches = 0  # those of them on packed int4 codes
