"""Dequant-in-matmul: ``y = x @ (level(codes) * per-block scale)`` on int8
codes and on packed 4-bit codes (nf4 / sf4 / int4).

Port of ``ai00_server_tpu/ops/quant_pallas.py`` (``matmul_int8``,
``matmul_int8_l``, ``matmul_4bit``, ``matmul_4bit_l``, ``decode_nibble``,
``dequant4_tile``) onto one hand-written CUDA kernel for both code widths
(``csrc/quant.cu``; the note there says what bounds it and what its design
does about it), run per the launch :func:`plan`: one launch per 64 rows of
x, each reading the codes once for all its rows.  The ``_l`` entry points
take the STACKED codes of a layer group and a layer index and offset the
base pointers, so no layer is ever sliced into a copy.  The three 4-bit
modes differ only in their 16 integer levels (``ops.quant.LEVELS``), which
the kernel takes as a table.

Rounding follows the Pallas kernels: the weight is dequantized in the
activation dtype ``cd`` — ``w = level.astype(cd) * s.astype(cd)``, so in
bf16 the scale is rounded first and the product again (the levels are exact
in bf16) — and ``x . w`` is summed in f32.  (``QuantizedLinear.dequant``
multiplies in f32 and rounds once; that is the prefill form.)

``ops.quant`` sends products of more than ``KERNEL_ROWS`` rows to
``dequant()`` and one large product for every mode; the reference keeps
4-bit on its kernel at all row counts only because its device has no fast
table gather, which is not carried over.

Beside the wrappers stand the plain PyTorch versions (``*_plain``); a
wrapper runs one only for CPU tensors, and on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .device import H100_SMS, sm_count
from .quant import (INT8_BLOCK, LEVELS, NF4_BLOCK, levels_tensor,
                    unpack_codes)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
QTILE = 128  # output columns a block
QSTAGE = 64  # rows of K a stage of a block's ring
ROW_TILES = (8, 16, 32, 64)  # the kernel's row tiles: 1-8 mma n-tiles
MAX_CLUSTER = 8  # blocks of a cluster: the portable limit


def dequant_cd(q, scale, cd):
    """Codes ``(..., nb, 128, out)`` and scales ``(..., nb, 1, out)`` ->
    the ``(..., in, out)`` weight in ``cd``, rounded as the kernels round
    it: the scale to ``cd`` first, then the product."""
    w = q.to(cd) * scale.to(cd)
    return w.reshape(tuple(q.shape[:-3]) + (q.shape[-3] * q.shape[-2],
                                            q.shape[-1]))


def decode_nibble(codes, mode: str, cd):
    """Nibbles (uint8 in [0, 16)) -> their integer levels in ``cd``."""
    return levels_tensor(mode, cd, codes.device)[codes.long()]


def dequant4_cd(q, scale, mode: str, cd):
    """Packed codes ``(..., nb, 32, out)`` uint8 and scales ``(..., nb, 1,
    out)`` -> the ``(..., in, out)`` weight in ``cd``, rounded as the
    kernels round it: the scale to ``cd`` first, then level x scale."""
    w = decode_nibble(unpack_codes(q), mode, cd) * scale.to(cd)
    return w.reshape(tuple(q.shape[:-3]) + (q.shape[-3] * NF4_BLOCK,
                                            q.shape[-1]))


def dequant_mode_cd(q, scale, mode: str, cd):
    """:func:`dequant_cd` or :func:`dequant4_cd` by ``mode``."""
    if mode == "int8":
        return dequant_cd(q, scale, cd)
    return dequant4_cd(q, scale, mode, cd)


def matmul_int8_plain(x, q, scale, out_dtype=None):
    """The plain PyTorch version of :func:`matmul_int8`."""
    w = dequant_cd(q, scale, x.dtype)
    y = torch.matmul(x.float(), w.float())
    return y.to(out_dtype or x.dtype)


def matmul_int8_l_plain(x, q, scale, l: int, out_dtype=None):
    """The plain PyTorch version of :func:`matmul_int8_l`."""
    return matmul_int8_plain(x, q[l], scale[l], out_dtype)


def matmul_4bit_plain(x, q, scale, mode: str = "nf4", out_dtype=None):
    """The plain PyTorch version of :func:`matmul_4bit`."""
    w = dequant4_cd(q, scale, mode, x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def matmul_4bit_l_plain(x, q, scale, l: int, mode: str = "nf4",
                        out_dtype=None):
    """The plain PyTorch version of :func:`matmul_4bit_l`."""
    return matmul_4bit_plain(x, q[l], scale[l], mode, out_dtype)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


@dataclass(frozen=True)
class QLaunch:
    """One launch of the dequantizing product (``csrc/quant.cu``): rows
    ``r0 .. r0 + rows`` of x in a row tile of ``rt`` (8, 16, 32 or 64:
    the mma n-tiles a decoded fragment feeds); ``tiles`` 128-column tiles,
    one cluster of ``cs`` blocks each; block ``r`` of a cluster sums rows
    ``r kb .. (r + 1) kb`` of K (the kernel reads the same)."""

    r0: int
    rows: int
    rt: int
    cs: int
    tiles: int
    kb: int


def scale_rows(mode: str) -> int:
    """The rows of K a scale block holds: 128 int8, 64 packed 4-bit (byte
    row i of a block holds rows i and 32 + i)."""
    return INT8_BLOCK if mode == "int8" else NF4_BLOCK


def row_tile(rows: int) -> int:
    """The smallest of :data:`ROW_TILES` that holds ``rows``."""
    return next(t for t in ROW_TILES if t >= rows)


@functools.lru_cache(maxsize=None)
def plan(K: int, N: int, R: int, mode: str, sms: int = H100_SMS) -> tuple:
    """The launches of one product ``(R, K) @ (K, N)`` on ``mode`` codes:
    one per ``ROW_TILES[-1]`` rows of x, each in the smallest row tile that
    holds its rows, so the codes are read once per 64 rows.  Columns go in
    ``QTILE`` tiles, one cluster each; K is split over the ``cs`` blocks of
    a cluster in slices of whole scale blocks (:func:`scale_rows`, so each
    slice is whole 64-row stages and every 4-bit byte row keeps its pair
    of rows i, 32 + i): the finest split of at most ``MAX_CLUSTER`` blocks,
    no more than K has scale blocks, whose blocks fit one an SM (``sms``),
    else none.  A slice is rounded up to whole scale blocks, and ranks
    left with nothing are dropped."""
    align = scale_rows(mode)
    tiles = -(-N // QTILE)
    blocks = -(-K // align)
    fits = [c for c in range(1, min(MAX_CLUSTER, blocks) + 1)
            if tiles * c <= sms]
    cs = max(fits, default=1)
    kb = -(-blocks // cs) * align
    cs = -(-K // kb)
    top = ROW_TILES[-1]
    return tuple(QLaunch(r0, min(top, R - r0), row_tile(min(top, R - r0)),
                         cs, tiles, kb) for r0 in range(0, R, top))


@functools.lru_cache(maxsize=None)
def plan_table(launches: tuple) -> ctypes.Array:
    """``launches`` as the kernel's plan table: per launch r0, rows, rt,
    cs, tiles, kb (int64, on the host)."""
    rows = [v for ln in launches
            for v in (ln.r0, ln.rows, ln.rt, ln.cs, ln.tiles, ln.kb)]
    return (ctypes.c_int64 * len(rows))(*rows)


def block_items(launch: QLaunch, K: int, N: int) -> list:
    """The (first column, end column, first K row, end K row) of every
    block of ``launch`` that sums something, as the kernel reads the
    plan."""
    items = []
    for t in range(launch.tiles):
        c0 = t * QTILE
        for r in range(launch.cs):
            k0 = r * launch.kb
            k1 = min(K, k0 + launch.kb)
            if k1 > k0:
                items.append((c0, min(N, c0 + QTILE), k0, k1))
    return items


def quant_sums_plain(x, W, launch: QLaunch):
    """``x @ W`` (f32, (launch.rows, N)) over x's rows ``launch.r0 ..`` in
    the order the plan fixes: each block's slice in stages of ``QSTAGE``
    rows of K added in order, the blocks of a cluster in rank order.
    (Inside a stage the tensor cores' order is the hardware's.)"""
    K, N = W.shape
    xs = x[launch.r0:launch.r0 + launch.rows].float()
    out = torch.zeros(launch.rows, N, dtype=torch.float32)
    for c0, c1, k0, k1 in block_items(launch, K, N):
        block = torch.zeros(launch.rows, c1 - c0, dtype=torch.float32)
        for s0 in range(k0, k1, QSTAGE):
            s1 = min(k1, s0 + QSTAGE)
            block = block + xs[:, s0:s1] @ W[s0:s1, c0:c1].float()
        out[:, c0:c1] = out[:, c0:c1] + block
    return out


def _require_4bit(mode: str) -> None:
    _require(mode in LEVELS, f"unknown 4-bit mode {mode!r}: one of "
             f"{', '.join(LEVELS)}")


@functools.lru_cache(maxsize=None)
def levels_table(mode: str):
    """The 16 levels of a 4-bit mode as a host ``int32[16]`` for a
    launcher (one per mode, kept for the process)."""
    _require_4bit(mode)
    return (ctypes.c_int32 * 16)(*LEVELS[mode])


def require_aligned(*named) -> None:
    """The kernel copies its operands in 16-byte pieces: each of ``named``
    ((name, tensor) pairs) must start on 16 bytes."""
    for name, t in named:
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def check_codes(q, scale, ndim: int, dev, mode: str = "int8") -> tuple[int,
                                                                       int]:
    """Validate codes / scales ``(..., nb, 1, out)`` for the kernels —
    int8 codes ``(..., nb, 128, out)``, or for a 4-bit mode packed uint8
    ``(..., nb, 32, out)`` (``in = nb * 64``); returns ``(in, out)``."""
    _require(q.ndim == ndim and scale.ndim == ndim,
             f"codes and scales must have {ndim} dims, got "
             f"{tuple(q.shape)} / {tuple(scale.shape)}")
    *lead, nb, blk, out = q.shape
    if mode == "int8":
        dtype, rows, block = torch.int8, INT8_BLOCK, INT8_BLOCK
    else:
        dtype, rows, block = torch.uint8, NF4_BLOCK // 2, NF4_BLOCK
    _require(q.dtype == dtype and blk == rows and q.is_contiguous(),
             f"{mode} codes must be contiguous {dtype} (..., nb, {rows}, "
             f"out), got {q.dtype} {tuple(q.shape)}")
    _require(scale.dtype == torch.float32 and scale.is_contiguous()
             and tuple(scale.shape) == (*lead, nb, 1, out),
             f"scales must be contiguous f32 {(*lead, nb, 1, out)}, got "
             f"{scale.dtype} {tuple(scale.shape)}")
    _require(out % 4 == 0, f"out={out} must be a multiple of 4")
    require_aligned(("codes", q), ("scales", scale))
    _require(q.device == dev and scale.device == dev,
             "all operands must be on one device")
    return nb * block, out


def launch_plan(K: int, N: int, R: int, mode: str, dev):
    """:func:`plan` for the card ``dev`` and its table."""
    launches = plan(K, N, R, mode, sm_count(dev.index))
    return launches, plan_table(launches)


def _launch(x, q, scale, l: int, stacked: bool, out_dtype,
            mode: str = "int8"):
    dev = x.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    cd = x.dtype
    _require(cd in _DTYPE_CODE, f"unsupported activation dtype {cd}")
    out_dtype = out_dtype or cd
    _require(out_dtype in (cd, torch.float32),
             f"out_dtype must be {cd} or float32, got {out_dtype}")
    K, N = check_codes(q, scale, 4 if stacked else 3, dev, mode)
    _require(x.shape[-1] == K, f"x has {x.shape[-1]} features, codes {K}")
    if stacked:
        _require(0 <= l < q.shape[0], f"layer {l} of {q.shape[0]}")
    lead = tuple(x.shape[:-1])
    xr = x.reshape(-1, K).contiguous()
    require_aligned(("x", xr))
    R = xr.shape[0]
    y = torch.empty((R, N), dtype=out_dtype, device=dev)
    launches, table = launch_plan(K, N, R, mode, dev)
    status = _build.library("quant").quant_matmul_launch(
        xr.data_ptr(), q.data_ptr(), scale.data_ptr(),
        None if mode == "int8" else ctypes.addressof(levels_table(mode)),
        l, y.data_ptr(), R, K, N, _DTYPE_CODE[cd],
        int(out_dtype == torch.float32 and cd != torch.float32), table,
        len(launches), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, f"quant_matmul ({mode})")
    return y.reshape(lead + (N,)), len(launches)


def matmul_int8(x, q, scale, out_dtype=None):
    """``y = x @ (q * scale)``: x ``(..., in)`` f32 / bf16; q ``(nb, 128,
    out)`` int8; scale ``(nb, 1, out)`` f32.  Returns ``(..., out)`` in
    ``x.dtype``, or in f32 with ``out_dtype=torch.float32`` (the LM head
    wants the f32 sums un-rounded).  Right for any row count; the codes are
    read once per 64 rows (:func:`plan`).  The sums' order is fixed, so
    equal inputs give equal bits."""
    if x.device.type == "cpu":
        return matmul_int8_plain(x, q, scale, out_dtype)
    y, n = _launch(x, q, scale, 0, False, out_dtype)
    matmul_int8.launches += n
    return y


matmul_int8.launches = 0


def matmul_int8_l(x, q, scale, l: int, out_dtype=None):
    """``y = x @ (q[l] * scale[l])`` with STACKED codes: q ``(L, nb, 128,
    out)``, scale ``(L, nb, 1, out)``, ``l`` a host int.  The kernel
    offsets its base pointers to layer ``l``; nothing is sliced or copied.
    Returns ``(..., out)`` in ``x.dtype``, or the f32 sums un-rounded with
    ``out_dtype=torch.float32`` (a tensor-parallel shard's partial sum)."""
    if x.device.type == "cpu":
        kw = {} if out_dtype is None else {"out_dtype": out_dtype}
        return matmul_int8_l_plain(x, q, scale, l, **kw)
    y, n = _launch(x, q, scale, int(l), True, out_dtype)
    matmul_int8_l.launches += n
    return y


matmul_int8_l.launches = 0


def matmul_4bit(x, q, scale, mode: str = "nf4", out_dtype=None):
    """``y = x @ dequant4(q, scale)``: x ``(..., in)`` f32 / bf16; q ``(nb,
    32, out)`` uint8, two codes a byte, split-half (``ops.quant``); scale
    ``(nb, 1, out)`` f32; ``mode`` nf4 / sf4 / int4.  Returns ``(..., out)``
    in ``x.dtype`` (or f32 with ``out_dtype``).  Right for any row count;
    the codes are read once per 64 rows (:func:`plan`).  The sums' order is
    fixed, so equal inputs give equal bits."""
    _require_4bit(mode)
    if x.device.type == "cpu":
        kw = {} if out_dtype is None else {"out_dtype": out_dtype}
        return matmul_4bit_plain(x, q, scale, mode, **kw)
    y, n = _launch(x, q, scale, 0, False, out_dtype, mode)
    matmul_4bit.launches += n
    return y


matmul_4bit.launches = 0


def matmul_4bit_l(x, q, scale, l: int, mode: str = "nf4", out_dtype=None):
    """``y = x @ dequant4(q[l], scale[l])`` with STACKED packed codes: q
    ``(L, nb, 32, out)``, scale ``(L, nb, 1, out)``, ``l`` a host int.  The
    kernel offsets its base pointers to layer ``l``; nothing is sliced or
    copied.  Returns ``(..., out)`` in ``x.dtype`` (or f32 with
    ``out_dtype``)."""
    _require_4bit(mode)
    if x.device.type == "cpu":
        kw = {} if out_dtype is None else {"out_dtype": out_dtype}
        return matmul_4bit_l_plain(x, q, scale, l, mode, **kw)
    y, n = _launch(x, q, scale, int(l), True, out_dtype, mode)
    matmul_4bit_l.launches += n
    return y


matmul_4bit_l.launches = 0
