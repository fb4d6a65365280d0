"""Dequant-in-matmul: ``y = x @ (level(codes) * per-block scale)`` on int8
codes and on packed 4-bit codes (nf4 / sf4 / int4).

Port of ``ai00_server_tpu/ops/quant_pallas.py`` (``matmul_int8``,
``matmul_int8_l``, ``matmul_4bit``, ``matmul_4bit_l``, ``decode_nibble``,
``dequant4_tile``) onto one hand-written CUDA kernel per code width, each
with two entry points (``csrc/quant.cu``; the note there says what bounds
them and what their design does about it).  The codes cross device memory
once, as stored, for all rows; the ``_l`` entry points take the STACKED
codes of a layer group and a layer index and offset the base pointers, so
no layer is ever sliced into a copy.  The three 4-bit modes differ only in
their 16 integer levels (``ops.quant.LEVELS``), which the kernel takes as a
table: one kernel serves all three.

Rounding follows the Pallas kernels: the weight is dequantized in the
activation dtype ``cd`` — ``w = level.astype(cd) * s.astype(cd)``, so in
bf16 the scale is rounded first and the product again (the levels are exact
in bf16) — and ``x . w`` is summed in f32.  (``QuantizedLinear.dequant``
multiplies in f32 and rounds once; that is the prefill form.)

The wrappers are for decode shapes: the codes are read once per 8 rows.
``ops.quant`` sends 512 rows and more to ``dequant()`` and one large
product for every mode; the reference keeps 4-bit on its kernel at all row
counts only because its device has no fast table gather, which is not
carried over.

Beside the wrappers stand the plain PyTorch versions (``*_plain``); a
wrapper runs one only for CPU tensors, and on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quant import (INT8_BLOCK, LEVELS, NF4_BLOCK, levels_tensor,
                    unpack_codes)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def matmul_int8_l_plain(x, q, scale, l: int):
    """The plain PyTorch version of :func:`matmul_int8_l`."""
    return matmul_int8_plain(x, q[l], scale[l])


def matmul_4bit_plain(x, q, scale, mode: str = "nf4"):
    """The plain PyTorch version of :func:`matmul_4bit`."""
    w = dequant4_cd(q, scale, mode, x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def matmul_4bit_l_plain(x, q, scale, l: int, mode: str = "nf4"):
    """The plain PyTorch version of :func:`matmul_4bit_l`."""
    return matmul_4bit_plain(x, q[l], scale[l], mode)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


class _Workspace:
    """Per-device scratch of the kernels: partial sums of the blocks that
    share a column tile, and the tiles' arrival counters (zeroed here, left
    zeroed by every launch).  Launches on one stream take turns with it."""

    def __init__(self):
        self.scratch = None
        self.counters = None

    def ensure(self, dev, floats: int, counters: int):
        if self.scratch is None or self.scratch.numel() < floats:
            self.scratch = torch.empty(max(1, floats), dtype=torch.float32,
                                       device=dev)
        if self.counters is None or self.counters.numel() < counters:
            self.counters = torch.zeros(max(1, counters), dtype=torch.int32,
                                        device=dev)
        return self


_workspaces: dict = {}


@functools.lru_cache(maxsize=None)
def _need(K: int, N: int) -> tuple[int, int]:
    lib = _build.library("quant")
    return (lib.matmul_int8_scratch_floats(K, N),
            lib.matmul_int8_counters(K, N))


def workspace(dev, shapes) -> _Workspace:
    """The device's work space, large enough for each ``(K, N)`` product."""
    needs = [_need(int(K), int(N)) for K, N in shapes]
    ws = _workspaces.setdefault(dev, _Workspace())
    return ws.ensure(dev, max(n[0] for n in needs), max(n[1] for n in needs))


def _require_4bit(mode: str) -> None:
    _require(mode in LEVELS, f"unknown 4-bit mode {mode!r}: one of "
             f"{', '.join(LEVELS)}")


def levels_table(mode: str):
    """The 16 levels of a 4-bit mode as a host ``int32[16]`` for a
    launcher (keep it alive across the call)."""
    _require_4bit(mode)
    return (ctypes.c_int32 * 16)(*LEVELS[mode])


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
    _require(q.data_ptr() % 4 == 0 and scale.data_ptr() % 16 == 0,
             "codes must be 4-byte and scales 16-byte aligned")
    _require(q.device == dev and scale.device == dev,
             "all operands must be on one device")
    return nb * block, out


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
    xr = x.reshape(-1, K)
    if not xr.is_contiguous():
        xr = xr.contiguous()
    R = xr.shape[0]
    y = torch.empty((R, N), dtype=out_dtype, device=dev)
    ws = workspace(dev, [(K, N)])
    lib = _build.library("quant")
    tail = (y.data_ptr(), R, K, N, _DTYPE_CODE[cd],
            int(out_dtype == torch.float32 and cd != torch.float32),
            ws.scratch.data_ptr(), ws.scratch.numel(),
            ws.counters.data_ptr(), ws.counters.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    head = (xr.data_ptr(), q.data_ptr(), scale.data_ptr())
    if mode == "int8":
        name = "matmul_int8_l" if stacked else "matmul_int8"
        mid = (l,) if stacked else ()
    else:
        name = "matmul_4bit_l" if stacked else "matmul_4bit"
        table = levels_table(mode)
        mid = (ctypes.addressof(table), l) if stacked else (
            ctypes.addressof(table),)
    status = getattr(lib, name + "_launch")(*head, *mid, *tail)
    _build.check(status, name)
    return y.reshape(lead + (N,)), -(-R // 8)


def matmul_int8(x, q, scale, out_dtype=None):
    """``y = x @ (q * scale)``: x ``(..., in)`` f32 / bf16; q ``(nb, 128,
    out)`` int8; scale ``(nb, 1, out)`` f32.  Returns ``(..., out)`` in
    ``x.dtype``, or in f32 with ``out_dtype=torch.float32`` (the LM head
    wants the f32 sums un-rounded).  Right for any row count; the codes are
    read once per 8 rows.  The sums' order is fixed, so equal inputs give
    equal bits."""
    if x.device.type == "cpu":
        return matmul_int8_plain(x, q, scale, out_dtype)
    y, n = _launch(x, q, scale, 0, False, out_dtype)
    matmul_int8.launches += n
    return y


matmul_int8.launches = 0


def matmul_int8_l(x, q, scale, l: int):
    """``y = x @ (q[l] * scale[l])`` with STACKED codes: q ``(L, nb, 128,
    out)``, scale ``(L, nb, 1, out)``, ``l`` a host int.  The kernel
    offsets its base pointers to layer ``l``; nothing is sliced or copied.
    Returns ``(..., out)`` in ``x.dtype``."""
    if x.device.type == "cpu":
        return matmul_int8_l_plain(x, q, scale, l)
    y, n = _launch(x, q, scale, int(l), True, None)
    matmul_int8_l.launches += n
    return y


matmul_int8_l.launches = 0


def matmul_4bit(x, q, scale, mode: str = "nf4"):
    """``y = x @ dequant4(q, scale)``: x ``(..., in)`` f32 / bf16; q ``(nb,
    32, out)`` uint8, two codes a byte, split-half (``ops.quant``); scale
    ``(nb, 1, out)`` f32; ``mode`` nf4 / sf4 / int4.  Returns ``(..., out)``
    in ``x.dtype``.  Right for any row count; the codes are read once per 8
    rows.  The sums' order is fixed, so equal inputs give equal bits."""
    _require_4bit(mode)
    if x.device.type == "cpu":
        return matmul_4bit_plain(x, q, scale, mode)
    y, n = _launch(x, q, scale, 0, False, None, mode)
    matmul_4bit.launches += n
    return y


matmul_4bit.launches = 0


def matmul_4bit_l(x, q, scale, l: int, mode: str = "nf4"):
    """``y = x @ dequant4(q[l], scale[l])`` with STACKED packed codes: q
    ``(L, nb, 32, out)``, scale ``(L, nb, 1, out)``, ``l`` a host int.  The
    kernel offsets its base pointers to layer ``l``; nothing is sliced or
    copied.  Returns ``(..., out)`` in ``x.dtype``."""
    _require_4bit(mode)
    if x.device.type == "cpu":
        return matmul_4bit_l_plain(x, q, scale, l, mode)
    y, n = _launch(x, q, scale, int(l), True, None, mode)
    matmul_4bit_l.launches += n
    return y


matmul_4bit_l.launches = 0
