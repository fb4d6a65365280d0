"""Weight quantization — int8, NF4, SF4, int4: codes stored on the device,
dequantized inside the product.

Port of ``ai00_server_tpu/ops/quant.py`` (``INT8_BLOCK``, ``NF4_BLOCK``,
the level tables, ``QuantizedLinear``, the host and device quantizers,
``QUANTIZERS``, ``quantize_group``, ``QuantizedLayerView``).  Same codes and
scales, bit for bit:

* int8: symmetric per-(128-row block of ``in``, output column) scaling,
  ``s = max(absmax / 127, 1e-12)``, ``q = clip(round(w / s), -127, 127)``;
  codes ``(..., nb, 128, out)`` int8, scales ``(..., nb, 1, out)`` f32.
* nf4 / sf4 / int4: per-(64-row block of ``in``, output column) absmax
  (floored at 1e-12).  nf4 and sf4 pick the nearest of 16 levels of
  ``w / absmax`` and store ``absmax / 127``; the levels DECODE as the integer
  tables ``round(table * 127)`` (:data:`LEVELS`), exact in bf16.  int4 is the
  uniform grid ``code - 8`` with ``s = absmax / 8``,
  ``code = clip(round(w / s), -8, 7) + 8``.  Codes ``(..., nb, 32, out)``
  uint8, two per byte packed SPLIT-HALF along ``in``: byte row ``i`` of a
  block holds block row ``i`` in its low nibble and row ``32 + i`` in its
  high nibble.  Scales ``(..., nb, 1, out)`` f32.

The codes of a layer group stay in ONE stacked tensor on the device; a
layer's weight is a :class:`QuantizedLayerView` — the stacked tensors plus
an index — and nothing copies codes per step.

On a tensor-parallel mesh (``parallel/sharding.py``) a weight splits with
:meth:`QuantizedLinear.sliced` (an ``out`` slice in every mode, an ``in``
slice of whole scale blocks), and an ``in`` slice that does not fall on
whole blocks is kept whole as :class:`QuantizedRows`.

The 4-bit modes are served packed, at their own bytes.  The reference's int8
surrogate of 4-bit codes (``to_int8_surrogate``, ``repack_surrogate``,
``surrogate_group``) belongs to its prefab export and comes with the
ROADMAP's ".state files, LoRA and prefab" item.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

INT8_BLOCK = 128
NF4_BLOCK = 64

# QLoRA NormalFloat-4 quantiles.
NF4_TABLE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], np.float32)

# SF4: sign+exponent-ish levels (denser near zero than NF4's quantiles).
SF4_TABLE = np.array([
    -1.0, -0.5, -0.25, -0.125, -0.0625, -0.03125, -0.015625, 0.0,
    0.015625, 0.03125, 0.0625, 0.125, 0.25, 0.5, 0.75, 1.0,
], np.float32)

# Integer decode tables: a 4-bit code reconstructs as round(table * 127)
# (exact in bf16) with the / 127 folded into the stored block scale.
# ``dequant()`` and the kernels use the SAME levels, so prefill and decode
# agree on the weight's value.
NF4_TABLE8 = np.round(NF4_TABLE * 127.0).astype(np.int32)
SF4_TABLE8 = np.round(SF4_TABLE * 127.0).astype(np.int32)

# The 16 integer levels a nibble decodes to, per 4-bit mode: all a kernel
# needs to know of the mode.
LEVELS = {"nf4": tuple(int(v) for v in NF4_TABLE8),
          "sf4": tuple(int(v) for v in SF4_TABLE8),
          "int4": tuple(range(-8, 8))}
MODES = ("int8", *LEVELS)

# The big projections a quantized layer stores as codes (the reference
# quantizes the matmul weights, not norms or mixers).
QUANT_KEYS_ATT = ("receptance", "key", "value", "gate", "output")
QUANT_KEYS_FFN = ("receptance", "key", "value")


def require_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}: one of "
                         f"{', '.join(MODES)}")


def unpack_codes(q):
    """Packed ``(..., nb, 32, out)`` uint8 -> the nibbles ``(..., nb, 64,
    out)`` in block-row order (low nibbles are rows 0-31, high 32-63)."""
    return torch.cat([q & 0x0F, q >> 4], dim=-2)


@functools.lru_cache(maxsize=None)
def _levels_tensor(mode: str, dtype, device: str) -> torch.Tensor:
    return torch.tensor(LEVELS[mode], dtype=dtype, device=device)


def levels_tensor(mode: str, dtype, device) -> torch.Tensor:
    """The 16 decode levels of a 4-bit mode as a ``dtype`` tensor on
    ``device``; made once per (mode, dtype, device) and kept, so a
    dequantize copies nothing from the host."""
    return _levels_tensor(mode, dtype, str(device))


# The most rows of x a product sends to the dequant-in-matmul kernels
# (ops/quant_matmul.py, one launch per 64 rows); more go through dequant()
# and one torch.matmul.  Set where the kernels stop winning on the card at
# the v7 0.4B layer's int8 products (PERF.md, the crossover of
# tools/torch_quant_ab.py).  The layer path, the prefill and the int8 LM
# head (engine.head_logits) all read it.
KERNEL_ROWS = 128


def _rows(x) -> int:
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows


class QuantizedLinear:
    """A quantized ``(..., in, out)`` weight: ``mode`` one of :data:`MODES`;
    ``q`` the codes — int8 ``(..., nb, 128, out)``, or for a 4-bit mode
    packed uint8 ``(..., nb, 32, out)``; ``scale`` f32 ``(..., nb, 1,
    out)``; ``shape`` the logical ``(in, out)`` of the last two dims."""

    def __init__(self, mode: str, q, scale, shape):
        require_mode(mode)
        self.mode = mode
        self.q = q
        self.scale = scale
        self.shape = tuple(int(d) for d in shape)

    def dequant(self, dtype=torch.float32):
        """The weight as one tensor: multiplied in f32 and rounded once
        (the prefill form; the decode kernels round the scale first)."""
        if self.mode == "int8":
            w = self.q.float() * self.scale
        else:
            table = levels_tensor(self.mode, torch.float32, self.q.device)
            w = table[unpack_codes(self.q).long()] * self.scale
        return w.reshape(tuple(self.q.shape[:-3]) + self.shape).to(dtype)

    def matmul(self, x, out_dtype=None):
        """``x @ W``, result in ``x.dtype``, or the f32 sums un-rounded with
        ``out_dtype=torch.float32``.  Up to ``KERNEL_ROWS`` rows (unstacked
        codes) the dequant-in-matmul kernel of the mode; above, the weight
        is dequantized once for one large product (the reference keeps
        4-bit on its kernel at every row count only for want of a fast
        table gather on its device)."""
        if _rows(x) <= KERNEL_ROWS and self.q.ndim == 3:
            from .quant_matmul import matmul_4bit, matmul_int8

            kw = {} if out_dtype is None else {"out_dtype": out_dtype}
            if self.mode == "int8":
                return matmul_int8(x, self.q, self.scale, **kw)
            return matmul_4bit(x, self.q, self.scale, mode=self.mode, **kw)
        return product(x, self.dequant(x.dtype), out_dtype)

    def sliced(self, dim: int, part: int, parts: int):
        """Part ``part`` of ``parts`` equal slices of the logical weight
        along ``dim`` (-1 = out, -2 = in), as a new QuantizedLinear, or None
        where the slice does not fall on whole scale blocks.  An ``out``
        slice is the codes' and the scales' last dim in every mode; an
        ``in`` slice takes whole blocks (128 rows int8, 64 rows 4-bit)."""
        n = self.shape[dim]
        if n % parts:
            raise ValueError(f"{'out' if dim == -1 else 'in'} dim {n} does "
                             f"not split into {parts}")
        if dim == -1:
            axis, size = -1, n // parts
        else:
            block = INT8_BLOCK if self.mode == "int8" else NF4_BLOCK
            if (n // parts) % block:
                return None
            axis, size = -3, n // parts // block
        cut = [slice(None)] * self.q.ndim
        cut[axis] = slice(part * size, (part + 1) * size)
        shape = list(self.shape)
        shape[dim] = n // parts
        return QuantizedLinear(self.mode, self.q[tuple(cut)].contiguous(),
                               self.scale[tuple(cut)].contiguous(), shape)

    def to(self, device) -> "QuantizedLinear":
        return QuantizedLinear(self.mode, self.q.to(device),
                               self.scale.to(device), self.shape)


def product(x, w, out_dtype=None):
    """``x @ w`` with ``w`` in x's dtype: the sums in f32 (a bf16 x bf16
    product is exact in f32), rounded to x's dtype, or returned un-rounded
    with ``out_dtype=torch.float32``.  On the card a bf16 product takes an
    f32 output type, as ``engine.head_logits`` does."""
    if out_dtype is None or out_dtype == x.dtype:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype)
        return y.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def _blocked(shape, block: int = INT8_BLOCK) -> tuple:
    """``(..., in, out)`` -> ``(..., nb, block, out)``."""
    *lead, in_dim, out = shape
    if in_dim % block:
        raise ValueError(f"in dim {in_dim} is not a multiple of {block}")
    return (*lead, in_dim // block, block, out)


def _quantize_int8_numpy(w: np.ndarray):
    wb = np.asarray(w, np.float32).reshape(_blocked(w.shape))
    s = np.abs(wb).max(axis=-2, keepdims=True) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.round(wb / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32), w.shape[-2:]


def quantize_int8(w, device=None) -> QuantizedLinear:
    """Symmetric int8 over ``(..., in, out)`` with a per-(block of ``in``,
    out) scale.

    A numpy array is quantized on the host (the loader's way: full-precision
    weights never reach the device) and its codes moved to ``device``; a
    tensor is quantized where it lies (the engine's way for the LM head).
    Both give the same codes and scales.
    """
    if isinstance(w, np.ndarray):
        q, s, shape = _quantize_int8_numpy(w)
        return QuantizedLinear("int8", torch.from_numpy(q).to(device),
                               torch.from_numpy(s).to(device), shape)
    wb = w.float().reshape(_blocked(w.shape))
    absmax = wb.abs().amax(dim=-2, keepdim=True)
    # A tensor divisor: dividing by a Python scalar may multiply by its
    # reciprocal, which rounds differently from the host's division.
    s = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(wb / s), -127, 127).to(torch.int8)
    if device is not None:
        q, s = q.to(device), s.to(device)
    return QuantizedLinear("int8", q, s, w.shape[-2:])


def _midpoints(mode: str) -> np.ndarray:
    """The 15 decision boundaries between the 16 effective levels
    (``table8 / 127``) of nf4 / sf4, computed in f32 as the reference does."""
    table8 = NF4_TABLE8 if mode == "nf4" else SF4_TABLE8
    eff = table8.astype(np.float32) / 127.0
    return ((eff[1:] + eff[:-1]) / 2).astype(np.float32)


def _quantize_4bit_numpy(w: np.ndarray, mode: str):
    half = NF4_BLOCK // 2
    blocks = np.asarray(w, np.float32).reshape(_blocked(w.shape, NF4_BLOCK))
    absmax = np.maximum(np.abs(blocks).max(axis=-2, keepdims=True), 1e-12)
    if mode == "int4":
        s = absmax / 8.0
        codes = (np.clip(np.round(blocks / s), -8, 7) + 8).astype(np.uint8)
    else:
        s = absmax / 127.0
        # The nearest level = the count of midpoints strictly below.
        codes = np.searchsorted(_midpoints(mode),
                                blocks / absmax).astype(np.uint8)
    packed = (codes[..., :half, :] | (codes[..., half:, :] << 4)).astype(
        np.uint8)
    return packed, s.astype(np.float32), w.shape[-2:]


def quantize_4bit(w, mode: str, device=None) -> QuantizedLinear:
    """nf4 / sf4 / int4 over ``(..., in, out)`` with a per-(64-row block of
    ``in``, out) scale, packed split-half (module docstring).  A numpy array
    is quantized on the host, a tensor where it lies; both give the same
    codes and scales."""
    if mode not in LEVELS:
        raise ValueError(f"unknown 4-bit mode {mode!r}: one of "
                         f"{', '.join(LEVELS)}")
    if isinstance(w, np.ndarray):
        q, s, shape = _quantize_4bit_numpy(w, mode)
        return QuantizedLinear(mode, torch.from_numpy(q).to(device),
                               torch.from_numpy(s).to(device), shape)
    half = NF4_BLOCK // 2
    blocks = w.float().reshape(_blocked(w.shape, NF4_BLOCK))
    absmax = torch.clamp(blocks.abs().amax(dim=-2, keepdim=True), min=1e-12)
    # Tensor divisors throughout: dividing by a Python scalar may multiply
    # by its reciprocal, which rounds differently from the host's division.
    if mode == "int4":
        s = absmax / torch.full_like(absmax, 8.0)
        codes = (torch.clamp(torch.round(blocks / s), -8, 7) + 8).to(
            torch.uint8)
    else:
        s = absmax / torch.full_like(absmax, 127.0)
        mids = torch.from_numpy(_midpoints(mode)).to(blocks.device)
        # right=False: the count of boundaries strictly below the value.
        codes = torch.bucketize(blocks / absmax, mids).to(torch.uint8)
    q = codes[..., :half, :] | (codes[..., half:, :] << 4)
    if device is not None:
        q, s = q.to(device), s.to(device)
    return QuantizedLinear(mode, q, s, w.shape[-2:])


def quantize_nf4(w, device=None) -> QuantizedLinear:
    return quantize_4bit(w, "nf4", device)


def quantize_sf4(w, device=None) -> QuantizedLinear:
    return quantize_4bit(w, "sf4", device)


def quantize_int4(w, device=None) -> QuantizedLinear:
    return quantize_4bit(w, "int4", device)


QUANTIZERS = {"int8": quantize_int8, "nf4": quantize_nf4,
              "sf4": quantize_sf4, "int4": quantize_int4}


def quantize_group(stacked: dict, mode: str, device=None) -> dict:
    """Replace the big linear weights of a stacked layer group (numpy
    arrays with a leading layer axis) by :class:`QuantizedLinear`."""
    require_mode(mode)
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in stacked.items()}
    for part, keys in (("att", QUANT_KEYS_ATT), ("ffn", QUANT_KEYS_FFN)):
        for k in keys:
            w = out[part].get(k)
            if w is not None and getattr(w, "ndim", 0) >= 2:
                out[part][k] = QUANTIZERS[mode](np.asarray(w, np.float32),
                                                device)
    return out


class QuantizedLayerView:
    """Layer ``idx`` of a STACKED :class:`QuantizedLinear` (leading dim =
    layer), selected without copying the stacked codes."""

    def __init__(self, qlin: QuantizedLinear, idx: int):
        self.qlin = qlin
        self.idx = int(idx)

    @property
    def mode(self) -> str:
        return self.qlin.mode

    @property
    def shape(self):
        return self.qlin.shape

    @property
    def q(self):
        """This layer's codes ``(nb, block rows, out)``: a view, not a
        copy."""
        return self.qlin.q[self.idx]

    @property
    def scale(self):
        return self.qlin.scale[self.idx]

    def matmul(self, x, out_dtype=None):
        if _rows(x) <= KERNEL_ROWS:
            from .quant_matmul import matmul_4bit_l, matmul_int8_l

            kw = {} if out_dtype is None else {"out_dtype": out_dtype}
            if self.mode == "int8":
                return matmul_int8_l(x, self.qlin.q, self.qlin.scale,
                                     self.idx, **kw)
            return matmul_4bit_l(x, self.qlin.q, self.qlin.scale, self.idx,
                                 mode=self.mode, **kw)
        return self.layer().matmul(x, out_dtype)

    def layer(self) -> QuantizedLinear:
        """This layer's codes as an unstacked QuantizedLinear (views)."""
        return QuantizedLinear(self.mode, self.q, self.scale, self.shape)


class QuantizedRows:
    """Rows ``r0 .. r1`` of a quantized ``(in, out)`` weight (a
    :class:`QuantizedLinear` or :class:`QuantizedLayerView`) kept whole: a
    tensor-parallel shard's ``in`` slice that does not fall on whole scale
    blocks.  The shard multiplies its input slice by those rows of the
    dequantized weight."""

    def __init__(self, whole, r0: int, r1: int):
        self.whole = whole
        self.r0, self.r1 = int(r0), int(r1)

    @property
    def mode(self) -> str:
        return self.whole.mode

    @property
    def shape(self):
        return (self.r1 - self.r0, self.whole.shape[-1])

    def matmul(self, x, out_dtype=None):
        w = self.whole
        if isinstance(w, QuantizedLayerView):
            w = w.layer()
        return product(x, w.dequant(x.dtype)[..., self.r0:self.r1, :],
                       out_dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (QuantizedLinear, QuantizedLayerView,
                             QuantizedRows))
