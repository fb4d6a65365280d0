"""Int8 weight quantization: codes stored on the device, dequantized inside
the product.

Port of the int8 half of ``ai00_server_tpu/ops/quant.py``
(``INT8_BLOCK``, ``QuantizedLinear``, ``quantize_int8``,
``quantize_int8_jax``, ``quantize_group``, ``QuantizedLayerView``).  Same
codes and scales, bit for bit: symmetric per-(128-row block of ``in``,
output column) scaling, ``s = max(absmax / 127, 1e-12)``,
``q = clip(round(w / s), -127, 127)``; codes ``(..., nb, 128, out)`` int8,
scales ``(..., nb, 1, out)`` f32.

The codes of a layer group stay in ONE stacked tensor on the device; a
layer's weight is a :class:`QuantizedLayerView` — the stacked tensors plus
an index — and nothing copies codes per step.

The 4-bit modes (NF4 / SF4 / int4, the int8 surrogate) are ROADMAP queue 1
item 2 and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_BLOCK = 128

# The big projections a quantized layer stores as codes (the reference
# quantizes the matmul weights, not norms or mixers).
QUANT_KEYS_ATT = ("receptance", "key", "value", "gate", "output")
QUANT_KEYS_FFN = ("receptance", "key", "value")


def require_int8(mode: str) -> None:
    if mode != "int8":
        raise NotImplementedError(
            f"quantization mode {mode!r}: NF4 / SF4 / int4 are ROADMAP queue "
            "1 item 2 (4-bit and prefab); this port serves int8")


def _rows(x) -> int:
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows


class QuantizedLinear:
    """A quantized ``(..., in, out)`` weight: ``q`` int8 codes
    ``(..., nb, 128, out)``, ``scale`` f32 ``(..., nb, 1, out)``, ``shape``
    the logical ``(in, out)`` of the last two dims."""

    def __init__(self, mode: str, q, scale, shape):
        require_int8(mode)
        self.mode = mode
        self.q = q
        self.scale = scale
        self.shape = tuple(int(d) for d in shape)

    def dequant(self, dtype=torch.float32):
        """The weight as one tensor: multiplied in f32 and rounded once
        (the prefill form; the decode kernels round the scale first)."""
        w = self.q.float() * self.scale
        return w.reshape(tuple(self.q.shape[:-3]) + self.shape).to(dtype)

    def matmul(self, x):
        """``x @ W``, result in ``x.dtype``.  Decode shapes (under 512
        rows, unstacked codes) go through the dequant-in-matmul kernel;
        prefill shapes dequantize once and take one large product."""
        if _rows(x) < 512 and self.q.ndim == 3:
            from .quant_matmul import matmul_int8

            return matmul_int8(x, self.q, self.scale)
        return torch.matmul(x, self.dequant(x.dtype))


def _blocked(shape) -> tuple:
    """``(..., in, out)`` -> ``(..., nb, 128, out)``."""
    *lead, in_dim, out = shape
    if in_dim % INT8_BLOCK:
        raise ValueError(f"in dim {in_dim} is not a multiple of {INT8_BLOCK}")
    return (*lead, in_dim // INT8_BLOCK, INT8_BLOCK, out)


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


def quantize_group(stacked: dict, mode: str, device=None) -> dict:
    """Replace the big linear weights of a stacked layer group (numpy
    arrays with a leading layer axis) by :class:`QuantizedLinear`."""
    require_int8(mode)
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in stacked.items()}
    for part, keys in (("att", QUANT_KEYS_ATT), ("ffn", QUANT_KEYS_FFN)):
        for k in keys:
            w = out[part].get(k)
            if w is not None and getattr(w, "ndim", 0) >= 2:
                out[part][k] = quantize_int8(np.asarray(w, np.float32),
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
        """This layer's codes ``(nb, 128, out)``: a view, not a copy."""
        return self.qlin.q[self.idx]

    @property
    def scale(self):
        return self.qlin.scale[self.idx]

    def matmul(self, x):
        if _rows(x) < 512:
            from .quant_matmul import matmul_int8_l

            return matmul_int8_l(x, self.qlin.q, self.qlin.scale, self.idx)
        return QuantizedLinear(self.mode, self.q, self.scale,
                               self.shape).matmul(x)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (QuantizedLinear, QuantizedLayerView))
