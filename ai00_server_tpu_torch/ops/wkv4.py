"""The RWKV-4 WKV recurrence over a chunk: a CUDA kernel and its plain
PyTorch version.

The JAX package computes it as a ``lax.scan`` (``models/v4.py:_wkv_scan``,
lines 49-84), not as Pallas; a torch loop over the T steps of a chunk in
every layer would be T launches a layer, so the port has a kernel of its
own, ``csrc/wkv4.cu:wkv4_chunk_launch`` (the note there says what bounds it
and what its design does about it).  It serves prefill chunks and the layer
path at T = 1.  The wrapper launches the kernel for CUDA tensors and runs
the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build

# The types of k and v the kernel reads (widened to f32 in registers).
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wkv4_chunk_plain(aa, bb, pp, k, v, w, u, mask):
    """The plain PyTorch version (the JAX package's ``models/v4._wkv_scan``):
    same contract as :func:`wkv4_chunk`."""
    k, v = k.float(), v.float()
    ys = []
    for t in range(k.shape[1]):
        k_t, v_t, m_t = k[:, t], v[:, t], mask[:, t, None]
        ww = u + k_t
        q = torch.maximum(pp, ww)
        e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
        ys.append((e1 * aa + e2 * v_t) / (e1 * bb + e2))
        ww = pp + w
        q = torch.maximum(ww, k_t)
        e1, e2 = torch.exp(ww - q), torch.exp(k_t - q)
        aa = torch.where(m_t, e1 * aa + e2 * v_t, aa)
        bb = torch.where(m_t, e1 * bb + e2, bb)
        pp = torch.where(m_t, q, pp)
    return (aa, bb, pp), torch.stack(ys, dim=1)


def wkv4_chunk(aa, bb, pp, k, v, w, u, mask):
    """v4 WKV over a chunk.  aa, bb, pp: (B, C) f32; k, v: (B, T, C) in the
    activation dtype (f32 or bf16, both the same; widened to f32 inside);
    w (``-exp(time_decay)``), u (``time_first``): (C,) f32; mask: (B, T)
    bool.  Returns ((aa, bb, pp), y (B, T, C) f32), new tensors.  A masked
    step leaves the state unchanged and its y reads the kept state."""
    if aa.device.type == "cpu":
        return wkv4_chunk_plain(aa, bb, pp, k, v, w, u, mask)
    if aa.device.type != "cuda":
        raise ValueError(f"unsupported device {aa.device}")
    B, C = aa.shape
    T = k.shape[1]
    if k.dtype not in _KV_CODE:
        raise ValueError(f"k and v must be float32 or bfloat16, got {k.dtype}")
    k, v, mask = k.contiguous(), v.contiguous(), mask.contiguous()
    for name, t, shape, dtype in (
            ("aa", aa, (B, C), torch.float32),
            ("bb", bb, (B, C), torch.float32),
            ("pp", pp, (B, C), torch.float32),
            ("k", k, (B, T, C), k.dtype), ("v", v, (B, T, C), k.dtype),
            ("w", w, (C,), torch.float32), ("u", u, (C,), torch.float32),
            ("mask", mask, (B, T), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != aa.device:
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{aa.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    out = [torch.empty_like(aa) for _ in range(3)]
    y = torch.empty((B, T, C), device=aa.device, dtype=torch.float32)
    status = _build.library("wkv4").wkv4_chunk_launch(
        *(t.data_ptr() for t in (aa, bb, pp, k, v, w, u, mask, *out, y)),
        B, T, C, _KV_CODE[k.dtype],
        torch.cuda.current_stream(aa.device).cuda_stream)
    _build.check(status, "wkv4_chunk")
    wkv4_chunk.launches += 1
    return tuple(out), y


wkv4_chunk.launches = 0
