"""The WKV recurrence over a prefill chunk, RWKV-7 and RWKV-5/6: CUDA kernels
and their plain PyTorch versions.

Port of ``ai00_server_tpu/ops/wkv_pallas.py``: ``wkv7_chunk`` (the Pallas
``_wkv7_kernel`` and its wrapper, lines 76-116 and 173-205) and
``wkv56_chunk`` (``_wkv56_kernel``, lines 119-157 and 208-239), renamed
because nothing here is Pallas.  The kernels are
``csrc/wkv7.cu:wkv7_chunk_launch`` and ``csrc/wkv56.cu:wkv56_chunk_launch``:
the state stays in registers for the whole chunk and the inputs are read
straight from the ``(B, T, H, N)`` layout, so the wrappers need no
transpose, no mask folding and no padding of T.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.common import masked_select
from . import _build
from .wkv_t1 import head_vector


def wkv7_chunk_plain(S, r, w, k, v, kk, a, mask):
    """The plain PyTorch version (the JAX package's ``models/v7._wkv_scan``
    recurrence): same contract as :func:`wkv7_chunk`."""
    S = S.float()
    r, w, k, v, kk, a = (t.float() for t in (r, w, k, v, kk, a))
    ys = []
    for t in range(r.shape[1]):
        kk_t = kk[:, t]
        skk = torch.einsum("bhvk,bhk->bhv", S, kk_t)
        S_new = (S * w[:, t, :, None, :]
                 - skk[..., None] * (kk_t * a[:, t])[:, :, None, :]
                 + v[:, t, :, :, None] * k[:, t, :, None, :])
        S = masked_select(mask[:, t], S_new, S)
        ys.append(torch.einsum("bhvk,bhk->bhv", S, r[:, t]))
    return S, torch.stack(ys, dim=1)


def _check(S, seqs, mask):
    B, H, N, N2 = S.shape
    if N != N2 or S.dtype != torch.float32 or not S.is_contiguous():
        raise ValueError(f"state must be contiguous f32 (B, H, N, N), got "
                         f"{S.dtype} {tuple(S.shape)}")
    if N != 64:
        raise ValueError(f"the CUDA kernel takes head size 64, got {N}")
    T = seqs[0].shape[1]
    for t in seqs:
        if t.shape != (B, T, H, N) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"inputs must be contiguous f32 {(B, T, H, N)},"
                             f" got {t.dtype} {tuple(t.shape)}")
    if mask.shape != (B, T) or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous bool {(B, T)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (S, *seqs, mask):
        if t.device != S.device:
            raise ValueError("all operands must be on one device")
    for t in (S, *seqs):  # float4 loads
        if t.data_ptr() % 16:
            raise ValueError("float operands must be 16-byte aligned")


def wkv7_chunk(S, r, w, k, v, kk, a, mask):
    """v7 WKV over a chunk.  S: (B, H, N, N) f32 (v-dim, k-dim);
    r..a: (B, T, H, N) (cast to f32); mask: (B, T) bool.
    Returns (new_S, y (B, T, H, N) f32).  A masked step leaves S unchanged
    and its y reads the kept state."""
    if S.device.type == "cpu":
        return wkv7_chunk_plain(S, r, w, k, v, kk, a, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    seqs = [t.float().contiguous() for t in (r, w, k, v, kk, a)]
    mask = mask.contiguous()
    _check(S, seqs, mask)
    B, H, N, _ = S.shape
    T = seqs[0].shape[1]
    S_out = torch.empty_like(S)
    y = torch.empty((B, T, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv7")
    status = lib.wkv7_chunk_launch(
        S.data_ptr(), *(t.data_ptr() for t in seqs), mask.data_ptr(),
        S_out.data_ptr(), y.data_ptr(), B, T, H, N,
        torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv7_chunk")
    wkv7_chunk.launches += 1
    return S_out, y


wkv7_chunk.launches = 0


def wkv56_chunk_plain(S, r, k, v, w, u, mask):
    """The plain PyTorch version (the JAX package's ``models/v5.wkv_scan``):
    same contract as :func:`wkv56_chunk`."""
    S = S.float()
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        w_t = w if w.dim() == 2 else w[:, t]  # static (H, N) or (B, H, N)
        a = k[:, t, :, :, None] * v[:, t, :, None, :]   # (B, H, N_k, N_v)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * a))
        S = masked_select(mask[:, t], w_t[..., None] * S + a, S)
    return S, torch.stack(ys, dim=1)


def wkv56_chunk(S, r, k, v, w, u, mask):
    """v5/v6 WKV over a chunk.  S: (B, H, N, N) f32 (k-dim, v-dim);
    r, k, v: (B, T, H, N) (cast to f32); w: (B, T, H, N), or (H, N) for
    RWKV-5's static decay (the kernel reads it for every row and step);
    u: (H, N); mask: (B, T) bool.
    Returns (new_S, y (B, T, H, N) f32).  Every step's y reads the state
    before it plus the ``u`` bonus; a masked step leaves S unchanged (its y
    differs from the JAX Pallas kernel's, which folds the mask into w=1,
    k=0: compare y at valid steps only)."""
    if S.device.type == "cpu":
        return wkv56_chunk_plain(S, r, k, v, w, u, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    static = w.dim() == 2
    seqs = [t.float().contiguous() for t in (r, k, v)]
    w = head_vector(w, S, "w") if static else w.float().contiguous()
    mask = mask.contiguous()
    _check(S, seqs if static else [*seqs, w], mask)
    B, H, N, _ = S.shape
    T = seqs[0].shape[1]
    u = head_vector(u, S, "u")
    S_out = torch.empty_like(S)
    y = torch.empty((B, T, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv56")
    status = lib.wkv56_chunk_launch(
        S.data_ptr(), *(t.data_ptr() for t in (*seqs, w, u)),
        mask.data_ptr(), S_out.data_ptr(), y.data_ptr(), B, T, H, N,
        int(static), torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv56_chunk")
    wkv56_chunk.launches += 1
    return S_out, y


wkv56_chunk.launches = 0
