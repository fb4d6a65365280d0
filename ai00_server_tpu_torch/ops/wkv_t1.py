"""One RWKV-7 WKV decode step: CUDA kernel and its plain PyTorch version.

Port of ``ai00_server_tpu/ops/wkv_t1.py:wkv7_t1`` (the Pallas
``_v7_kernel``, lines 29-48 and 107-119).  The kernel is
``csrc/wkv7.cu:wkv7_t1_launch``; the note there says what bounds it on the
card and how its design answers that.

``wkv7_t1`` launches the kernel for CUDA tensors and runs
:func:`wkv7_t1_plain` only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.common import masked_select
from . import _build


def wkv7_t1_plain(S, r, w, k, v, kk, a, mask):
    """The plain PyTorch version: same contract as :func:`wkv7_t1`."""
    S = S.float()
    r, w, k, v, kk, a = (t.float() for t in (r, w, k, v, kk, a))
    skk = torch.einsum("bhvk,bhk->bhv", S, kk)
    S_new = (S * w[:, :, None, :]
             - skk[..., None] * (kk * a)[:, :, None, :]
             + v[..., None] * k[:, :, None, :])
    S_new = masked_select(mask, S_new, S)
    y = torch.einsum("bhvk,bhk->bhv", S_new, r)
    return S_new, y


def _check(S, vecs, mask):
    B, H, N, N2 = S.shape
    if N != N2 or S.dtype != torch.float32 or not S.is_contiguous():
        raise ValueError(f"state must be contiguous f32 (B, H, N, N), got "
                         f"{S.dtype} {tuple(S.shape)}")
    if N != 64:
        raise ValueError(f"the CUDA kernel takes head size 64, got {N}")
    for t in vecs:
        if t.shape != (B, H, N) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"vectors must be contiguous f32 {(B, H, N)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if mask.shape != (B,) or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous bool {(B,)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (S, *vecs, mask):
        if t.device != S.device:
            raise ValueError("all operands must be on one device")
    for t in (S, *vecs):  # float4 loads
        if t.data_ptr() % 16:
            raise ValueError("float operands must be 16-byte aligned")


def wkv7_t1(S, r, w, k, v, kk, a, mask):
    """One v7 delta-rule step.  S: (B, H, N, N) f32 (v-dim, k-dim);
    r/w/k/v/kk/a: (B, H, N) (cast to f32); mask: (B,) bool.
    Returns (S_new, y (B, H, N) f32).  Inactive rows keep S and y reads it.
    """
    if S.device.type == "cpu":
        return wkv7_t1_plain(S, r, w, k, v, kk, a, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    vecs = [t.float().contiguous() for t in (r, w, k, v, kk, a)]
    mask = mask.contiguous()
    _check(S, vecs, mask)
    B, H, N, _ = S.shape
    S_out = torch.empty_like(S)
    y = torch.empty((B, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv7")
    status = lib.wkv7_t1_launch(
        S.data_ptr(), *(t.data_ptr() for t in vecs), mask.data_ptr(),
        S_out.data_ptr(), y.data_ptr(), B, H, N,
        torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv7_t1")
    wkv7_t1.launches += 1
    return S_out, y


wkv7_t1.launches = 0
