"""One WKV decode step, RWKV-7 and RWKV-5/6: CUDA kernels and their plain
PyTorch versions.

Port of ``ai00_server_tpu/ops/wkv_t1.py``: ``wkv7_t1`` (the Pallas
``_v7_kernel``, lines 29-48 and 107-119) and ``wkv56_t1`` (``_v56_kernel``,
lines 51-67 and 122-134).  The kernels are ``csrc/wkv7.cu:wkv7_t1_launch``
and ``csrc/wkv56.cu:wkv56_t1_launch``; the notes there say what bounds
them on the card and how their designs answer that.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.  ``wkv7_t1_mirror`` repeats ``wkv7_t1``'s kernel
arithmetic in PyTorch for the tests.
"""

from __future__ import annotations

import torch

from ..models.common import masked_select
from . import _build
from .device import sm_count
from .v7_decode import pair_sum

SPLITS = (1, 2, 4)  # blocks a head: 64, 32 or 16 state rows each


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


def wkv7_t1_mirror(S, r, w, k, v, kk, a, mask, slices: int = 1):
    """The arithmetic of ``csrc/wkv7.cu:wkv7_t1_kernel`` in PyTorch, f32:
    each of a row's sums (``S kk``, ``S' r``) as the kernel takes it, a
    thread's four columns 4 cq .. 4 cq + 3 in order, then the 16 threads'
    partial sums by :func:`pair_sum` (lanes xor 1, 2, 4, 8).  ``slices``
    blocks a head each take 64 / slices rows; rows are independent, so the
    split moves no bit.  The kernel fuses multiply-adds, so the two differ
    by f32 roundings.  Same contract as :func:`wkv7_t1`; for the tests,
    never on a serving path."""
    if slices not in SPLITS:
        raise ValueError(f"slices must be one of {SPLITS}, got {slices}")
    S = S.float()
    r, w, k, v, kk, a = (t.float() for t in (r, w, k, v, kk, a))
    B, H, N, _ = S.shape

    def row_sums(M, x):  # (B, H, rows, N) . (B, H, N) over the tiles
        t = (M * x[:, :, None, :]).reshape(*M.shape[:3], N // 4, 4)
        return pair_sum(((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3])

    rows = N // slices
    S_new, y = torch.empty_like(S), torch.empty_like(r)
    for sl in range(slices):  # the blocks of a head, in any order
        Ss = S[:, :, sl * rows:(sl + 1) * rows]
        skk = row_sums(Ss, kk)
        upd = (Ss * w[:, :, None, :]
               - skk[..., None] * (kk * a)[:, :, None, :]
               + v[:, :, sl * rows:(sl + 1) * rows, None] * k[:, :, None, :])
        upd = masked_select(mask, upd, Ss)
        S_new[:, :, sl * rows:(sl + 1) * rows] = upd
        y[:, :, sl * rows:(sl + 1) * rows] = row_sums(upd, r)
    return S_new, y


def plan(B: int, H: int, sms: int) -> int:
    """Blocks per (b, h) of ``wkv7_t1``'s kernel, from B x H heads on the
    card's ``sms`` SMs: 4 up to a head for every two SMs, else 2
    (``tools/torch_wkv_gn_ab.py --splits`` on an H100 at H = 16, every row
    active: 4 fastest at B = 1, 2 at B = 8, 2 and 4 within 0.3% and 3%
    under one block a head at B = 64)."""
    return 4 if 2 * B * H <= sms else 2


VEC_DTYPES = (torch.float32, torch.bfloat16)


def _check(S, vecs, mask):
    B, H, N, N2 = S.shape
    if N != N2 or S.dtype != torch.float32 or not S.is_contiguous():
        raise ValueError(f"state must be contiguous f32 (B, H, N, N), got "
                         f"{S.dtype} {tuple(S.shape)}")
    if N != 64:
        raise ValueError(f"the CUDA kernel takes head size 64, got {N}")
    for t in vecs:
        if t.shape != (B, H, N) or t.dtype not in VEC_DTYPES \
                or not t.is_contiguous():
            raise ValueError(f"vectors must be contiguous f32 or bf16 "
                             f"{(B, H, N)}, got {t.dtype} {tuple(t.shape)}")
    if mask.shape != (B,) or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous bool {(B,)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (S, *vecs, mask):
        if t.device != S.device:
            raise ValueError("all operands must be on one device")
    for t in (S, *vecs):  # 16-byte loads of f32, 8-byte of bf16
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError("operands must be 16-byte aligned (bf16 "
                             "vectors: 8-byte)")


def wkv7_t1(S, r, w, k, v, kk, a, mask):
    """One v7 delta-rule step.  S: (B, H, N, N) f32 (v-dim, k-dim);
    r/w/k/v/kk/a: (B, H, N), each f32 or bf16 (read as f32: bf16 widens
    exactly); mask: (B,) bool.  Returns (S_new, y (B, H, N) f32).  Inactive
    rows keep S bit for bit and y reads it.

    On the card one launch (``plan(B, H, sms)`` blocks a head) that takes
    the vectors as they are: contiguous, f32 or bf16, 16-byte aligned
    (bf16: 8-byte); anything else raises.  It is a programmatic dependent
    that reads ``S`` before it waits for the kernel launched before it on
    the stream, so whatever writes ``S`` must have finished when it starts:
    a synchronisation, or a launch without PDL (any PyTorch op) between
    them.  On the layer path (``models/v7.py``) the launch before it is a
    PyTorch op and ``S`` is this layer's state from an earlier step.
    """
    if S.device.type == "cpu":
        return wkv7_t1_plain(S, r, w, k, v, kk, a, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    vecs = (r, w, k, v, kk, a)
    _check(S, vecs, mask)
    B, H, N, _ = S.shape
    S_out = torch.empty_like(S)
    y = torch.empty((B, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv7")
    status = lib.wkv7_t1_launch(
        S.data_ptr(), *(t.data_ptr() for t in vecs), mask.data_ptr(),
        S_out.data_ptr(), y.data_ptr(), B, H, N,
        sum(1 << i for i, t in enumerate(vecs) if t.dtype == torch.bfloat16),
        plan(B, H, sm_count(S.device.index or 0)),
        torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv7_t1")
    wkv7_t1.launches += 1
    return S_out, y


wkv7_t1.launches = 0


def wkv56_t1_plain(S, r, k, v, w, u, mask):
    """The plain PyTorch version (the JAX package's ``models/v5.wkv_scan``
    at T = 1): same contract as :func:`wkv56_t1`."""
    S = S.float()
    r, k, v, w = (t.float() for t in (r, k, v, w))  # w (B, H, N) or (H, N)
    a = k[..., :, None] * v[..., None, :]             # (B, H, N_k, N_v)
    y = torch.einsum("bhk,bhkv->bhv", r, S + u.float()[None, :, :, None] * a)
    S_new = masked_select(mask, w[..., None] * S + a, S)
    return S_new, y


def head_vector(t, S, name):
    """``t`` as the contiguous f32 (H, N) array the RWKV-5/6 kernels read
    for every row (``u``, or RWKV-5's static decay)."""
    H, N = S.shape[1:3]
    t = t.float().contiguous()
    if tuple(t.shape) != (H, N) or t.device != S.device:
        raise ValueError(f"{name} must be {(H, N)} on {S.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def wkv56_t1(S, r, k, v, w, u, mask):
    """One v5/v6 step.  S: (B, H, N, N) f32 (k-dim, v-dim); r/k/v: (B, H,
    N) (cast to f32); w: (B, H, N), or (H, N) for RWKV-5's static decay
    (the kernel reads it for every row); u: (H, N); mask: (B,) bool.
    Returns (S_new, y (B, H, N) f32): ``y`` reads the OLD state plus the
    ``u`` bonus for every row, ``S_new = w S + k v^T`` where ``mask``; an
    inactive row keeps S bit for bit."""
    if S.device.type == "cpu":
        return wkv56_t1_plain(S, r, k, v, w, u, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    static = w.dim() == 2
    vecs = [t.float().contiguous() for t in (r, k, v)]
    w = head_vector(w, S, "w") if static else w.float().contiguous()
    mask = mask.contiguous()
    _check(S, vecs if static else [*vecs, w], mask)
    B, H, N, _ = S.shape
    u = head_vector(u, S, "u")
    S_out = torch.empty_like(S)
    y = torch.empty((B, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv56")
    status = lib.wkv56_t1_launch(
        S.data_ptr(), *(t.data_ptr() for t in (*vecs, w, u)),
        mask.data_ptr(), S_out.data_ptr(), y.data_ptr(), B, H, N,
        int(static), torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv56_t1")
    wkv56_t1.launches += 1
    return S_out, y


wkv56_t1.launches = 0
