"""One WKV decode step, RWKV-7 and RWKV-5/6: CUDA kernels and their plain
PyTorch versions.

Port of ``ai00_server_tpu/ops/wkv_t1.py``: ``wkv7_t1`` (the Pallas
``_v7_kernel``, lines 29-48 and 107-119) and ``wkv56_t1`` (``_v56_kernel``,
lines 51-67 and 122-134).  The kernels are ``csrc/wkv7.cu:wkv7_t1_launch``
and ``csrc/wkv56.cu:wkv56_t1_launch``; the notes there say what bounds
them on the card and how their designs answer that.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.  The kernels take every head size N with ``N % 8 ==
0``, ``8 <= N <= 128`` (``_build.check_head_size``; one library per N),
laying a head out at ``_build.head_tile(N)`` with the rest masked.
``wkv7_t1_mirror`` and ``wkv56_t1_mirror`` repeat their kernels'
arithmetic in PyTorch for the tests.
"""

from __future__ import annotations

import torch

from ..models.common import masked_select
from . import _build
from .device import sm_count
from .v7_decode import pad_to, pair_sum

SPLITS = (1, 2, 4)  # blocks a head: N / 1, 2 or 4 state rows (v7) or value
                    # columns (v5/v6) each, N the head's tile


def splits(N: int = 64) -> tuple[int, ...]:
    """The blocks a head the one-step kernels take at head size ``N``: a
    block holds at least a warp (a head's tile is ``head_tile(N)^2 / 16``
    threads: 64 at N <= 32, so one or two)."""
    threads = _build.head_tile(N) ** 2 // 16
    return tuple(s for s in SPLITS if threads // s >= 32)


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
    thread's four columns 4 cq .. 4 cq + 3 in order, then the row group's
    ``head_tile(N) / 4`` threads' partial sums by :func:`pair_sum` (lanes
    xor 1, 2, 4 ...; the threads past the head add zero).  ``slices``
    blocks a head each take a part of its rows; rows are independent, so
    the split moves no bit.  The kernel fuses multiply-adds, so the two
    differ by f32 roundings.  Same contract as :func:`wkv7_t1`; for the
    tests, never on a serving path."""
    S = S.float()
    r, w, k, v, kk, a = (t.float() for t in (r, w, k, v, kk, a))
    B, H, N, _ = S.shape
    if slices not in splits(N):
        raise ValueError(f"slices must be one of {splits(N)}, got {slices}")
    lanes = _build.head_tile(N) // 4

    def row_sums(M, x):  # (B, H, rows, N) . (B, H, N) over the tiles
        t = (M * x[:, :, None, :]).reshape(*M.shape[:3], N // 4, 4)
        return pair_sum(pad_to(((t[..., 0] + t[..., 1]) + t[..., 2])
                               + t[..., 3], lanes))

    rows = -(-N // slices)
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


def plan(B: int, H: int, sms: int, N: int = 64) -> int:
    """Blocks per (b, h) of ``wkv7_t1``'s kernel, from B x H heads on the
    card's ``sms`` SMs: at N = 64, 4 up to a head for every two SMs, else 2
    (``tools/torch_wkv_gn_ab.py --splits`` on an H100 at H = 16, every row
    active: 4 fastest at B = 1, 2 at B = 8, 2 and 4 within 0.3% and 3%
    under one block a head at B = 64).  At another head size the same
    blocks of 64 or 128 threads where the head's tile allows (N = 128: 4,
    blocks of 256; N <= 32: the head's 64 threads, 1)."""
    threads = _build.head_tile(N) ** 2 // 16
    want = threads // (64 if 2 * B * H <= sms else 128)
    return max(s for s in splits(N) if s <= max(want, 1))


VEC_DTYPES = (torch.float32, torch.bfloat16)


def _check(S, vecs, mask, heads=()):
    """Raise unless the kernels take these operands as they are: ``vecs``
    (B, H, N) and ``heads`` (H, N), each contiguous f32 or bf16."""
    B, H, N, N2 = S.shape
    if N != N2 or S.dtype != torch.float32 or not S.is_contiguous():
        raise ValueError(f"state must be contiguous f32 (B, H, N, N), got "
                         f"{S.dtype} {tuple(S.shape)}")
    _build.check_head_size(N)
    shapes = [(B, H, N)] * len(vecs) + [(H, N)] * len(heads)
    for t, shape in zip((*vecs, *heads), shapes):
        if t.shape != shape or t.dtype not in VEC_DTYPES \
                or not t.is_contiguous():
            raise ValueError(f"vectors must be contiguous f32 or bf16 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if mask.shape != (B,) or mask.dtype != torch.bool \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be contiguous bool {(B,)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (S, *vecs, *heads, mask):
        if t.device != S.device:
            raise ValueError("all operands must be on one device")
    for t in (S, *vecs, *heads):  # 16-byte loads of f32, 8-byte of bf16
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
    lib = _build.library("wkv7", N)
    status = lib.wkv7_t1_launch(
        S.data_ptr(), *(t.data_ptr() for t in vecs), mask.data_ptr(),
        S_out.data_ptr(), y.data_ptr(), B, H, N,
        sum(1 << i for i, t in enumerate(vecs) if t.dtype == torch.bfloat16),
        plan(B, H, sm_count(S.device.index or 0), N),
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


def wkv56_t1_mirror(S, r, k, v, w, u, mask, slices: int = 1):
    """The arithmetic of ``csrc/wkv56.cu:wkv56_t1_kernel`` in PyTorch, f32:
    a thread's part of each column's readout over its four k rows 4 rg ..
    4 rg + 3 in order, then the ``head_tile(N) / 4`` row groups' parts by
    :func:`pair_sum` (lanes xor, then warps in pairs: one tree in every
    split; the groups past the head add zero).  ``slices`` blocks a head
    each take a part of its value columns; columns are independent, so the
    split moves no bit.  The kernel fuses multiply-adds, so the two differ
    by f32 roundings.  Same contract as :func:`wkv56_t1`; for the tests,
    never on a serving path."""
    S = S.float()
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    B, H, N, _ = S.shape
    if slices not in splits(N):
        raise ValueError(f"slices must be one of {splits(N)}, got {slices}")
    groups = _build.head_tile(N) // 4
    w = w.expand(B, H, N)  # RWKV-5's static (H, N) decay, every row
    cols = -(-N // slices)
    S_new, y = torch.empty_like(S), torch.empty_like(r)
    for sl in range(slices):  # the blocks of a head, in any order
        c = slice(sl * cols, (sl + 1) * cols)
        Ss = S[..., c]                                 # (B, H, N_k, cols)
        a = k[..., :, None] * v[:, :, None, c]
        t = ((Ss + u[None, :, :, None] * a) * r[..., None]).reshape(
            B, H, N // 4, 4, cols)
        part = ((t[:, :, :, 0] + t[:, :, :, 1]) + t[:, :, :, 2]) \
            + t[:, :, :, 3]                            # (B, H, N / 4, cols)
        y[..., c] = pair_sum(pad_to(part.transpose(-1, -2), groups))
        S_new[..., c] = masked_select(mask, w[..., None] * Ss + a, Ss)
    return S_new, y


def plan56(B: int, H: int, sms: int, N: int = 64) -> int:
    """Blocks per (b, h) of ``wkv56_t1``'s kernel, from B x H heads on the
    card's ``sms`` SMs: 4 up to a head for every two SMs, else 1
    (``tools/torch_wkv_gn_ab.py --splits`` on an H100 at N = 64, every row
    active: 4 fastest at 32 and 64 heads, 1 at 128, 256 and 2048 heads, 2
    within 1% of 1 at 256); at N <= 32 at most 2 (a block of a warp)."""
    return min(4 if 2 * B * H <= sms else 1, max(splits(N)))


def wkv56_t1(S, r, k, v, w, u, mask):
    """One v5/v6 step.  S: (B, H, N, N) f32 (k-dim, v-dim); r/k/v: (B, H,
    N); w: (B, H, N), or (H, N) for RWKV-5's static decay (the kernel reads
    it for every row); u: (H, N); each vector f32 or bf16 (read as f32:
    bf16 widens exactly); mask: (B,) bool.  Returns (S_new, y (B, H, N)
    f32): ``y`` reads the OLD state plus the ``u`` bonus for every row,
    ``S_new = w S + k v^T`` where ``mask``; an inactive row keeps S bit for
    bit.

    On the card one launch (``plan56(B, H, sms)`` blocks a head) that takes
    the vectors as they are: contiguous, f32 or bf16, 16-byte aligned
    (bf16: 8-byte); anything else raises.  It is a programmatic dependent
    that reads ``S`` before it waits for the kernel launched before it on
    the stream, so whatever writes ``S`` must have finished when it starts:
    a synchronisation, or a launch without PDL (any PyTorch op) between
    them.  On the layer path (``models/v6.py``, ``models/v5.py``, at tp
    ``models/common.forward_tp``) the launch before it is a PyTorch op and
    ``S`` is this layer's state from an earlier step.
    """
    if S.device.type == "cpu":
        return wkv56_t1_plain(S, r, k, v, w, u, mask)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    static = w.dim() == 2
    vecs = (r, k, v, w, u)
    _check(S, vecs[:3] if static else vecs[:4], mask,
           (w, u) if static else (u,))
    B, H, N, _ = S.shape
    S_out = torch.empty_like(S)
    y = torch.empty((B, H, N), device=S.device, dtype=torch.float32)
    lib = _build.library("wkv56", N)
    status = lib.wkv56_t1_launch(
        S.data_ptr(), *(t.data_ptr() for t in vecs), mask.data_ptr(),
        S_out.data_ptr(), y.data_ptr(), B, H, N, int(static),
        sum(1 << i for i, t in enumerate(vecs) if t.dtype == torch.bfloat16),
        plan56(B, H, sm_count(S.device.index or 0), N),
        torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(status, "wkv56_t1")
    wkv56_t1.launches += 1
    return S_out, y


wkv56_t1.launches = 0
