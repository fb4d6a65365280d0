"""The WKV recurrence over a prefill chunk, RWKV-7 and RWKV-5/6: CUDA kernels
and their plain PyTorch versions.

Port of ``ai00_server_tpu/ops/wkv_pallas.py``: ``wkv7_chunk`` (the Pallas
``_wkv7_kernel`` and its wrapper, lines 76-116 and 173-205) and
``wkv56_chunk`` (``_wkv56_kernel``, lines 119-157 and 208-239), renamed
because nothing here is Pallas.  The kernels are
``csrc/wkv7.cu:wkv7_chunk_launch`` and ``csrc/wkv56.cu:wkv56_chunk_launch``.
They compute the same functions in the chunked forms of the JAX package's
``ops/wkv_chunked.py`` over sub-chunks of ``SUB`` steps (v7: the WY form;
v5/v6: the suffix-sum form) in two launches: a factor pass over every
sub-chunk into a scratch buffer allocated here, then the state pass, each
head's state split over ``plan(B, H, sms)`` blocks.  A v5/v6 chunk of one
sub-chunk takes the step-by-step kernel (``sequential``).  The kernels read
the inputs straight from the ``(B, T, H, N)`` layout, so the wrappers need
no transpose, no mask folding and no padding of T or N.  They take every
head size N with ``N % 8 == 0``, ``8 <= N <= 128`` (one library per N,
``_build``), laying a head out in shared memory at ``_build.head_tile(N)``
(the next power of two, at least 32) with the rest zeros.
``wkv7_chunk_wy`` and ``wkv56_chunk_ss`` repeat the kernels' arithmetic in
PyTorch, sub-chunk by sub-chunk, for the tests: on the CPU against the JAX
package, on the card against the kernels.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.common import masked_select
from . import _build
from .device import sm_count

SUB = 16  # steps per sub-chunk (csrc/wkv_chunk_common.cuh: R)


def head_vector(t, S, name):
    """``t`` as the contiguous f32 (H, N) array the RWKV-5/6 chunk kernels
    read for every row (``u``, or RWKV-5's static decay)."""
    H, N = S.shape[1:3]
    t = t.float().contiguous()
    if tuple(t.shape) != (H, N) or t.device != S.device:
        raise ValueError(f"{name} must be {(H, N)} on {S.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def splits(N: int = 64) -> tuple[int, ...]:
    """The blocks a head the state passes take at head size ``N``: each
    holds ``head_tile(N) / slices`` rows (v7) or columns (v5/v6), at least
    16 (one or two at N <= 32)."""
    return tuple(s for s in (1, 2, 4) if _build.head_tile(N) // s >= 16)


def plan(B: int, H: int, sms: int, N: int = 64) -> int:
    """Blocks per (b, h) of a chunk kernel's state pass, each holding
    ``head_tile(N) / slices`` rows (v7) or columns (v5/v6) of the head's
    state: the fewest of ``splits(N)`` that give the card's ``sms`` SMs a
    block for every two, else the most (``tools/torch_wkv_chunk_ab.py
    --slices`` on an H100 at N = 64: at 128 heads one block a head beats
    two, at 16 and 32 heads four beat two).  At N = 128 two at least: a
    block of the whole 128 x 128 state needs 172 KB of shared memory."""
    ok = [s for s in splits(N) if N <= 64 or s >= 2]
    for slices in ok[:-1]:
        if 2 * B * H * slices >= sms:
            return slices
    return ok[-1]


def sequential(T: int) -> bool:
    """Whether ``wkv56_chunk`` takes its step-by-step kernel: a chunk of one
    sub-chunk, where the chunked form's second pass and scratch cost more
    than they save (on an H100 at B = 8 and the 1B6 width: 0.0160 against
    0.0104 ms)."""
    return T <= SUB


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


def _subchunks(x, m, masked, fill):
    """(B, T, H, N) -> (nsub, B, H, SUB, N) f32, ``masked`` at steps where
    ``m`` is False (None: kept) and ``fill`` past T."""
    B, T, H, N = x.shape
    x = x.float()
    if masked is not None:
        x = torch.where(m, x, masked)
    nsub = -(-T // SUB)
    if nsub * SUB != T:
        x = torch.cat([x, x.new_full((B, nsub * SUB - T, H, N), fill)], 1)
    return x.reshape(B, nsub, SUB, H, N).permute(1, 0, 3, 2, 4)


def _from_subchunks(ys, T):
    """[(B, H, SUB, N)] * nsub -> (B, T, H, N)."""
    y = torch.stack(ys).permute(1, 0, 3, 2, 4)
    return y.reshape(y.shape[0], -1, *y.shape[3:])[:, :T]


def wkv7_chunk_wy(S, r, w, k, v, kk, a, mask):
    """The arithmetic of ``csrc/wkv7.cu``'s chunk kernel in PyTorch, in its
    order: the WY form over sub-chunks of ``SUB`` steps, a masked step the
    identity (w = 1, k = kk = 0).  Same contract and precondition as
    :func:`wkv7_chunk`; used by the tests, never on a serving path."""
    S = S.float()
    T = r.shape[1]
    m = mask[:, :, None, None]
    rs, vs, as_ = (_subchunks(x, m, None, 0.0) for x in (r, v, a))
    ws = _subchunks(w, m, 1.0, 1.0)
    ks, kks = (_subchunks(x, m, 0.0, 0.0) for x in (k, kk))
    ones = torch.ones(SUB, SUB, dtype=torch.bool, device=S.device)
    strict, incl = ones.tril(-1), ones.tril()
    eye = torch.eye(SUB, device=S.device)
    ys = []
    for rb, wb, kb, vb, kkb, ab in zip(rs, ws, ks, vs, kks, as_):
        A = torch.cumprod(wb, dim=-2)          # A_t, (B, H, SUB, N)
        Ap = torch.cat([torch.ones_like(A[..., :1, :]), A[..., :-1, :]], -2)
        ia = 1.0 / A
        kbar, bbar, kdec, rbar = Ap * kkb, kkb * ab * ia, kb * ia, rb * A
        AR = A[..., -1:, :]
        Cb = (kbar @ bbar.mT) * strict
        Ck = (kbar @ kdec.mT) * strict
        Mb = (rbar @ bbar.mT) * incl
        Mk = (rbar @ kdec.mT) * incl
        X = torch.linalg.solve_triangular(
            eye + Cb, torch.cat([kbar, Ck], -1), upper=False,
            unitriangular=True)
        P, Q = X[..., :kbar.shape[-1]], X[..., kbar.shape[-1]:]
        Rq, G = rbar - Mb @ P, Mk - Mb @ Q
        d = P @ S.mT + Q @ vb                  # the WY vectors, negated
        ys.append(Rq @ S.mT + G @ vb)
        S = S * AR - d.mT @ (bbar * AR) + vb.mT @ (kdec * AR)
    return S, _from_subchunks(ys, T)


def wkv56_chunk_ss(S, r, k, v, w, u, mask):
    """The arithmetic of ``csrc/wkv56.cu``'s chunk kernel in PyTorch, in its
    order: the suffix-sum form over sub-chunks of ``SUB`` steps, a masked
    step's log-decay and k 0 for the state, its bonus from the real k.
    Same contract as :func:`wkv56_chunk`; used by the tests, never on a
    serving path."""
    S = S.float()
    B, T, H, N = r.shape
    if w.dim() == 2:  # static (H, N)
        w = w[None, None].expand(B, T, H, N)
    m = mask[:, :, None, None]
    gs = _subchunks(torch.log(torch.clamp(w.float(), min=1e-30)), m, 0.0, 0.0)
    rs, ks, vs = (_subchunks(x, m, None, 0.0) for x in (r, k, v))
    kfs = _subchunks(k, m, 0.0, 0.0)
    u = u.float()[None, :, None, :]
    strict = torch.ones(SUB, SUB, dtype=torch.bool,
                        device=S.device).tril(-1)[..., None]
    ys = []
    for gb, rb, kb, vb, kfb in zip(gs, rs, ks, vs, kfs):
        cI = torch.cumsum(gb, dim=-2)          # c_t
        cP = torch.cat([torch.zeros_like(cI[..., :1, :]), cI[..., :-1, :]], -2)
        cR = cI[..., -1:, :]
        E = torch.exp((cP[..., :, None, :] - cI[..., None, :, :])
                      .masked_fill(~strict, float("-inf")))
        Am = torch.einsum("bhtn,bhtsn,bhsn->bhts", rb, E, kfb)
        bonus = (rb * u * kb).sum(-1, keepdim=True)
        ys.append((rb * torch.exp(cP)) @ S + bonus * vb + Am @ vb)
        S = torch.exp(cR).mT * S + (kfb * torch.exp(cR - cI)).mT @ vb
    return S, _from_subchunks(ys, T)


def _check(S, seqs, mask):
    B, H, N, N2 = S.shape
    if N != N2 or S.dtype != torch.float32 or not S.is_contiguous():
        raise ValueError(f"state must be contiguous f32 (B, H, N, N), got "
                         f"{S.dtype} {tuple(S.shape)}")
    _build.check_head_size(N)
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


def _scratch(floats: int, B: int, T: int, H: int, device):
    """The kernels' pass-1 output: ``floats`` per (b, h, sub-chunk)."""
    return torch.empty((B * H * -(-T // SUB), floats), device=device,
                       dtype=torch.float32)


def wkv7_chunk(S, r, w, k, v, kk, a, mask):
    """v7 WKV over a chunk.  S: (B, H, N, N) f32 (v-dim, k-dim);
    r..a: (B, T, H, N) (cast to f32); mask: (B, T) bool.
    Returns (new_S, y (B, T, H, N) f32).  A masked step leaves S unchanged
    and its y reads the kept state.

    Precondition of the kernel (the WY form divides by the cumulative decay
    of up to ``SUB`` steps): every decay is at v7's floor or above, w >=
    exp(-exp(-0.5)) = 0.5452, as ``models/v7.py`` makes it (``W_SCALE``),
    so 1 / A <= 1.6e4."""
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
    lib = _build.library("wkv7", N)
    scratch = _scratch(lib.wkv7_chunk_scratch_floats(), B, T, H, S.device)
    status = lib.wkv7_chunk_launch(
        S.data_ptr(), *(t.data_ptr() for t in seqs), mask.data_ptr(),
        scratch.data_ptr(), S_out.data_ptr(), y.data_ptr(), B, T, H, N,
        plan(B, H, sm_count(S.device.index), N),
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
    lib = _build.library("wkv56", N)
    ptrs = [t.data_ptr() for t in (S, *seqs, w, u, mask)]
    stream = torch.cuda.current_stream(S.device).cuda_stream
    if sequential(T):
        status = lib.wkv56_chunk_seq_launch(
            *ptrs, S_out.data_ptr(), y.data_ptr(), B, T, H, N, int(static),
            stream)
    else:
        scratch = _scratch(lib.wkv56_chunk_scratch_floats(), B, T, H,
                           S.device)
        status = lib.wkv56_chunk_launch(
            *ptrs, scratch.data_ptr(), S_out.data_ptr(), y.data_ptr(), B, T,
            H, N, int(static), plan(B, H, sm_count(S.device.index), N),
            stream)
    _build.check(status, "wkv56_chunk")
    wkv56_chunk.launches += 1
    return S_out, y


wkv56_chunk.launches = 0
