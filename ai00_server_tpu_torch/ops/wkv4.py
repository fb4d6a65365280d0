"""The RWKV-4 WKV recurrence over a chunk: a CUDA kernel and its plain
PyTorch version.

The JAX package computes it as a ``lax.scan`` (``models/v4.py:_wkv_scan``,
lines 49-84), not as Pallas; a torch loop over the T steps of a chunk in
every layer would be T launches a layer, so the port has a kernel of its
own, ``csrc/wkv4.cu:wkv4_chunk_launch``, in a chunked form: each channel's
chunk cut into runs of ``R`` steps that a block steps from the zero state
in parallel, scans, and steps again from their true start states (the note
in the source says what bounds it and what its design does about it;
:func:`plan` picks the runs of a block).  A chunk of at most
``SEQ_STEPS`` takes ``wkv4_chunk_seq_launch``, one thread a channel
(:func:`sequential`).  It serves prefill chunks and the layer path at
T = 1.  The wrapper launches a kernel for CUDA tensors and runs the plain
version only for CPU tensors.  :func:`wkv4_chunk_mirror` repeats the
chunked kernel's arithmetic in PyTorch for the tests.
"""

from __future__ import annotations

import torch

from . import _build

# The types of k and v the kernel reads (widened to f32 in registers).
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1}

PP_INIT = -1e30  # models/v4.py: the zero state's pp
SEQ_STEPS = 16  # the longest chunk the step-by-step kernel takes
RUN_STEPS = 8  # R: the steps of a run of the chunked kernel
MAX_RUNS = 32  # runs of a channel in a window: one warp's lanes
THREADS = 256  # a chunked block: G channels x NS runs


def sequential(T: int) -> bool:
    """Whether ``wkv4_chunk`` takes the step-by-step kernel: T = 1 (the
    layer path) and chunks up to ``SEQ_STEPS``, where the chunked kernel's
    second pass costs more than it saves (on an H100 at T = 1, B = 8:
    0.00396 against 0.00313 ms)."""
    return T <= SEQ_STEPS


def runs(R: int, T: int) -> int:
    """NS: the least power of two of runs of R steps that covers T, at
    least 2 and at most ``MAX_RUNS`` (longer chunks take several
    windows)."""
    ns = 2
    while ns * R < T and ns < MAX_RUNS:
        ns *= 2
    return ns


def plan(T: int) -> tuple[int, int]:
    """``(G, NS)`` of a chunked ``wkv4_chunk`` launch (T above
    ``SEQ_STEPS``): blocks of ``THREADS``, G channels x NS runs of
    ``RUN_STEPS`` (a window of NS x 8 steps), ``ceil(C / G) x B`` blocks.
    NS from :func:`runs`, so a chunk of more than 256 steps takes several
    windows of 256; the kernel derives G = 256 / NS itself (8 channels at
    T = 256: 128 blocks at B = 1, C = 1024).  On an H100 at the 0.4B width
    (``tools/torch_wkv_chunk_ab.py --plans``, ms at B = 8 / 1): T = 256
    NS = 32 0.01774 / 0.00606 (16: 0.01700 / 0.00955, 8: 0.02004 /
    0.01678); T = 23 NS = 4 0.00492 / 0.00464 (8: 0.00606 / 0.00519)."""
    NS = runs(RUN_STEPS, T)
    return THREADS // NS, NS


def wkv4_chunk_plain(aa, bb, pp, k, v, w, u, mask):
    """The plain PyTorch version (the JAX package's ``models/v4._wkv_scan``):
    same contract as :func:`wkv4_chunk`."""
    k, v = k.float(), v.float()
    ys = []
    for t in range(k.shape[1]):
        k_t, v_t, m_t = k[:, t], v[:, t], mask[:, t, None]
        ys.append(_out(aa, bb, pp, k_t, v_t, u))
        aa_n, bb_n, pp_n = _update(aa, bb, pp, k_t, v_t, w)
        aa = torch.where(m_t, aa_n, aa)
        bb = torch.where(m_t, bb_n, bb)
        pp = torch.where(m_t, pp_n, pp)
    return (aa, bb, pp), torch.stack(ys, dim=1)


def _out(aa, bb, pp, k, v, u):
    """y from the state before a step."""
    ww = u + k
    q = torch.maximum(pp, ww)
    e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
    return (e1 * aa + e2 * v) / (e1 * bb + e2)


def _update(aa, bb, pp, k, v, w):
    """The state after a step."""
    ww = pp + w
    q = torch.maximum(ww, k)
    e1, e2 = torch.exp(ww - q), torch.exp(k - q)
    return e1 * aa + e2 * v, e1 * bb + e2, q


def _after(s, g, w):
    """State (or run) ``s = (aa, bb, pp, n)`` followed by the run ``g``:
    ``csrc/wkv4.cu:after``.  A run of no valid step leaves ``s`` as it is."""
    p = s[2] + g[3].float() * w
    q = torch.maximum(p, g[2])
    e1, e2 = torch.exp(p - q), torch.exp(g[2] - q)
    keep = g[3] == 0
    return (torch.where(keep, s[0], e1 * s[0] + e2 * g[0]),
            torch.where(keep, s[1], e1 * s[1] + e2 * g[1]),
            torch.where(keep, s[2], q), s[3] + g[3])


def wkv4_chunk_mirror(aa, bb, pp, k, v, w, u, mask, R):
    """The arithmetic of ``csrc/wkv4.cu``'s chunk kernel in PyTorch, in its
    order, with runs of ``R`` steps: windows of NS x R steps (NS from
    :func:`runs`), each run stepped from the zero state, the runs scanned
    as the kernel's shuffles do (NS a power of two, runs past T empty),
    every run stepped again from its start state for y; the state after a
    window is its last run's end.  With ``R >= T`` one run: the
    step-by-step kernel's chain (the plain version's arithmetic).  Same
    contract as :func:`wkv4_chunk`; used by the tests, never on a serving
    path."""
    k, v = k.float(), v.float()
    B, T, C = k.shape
    ns = 1 if R >= T else runs(R, T)
    zero = aa.new_zeros(B, C)
    none = torch.zeros(B, C, dtype=torch.int64, device=aa.device)
    ys = []
    for t0 in range(0, T, ns * R):
        spans = [range(t0 + s * R, min(t0 + (s + 1) * R, T))
                 for s in range(ns)]
        if ns == 1:
            starts = [(aa, bb, pp)]
        else:
            x = []
            for span in spans:
                a, b, p, n = zero, zero, torch.full_like(zero, PP_INIT), none
                for t in span:
                    m = mask[:, t, None]
                    a2, b2, p2 = _update(a, b, p, k[:, t], v[:, t], w)
                    a, b = torch.where(m, a2, a), torch.where(m, b2, b)
                    p, n = torch.where(m, p2, p), n + m
                x.append((a, b, p, n))
            d = 1
            while d < ns:
                x = [x[s] if s < d else _after(x[s - d], x[s], w)
                     for s in range(ns)]
                d *= 2
            init = (aa, bb, pp, none)
            starts = [(aa, bb, pp)] + [_after(init, x[s - 1], w)[:3]
                                       for s in range(1, ns)]
        for span, (a, b, p) in zip(spans, starts):
            for t in span:
                ys.append(_out(a, b, p, k[:, t], v[:, t], u))
                m = mask[:, t, None]
                a2, b2, p2 = _update(a, b, p, k[:, t], v[:, t], w)
                a, b = torch.where(m, a2, a), torch.where(m, b2, b)
                p = torch.where(m, p2, p)
        aa, bb, pp = a, b, p
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
    lib = _build.library("wkv4")
    ptrs = [t.data_ptr() for t in (aa, bb, pp, k, v, w, u, mask, *out, y)]
    stream = torch.cuda.current_stream(aa.device).cuda_stream
    if sequential(T):
        status = lib.wkv4_chunk_seq_launch(*ptrs, B, T, C, _KV_CODE[k.dtype],
                                           stream)
    else:
        status = lib.wkv4_chunk_launch(*ptrs, B, T, C, plan(T)[1],
                                       _KV_CODE[k.dtype], stream)
    _build.check(status, "wkv4_chunk")
    wkv4_chunk.launches += 1
    return tuple(out), y


wkv4_chunk.launches = 0
