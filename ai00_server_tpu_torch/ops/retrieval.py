"""Vector retrieval on the card: exact MIPS and IVF top-k over a device
index.

Port of ``ai00_server_tpu/ops/retrieval.py``:

* Exact search: one ``(Q, D) @ (D, N)`` product with an f32 output and a
  top-k (a library product, as XLA does it in the JAX package).
* IVF: Lloyd k-means (``kmeans``; the memory-lean streamed and balanced
  ``kmeans_blocked``) builds ``nlist`` centroids; vectors are stored
  cluster-contiguous and padded to a fixed per-cluster capacity, so probing
  is query -> top-``nprobe`` centroids -> score the probed ``(cap, D)``
  blocks -> top-k.  The scoring is the hand-written kernel
  ``csrc/ivf.cu:ivf_score_launch`` (:func:`ivf_score`), which replaces the
  Pallas kernel ``_ivf_search_pallas``; the probe and the top-k around it
  are plain PyTorch.  :func:`ivf_search` launches the kernel for every CUDA
  tensor, whatever ``cap`` and ``D`` (the TPU took Pallas only for
  tile-aligned layouts), and uses :func:`ivf_score_plain` only for CPU
  tensors.
* ``StreamedIVFBuilder`` packs int8 codes on the device from streamed
  chunks; ``topk_merge_chunk`` / ``exact_search_chunked`` are the streamed
  ground truth.

Where the JAX package draws at random (``jax.random.choice`` picks the
k-means seeds) the port takes a ``torch.Generator`` and an optional
``init_idx``, so a test can hand it the indices JAX drew.  Float indexes
are scored in f32 (the XLA path's rounding; the Pallas path's bf16 cast is
not copied); int8 codes against the query rounded to bf16, as both JAX
paths do.  Scores are inner products; normalize vectors for cosine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from ..loader import _tensor

# Element types of ``packed`` the kernel reads -> its dtype code.
_PACKED_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _mm_f32(a, b):
    """``a @ b.T`` with an f32 result; bf16 operands are multiplied exactly
    and summed in f32 (``preferred_element_type=float32``)."""
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float().T)


def _topk(x, k):
    """``lax.top_k``: the k largest along the last axis, ids int32."""
    s, i = torch.topk(x, k, dim=-1)
    return s, i.to(torch.int32)


def exact_search(index, queries, k=10):
    """index: (N, D); queries: (Q, D).  Returns (scores, ids) (Q, k)."""
    return _topk(_mm_f32(queries, index), k)


def _draw_init(N, nlist, generator, init_idx, device):
    if init_idx is not None:
        return torch.as_tensor(np.array(init_idx), device=device).long()
    return torch.randperm(N, generator=generator,
                          device=generator.device if generator is not None
                          else "cpu")[:nlist].to(device)


def kmeans_blocked(data, nlist, iters=8, blk=65536, balance=False,
                   balance_eta=0.2, generator=None, init_idx=None):
    """Memory-lean Lloyd k-means: assignment and accumulation stream over
    ``blk``-row blocks, so the (N, nlist) distance matrix never exists
    beyond one block.  N must be a multiple of blk.  Seeds: ``init_idx``
    (nlist row indices), else ``nlist`` distinct rows drawn with
    ``generator``.

    Rounds as the JAX function does: the cluster sums add bf16-rounded
    rows in f32 (its bf16 one-hot product with f32 accumulation; here
    ``index_add_``), and each block's per-cluster counts are rounded to
    bf16 (its ``one_hot(bf16).sum(0)``) before they are added.

    ``balance=True`` returns ``(centroids, bias)``: after Lloyd, ``iters``
    decaying-gain steps fit a per-cluster additive bias on the frozen
    centroids (a power diagram) that equalizes populations; downstream
    placement and probe ranking must apply the same bias."""
    N, D = data.shape
    if N % blk:
        raise ValueError(f"N={N} is not a multiple of blk={blk}")
    dev = data.device
    idx = _draw_init(N, nlist, generator, init_idx, dev)
    cent = data[idx].float()

    def sweep(cent, bias):
        c2 = (cent * cent).sum(-1) + bias
        sums = torch.zeros((nlist, D), dtype=torch.float32, device=dev)
        counts = torch.zeros(nlist, dtype=torch.float32, device=dev)
        dsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(0, N, blk):
            xf = data[i:i + blk].float()
            d2 = c2[None, :] - 2.0 * (xf @ cent.T)
            dmin, a = d2.min(-1)
            sums.index_add_(0, a, xf.bfloat16().float())
            counts += torch.bincount(a, minlength=nlist).float().bfloat16() \
                .float()
            dsum += dmin.sum() + (xf * xf).sum() - bias[a].sum()
        return sums, counts, dsum

    zero_bias = torch.zeros(nlist, dtype=torch.float32, device=dev)
    for _ in range(iters):
        sums, counts, _ = sweep(cent, zero_bias)
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1.0)[:, None], cent)
    if not balance:
        return cent
    bias = zero_bias
    for t in range(iters):
        _, counts, dsum = sweep(cent, bias)
        scale = torch.clamp(dsum / N, min=1e-12)
        eta = balance_eta * torch.rsqrt(torch.tensor(
            1.0 + t, dtype=torch.float32, device=dev))
        bias = bias + eta * scale * (counts / (N / nlist) - 1.0)
        bias = bias - bias.mean()
    return cent, bias


def kmeans(data, nlist, iters=10, generator=None, init_idx=None):
    """Lloyd k-means on the device.  data: (N, D) -> centroids (nlist, D)
    f32; the sums add f32 rows.  Seeds as :func:`kmeans_blocked`."""
    data = data.float()
    N = data.shape[0]
    cent = data[_draw_init(N, nlist, generator, init_idx, data.device)]
    x2 = (data * data).sum(-1, keepdim=True)
    for _ in range(iters):
        d2 = x2 - 2.0 * data @ cent.T + (cent * cent).sum(-1)[None, :]
        assign = d2.argmin(-1)
        sums = torch.zeros_like(cent).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=nlist).float()[:, None]
        cent = torch.where(counts > 0, sums / counts.clamp(min=1.0), cent)
    return cent


@dataclass
class IVFIndex:
    centroids: torch.Tensor        # (nlist, D) f32
    packed: torch.Tensor           # (nlist, cap, D) cluster-contiguous, padded
    packed_ids: torch.Tensor       # (nlist, cap) int32 original ids (-1 = pad)
    nlist: int
    cap: int
    pscale: torch.Tensor | None = None  # (nlist, cap) f32 per-vector scales
    #                                     when ``packed`` holds int8 codes
    cbias: torch.Tensor | None = None   # (nlist,) f32 placement bias
    #                                     (balanced k-means): probes rank by
    #                                     the same biased score

    @classmethod
    def from_numpy(cls, src, device="cuda") -> "IVFIndex":
        """An index of the JAX package (any object with these attributes,
        arrays readable with ``np.asarray``) -> this port's, on
        ``device``, dtypes kept (bf16 included)."""
        def t(x):
            return None if x is None else _tensor(np.asarray(x), device)

        return cls(centroids=t(src.centroids), packed=t(src.packed),
                   packed_ids=t(src.packed_ids), nlist=int(src.nlist),
                   cap=int(src.cap), pscale=t(getattr(src, "pscale", None)),
                   cbias=t(getattr(src, "cbias", None)))


def _assign_chunked(data: np.ndarray, cent: torch.Tensor,
                    chunk: int = 1 << 20) -> np.ndarray:
    """argmin-L2 cluster assignment, chunked through the device."""
    cent = cent.float()
    c2 = (cent * cent).sum(-1)
    out = np.empty(data.shape[0], np.int32)
    for i in range(0, data.shape[0], chunk):
        x = torch.as_tensor(np.asarray(data[i:i + chunk], np.float32),
                            device=cent.device)
        d2 = -2.0 * x @ cent.T + c2[None, :]
        out[i:i + chunk] = d2.argmin(-1).to(torch.int32).cpu().numpy()
    return out


def build_ivf(data: np.ndarray, nlist: int = 64, iters: int = 10,
              seed: int = 0, dtype=torch.bfloat16, quant: str | None = None,
              train_sample: int = 1 << 20, device="cuda",
              init_idx=None) -> IVFIndex:
    """Cluster and pack an (N, D) host matrix for probing on ``device``.

    k-means trains on a subsample (drawn with numpy from ``seed``, as the
    JAX package draws it), seeded from ``init_idx`` or a generator seeded
    with ``seed``; assignment streams in chunks; packing is numpy.
    ``quant='int8'`` stores per-vector-scaled int8 codes."""
    N, D = data.shape
    train = data
    if N > train_sample:
        rs = np.random.default_rng(seed)
        train = data[rs.choice(N, train_sample, replace=False)]
    gen = torch.Generator().manual_seed(seed)
    cent = kmeans(torch.as_tensor(np.asarray(train, np.float32),
                                  device=device), nlist, iters,
                  generator=gen, init_idx=init_idx)
    assign = _assign_chunked(data, cent)
    counts = np.bincount(assign, minlength=nlist)
    cap = int(max(1, counts.max()))
    # Vectorized packing: stable sort by cluster, then position-in-cluster.
    order = np.argsort(assign, kind="stable")
    pos = np.arange(N, dtype=np.int64) - np.repeat(
        np.cumsum(np.concatenate([[0], counts[:-1]])), counts)
    cl = assign[order]
    packed_ids = np.full((nlist, cap), -1, np.int32)
    packed_ids[cl, pos] = order.astype(np.int32)
    ids_t = torch.as_tensor(packed_ids, device=device)
    if quant == "int8":
        scale = np.maximum(
            np.abs(data).max(axis=-1, keepdims=True), 1e-12) / 127.0
        codes = np.clip(np.round(data / scale), -127, 127).astype(np.int8)
        packed = np.zeros((nlist, cap, D), np.int8)
        packed[cl, pos] = codes[order]
        pscale = np.zeros((nlist, cap), np.float32)
        pscale[cl, pos] = scale[order, 0]
        return IVFIndex(centroids=cent,
                        packed=torch.as_tensor(packed, device=device),
                        packed_ids=ids_t, nlist=nlist, cap=cap,
                        pscale=torch.as_tensor(pscale, device=device))
    packed = np.zeros((nlist, cap, D), np.float32)
    packed[cl, pos] = data[order]
    return IVFIndex(centroids=cent,
                    packed=torch.as_tensor(packed, device=device).to(dtype),
                    packed_ids=ids_t, nlist=nlist, cap=cap)


def _ivf_probe(centroids, queries, nprobe, cbias=None):
    """(f32 queries, (Q, nprobe) int32 probed clusters).  A balanced index
    placed vectors by argmin(|x - c|^2 + bias), i.e. argmax(x.c - (|c|^2 +
    bias) / 2): probes rank by the same biased score."""
    q = queries.float()
    cscore = q @ centroids.T
    if cbias is not None:
        cscore = cscore - 0.5 * ((centroids * centroids).sum(-1)
                                 + cbias)[None, :]
    return q, _topk(cscore, nprobe)[1]


def ivf_score_plain(packed, packed_ids, pscale, q, probe):
    """The plain PyTorch version of :func:`ivf_score`, the same contract.
    One probe rank at a time, so at most (Q, cap, D) candidates exist at
    once."""
    Q, nprobe = probe.shape
    nlist, cap = packed.shape[:2]
    if packed.dtype == torch.int8:
        q = q.bfloat16()
    q = q.float()
    probe = probe.long()
    valid = (probe >= 0) & (probe < nlist)  # else -inf and id -1
    probe = torch.where(valid, probe, 0)
    scores = torch.empty((Q, nprobe, cap), dtype=torch.float32,
                         device=q.device)
    for r in range(nprobe):
        c = probe[:, r]
        s = torch.bmm(packed[c].float(), q[:, :, None])[..., 0]
        if pscale is not None:
            s = s * pscale[c]
        scores[:, r] = torch.where((packed_ids[c] >= 0) & valid[:, r, None],
                                   s, -torch.inf)
    ids = torch.where(valid[..., None], packed_ids[probe], -1)
    return scores, ids.to(torch.int32)


# The kernel's tiling (csrc/ivf.cu): pairs a grouping block sorts, rows a
# scoring block owns, queries of a run a pass.
IVF_GROUP, IVF_ROWS, IVF_PASS = 1024, 128, 32


def ivf_group_plain(probe, nlist: int, group: int = IVF_GROUP):
    """The plain PyTorch version of ``csrc/ivf.cu:ivf_group_kernel``: the
    Q * nprobe (query, rank) pairs of ``probe`` (row-major pair index qi *
    nprobe + r) sorted by cluster, stably, ``group`` pairs at a time.
    Returns (runs (P, 4) int32, order (P,) int32): ``order`` the pair
    indices in sorted order; within each group, ``runs[k]`` = (first sorted
    position, length, cluster, 0) of its k-th run of equal clusters, the
    cluster -1 for probe ids outside [0, nlist) (one run of them a group),
    and (0, 0, -1, 0) after the group's last run."""
    flat = probe.reshape(-1).long()
    P = flat.numel()
    runs = torch.zeros((P, 4), dtype=torch.int32, device=probe.device)
    runs[:, 2] = -1
    order = torch.empty(P, dtype=torch.int32, device=probe.device)
    for base in range(0, P, group):
        c = flat[base:base + group]
        n = c.numel()
        key = torch.where((c >= 0) & (c < nlist), c, nlist)
        pos = torch.argsort(key, stable=True)
        order[base:base + n] = (base + pos).to(torch.int32)
        sk = key[pos]
        lead = torch.ones(n, dtype=torch.bool, device=probe.device)
        lead[1:] = sk[1:] != sk[:-1]
        starts = torch.nonzero(lead)[:, 0]
        ends = torch.cat([starts[1:], starts.new_tensor([n])])
        k = starts.numel()
        runs[base:base + k, 0] = (base + starts).to(torch.int32)
        runs[base:base + k, 1] = (ends - starts).to(torch.int32)
        runs[base:base + k, 2] = torch.where(sk[starts] < nlist, sk[starts],
                                             -1).to(torch.int32)
    return runs, order


def ivf_group(probe, nlist: int):
    """:func:`ivf_group_plain` with ``group`` = IVF_GROUP: on a CUDA tensor
    the grouping kernel alone (``csrc/ivf.cu:ivf_group_launch``), which
    :func:`ivf_score` launches itself; for the tests."""
    if probe.device.type == "cpu":
        return ivf_group_plain(probe, nlist)
    if probe.device.type != "cuda":
        raise ValueError(f"unsupported device {probe.device}")
    probe = probe.to(torch.int32).contiguous()
    P = probe.numel()
    scratch = torch.empty(5 * P, dtype=torch.int32, device=probe.device)
    status = _build.library("ivf").ivf_group_launch(
        probe.data_ptr(), P, nlist, scratch.data_ptr(),
        torch.cuda.current_stream(probe.device).cuda_stream)
    _build.check(status, "ivf_group")
    ivf_group.launches += 1
    return scratch[:4 * P].view(P, 4), scratch[4 * P:]


ivf_group.launches = 0


def ivf_score_clusters(packed, packed_ids, pscale, q, probe):
    """The cluster-by-cluster scoring of ``csrc/ivf.cu`` in PyTorch, for
    the tests: :func:`ivf_group_plain`, then for each run its cluster's
    rows IVF_ROWS at a time against the run's queries IVF_PASS at a time
    (f32 products of the bf16-rounded query for int8 codes, f32 else),
    pscale and the empty-slot mask, each score scattered to its (qi, r,
    row) place.  The same contract as :func:`ivf_score`; sums in
    ``torch.matmul``'s order, not the kernel's."""
    Q, nprobe = probe.shape
    nlist, cap, _ = packed.shape
    qf = (q.bfloat16() if packed.dtype == torch.int8 else q).float()
    runs, order = ivf_group_plain(probe, nlist)
    scores = torch.full((Q * nprobe, cap), -torch.inf, device=q.device)
    ids = torch.full((Q * nprobe, cap), -1, dtype=torch.int32,
                     device=q.device)
    for start, length, c, _ in runs.tolist():
        if length == 0 or c < 0:  # c < 0: not a cluster, -inf and -1 stay
            continue
        for r0 in range(0, cap, IVF_ROWS):
            rows = slice(r0, min(cap, r0 + IVF_ROWS))
            rid = packed_ids[c, rows]
            ps = (pscale[c, rows] if pscale is not None
                  else torch.ones_like(rid, dtype=torch.float32))
            for g0 in range(0, length, IVF_PASS):
                p = order[start + g0:start + min(length, g0 + IVF_PASS)].long()
                s = packed[c, rows].float() @ qf[p // nprobe].T  # (rows, nq)
                scores[p, rows] = torch.where(rid[None, :] >= 0, s.T * ps,
                                              -torch.inf)
                ids[p, rows] = rid
    return scores.reshape(Q, nprobe, cap), ids.reshape(Q, nprobe, cap)


def ivf_score(packed, packed_ids, pscale, q, probe):
    """Score the probed clusters: for each (query ``qi``, probe rank
    ``r``), the block ``packed[probe[qi, r]]`` (cap, D) dotted with
    ``q[qi]``, times ``pscale`` of the cluster where given, -inf where
    ``packed_ids`` < 0; a probe id outside [0, nlist) gives -inf and id -1
    in every slot.

    packed: (nlist, cap, D) int8 codes, bf16 or f32; packed_ids: (nlist,
    cap) int32; pscale: (nlist, cap) f32 or None; q: (Q, D) f32 (rounded to
    bf16 for int8 blocks, as the JAX package rounds it); probe: (Q, nprobe)
    int32.  Returns the dense (Q, nprobe, cap) f32 score and int32 id
    tables.  CPU tensors take :func:`ivf_score_plain`; CUDA tensors launch
    ``csrc/ivf.cu:ivf_score_launch`` (the grouping of the pairs by cluster,
    then the scoring, each probed cluster read once; no synchronisation)
    or raise."""
    if q.device.type == "cpu":
        return ivf_score_plain(packed, packed_ids, pscale, q, probe)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if packed.dtype not in _PACKED_CODE:
        raise ValueError(f"packed must be int8, bfloat16 or float32, got "
                         f"{packed.dtype}")
    if packed.dim() != 3:
        raise ValueError(f"packed must be (nlist, cap, D), got "
                         f"{tuple(packed.shape)}")
    nlist, cap, D = packed.shape
    Q, nprobe = probe.shape
    lib = _build.library("ivf")
    if not 0 < D <= lib.ivf_max_d():
        raise ValueError(f"the IVF kernel takes 0 < D <= {lib.ivf_max_d()}, "
                         f"got {D}")
    if cap < 1 or nlist < 1 or Q < 1 or nprobe < 1:
        raise ValueError(f"empty IVF operands: nlist={nlist} cap={cap} "
                         f"Q={Q} nprobe={nprobe}")
    probe = probe.to(torch.int32).contiguous()
    q = q.contiguous()
    checks = [("packed", packed, (nlist, cap, D), packed.dtype),
              ("packed_ids", packed_ids, (nlist, cap), torch.int32),
              ("q", q, (Q, D), torch.float32),
              ("probe", probe, (Q, nprobe), torch.int32)]
    if pscale is not None:
        checks.append(("pscale", pscale, (nlist, cap), torch.float32))
    for name, t, shape, dtype in checks:
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    code = _PACKED_CODE[packed.dtype]
    ks = lib.ivf_slice_elems(code)
    Dp = -(-D // ks) * ks
    scores = torch.empty((Q, nprobe, cap), dtype=torch.float32,
                         device=q.device)
    ids = torch.empty((Q, nprobe, cap), dtype=torch.int32, device=q.device)
    # The runs and the sorted pairs, and the queries padded to whole slices
    # (bf16 for int8 codes, f32 else).
    scratch = torch.empty(5 * Q * nprobe, dtype=torch.int32, device=q.device)
    qs = torch.empty((Q, Dp), device=q.device, dtype=(
        torch.bfloat16 if packed.dtype == torch.int8 else torch.float32))
    status = lib.ivf_score_launch(
        q.data_ptr(), probe.data_ptr(), packed.data_ptr(),
        packed_ids.data_ptr(), 0 if pscale is None else pscale.data_ptr(),
        scores.data_ptr(), ids.data_ptr(), scratch.data_ptr(), qs.data_ptr(),
        Q, nprobe, nlist, cap, D, Dp, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "ivf_score")
    ivf_score.launches += 1
    return scores, ids


ivf_score.launches = 0


def ivf_search(centroids, packed, packed_ids, queries, k=10, nprobe=8,
               pscale=None, cbias=None):
    """queries: (Q, D).  Returns (scores, ids) (Q, k); ids -1 = no hit
    (fewer than k candidates pad with -inf / -1, as the JAX XLA path).
    ``pscale`` dequantizes int8-coded clusters on the score (one multiply
    per candidate)."""
    q, probe = _ivf_probe(centroids, queries, nprobe, cbias)
    scores, ids = ivf_score(packed, packed_ids, pscale, q, probe)
    Q = q.shape[0]
    flat = scores.reshape(Q, -1)
    top, pos = torch.topk(flat, min(k, flat.shape[1]), dim=-1)
    out_i = torch.gather(ids.reshape(Q, -1), 1, pos)
    out_i = torch.where(torch.isfinite(top), out_i, -1).to(torch.int32)
    if top.shape[1] < k:
        pad = k - top.shape[1]
        top = torch.cat([top, top.new_full((Q, pad), -torch.inf)], 1)
        out_i = torch.cat([out_i, out_i.new_full((Q, pad), -1)], 1)
    return top, out_i


class StreamedIVFBuilder:
    """Builds an int8 :class:`IVFIndex` on the device from data arriving in
    fixed-size chunks; nothing N-sized touches the host.  Feed chunks with
    :meth:`add`; ``packed`` is updated in place.

    ``cap`` is fixed up front; a row landing in a full cluster SPILLS to
    its next-nearest centroid with space (``spill`` candidates per row);
    rows exhausting every candidate are dropped and counted (``dropped``).
    Placement equals the JAX builder's for the same centroids and chunks:
    ranks within a cluster follow a stable sort by cluster."""

    def __init__(self, centroids, cap: int, dim: int, spill: int = 3,
                 cbias=None):
        self.centroids = centroids.float()
        dev = self.centroids.device
        nlist = centroids.shape[0]
        self.nlist, self.cap, self.dim = nlist, cap, dim
        self.spill = max(1, min(spill, nlist))
        self.cbias = None if cbias is None else torch.as_tensor(
            cbias, dtype=torch.float32, device=dev)
        self.packed = torch.zeros((nlist, cap, dim), dtype=torch.int8,
                                  device=dev)
        self.packed_ids = torch.full((nlist, cap), -1, dtype=torch.int32,
                                     device=dev)
        self.pscale = torch.zeros((nlist, cap), dtype=torch.float32,
                                  device=dev)
        self.fill = torch.zeros(nlist, dtype=torch.int32, device=dev)
        self.dropped = torch.zeros((), dtype=torch.int32, device=dev)
        # Placement metric: d2 + cbias, the bias folded into |c|^2 once.
        self._c2 = (self.centroids * self.centroids).sum(-1)
        if self.cbias is not None:
            self._c2 = self._c2 + self.cbias

    def add(self, x, base_id: int) -> None:
        """x: (chunk, D) on the device; base_id: global id of row 0."""
        cap, nlist = self.cap, self.nlist
        xf = x.float()
        d2 = self._c2[None, :] - 2.0 * (xf @ self.centroids.T)
        cand = _topk(-d2, self.spill)[1]            # (n, spill) nearest
        n = cand.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=x.device)
        # XLA compiles the JAX builder's "/ 127.0" to a multiply by the f32
        # reciprocal; the same here, so the scales are equal bit for bit.
        scale = torch.clamp(xf.abs().amax(-1), min=1e-12) * (1.0 / 127.0)
        codes = torch.clamp(torch.round(xf / scale[:, None]),
                            -127, 127).to(torch.int8)
        placed = torch.zeros(n, dtype=torch.bool, device=x.device)
        for p in range(self.spill):
            # Already-placed rows get the sentinel cluster nlist (sorted
            # last, never written).
            a = torch.where(placed, nlist, cand[:, p])
            # Rank of each unplaced row within its cluster in this chunk:
            # stable sort by cluster, then position since the run's start.
            order = torch.argsort(a, stable=True)
            sa = a[order]
            is_start = torch.ones(n, dtype=torch.bool, device=x.device)
            is_start[1:] = sa[1:] != sa[:-1]
            run_start = torch.cummax(torch.where(is_start, idx, 0), 0)[0]
            rank = torch.empty_like(a)
            rank[order] = idx - run_start
            pos = self.fill[torch.clamp(a, max=nlist - 1)] + rank
            ok = (pos < cap) & ~placed
            rows = ok.nonzero()[:, 0]
            ca, cp = a[rows].long(), pos[rows].long()
            self.packed[ca, cp] = codes[rows]
            self.packed_ids[ca, cp] = base_id + idx[rows]
            self.pscale[ca, cp] = scale[rows]
            self.fill += torch.bincount(ca, minlength=nlist).to(torch.int32)
            placed |= ok
        self.dropped += (~placed).sum().to(torch.int32)

    def finish(self) -> IVFIndex:
        return IVFIndex(centroids=self.centroids, packed=self.packed,
                        packed_ids=self.packed_ids, nlist=self.nlist,
                        cap=self.cap, pscale=self.pscale, cbias=self.cbias)


def topk_merge_chunk(best_s, best_i, x, base, queries, k=10):
    """Running exact top-k over streamed index chunks on the device: merge
    the (Q, k) running bests with this chunk's top-k.  Returns new
    tensors."""
    s = _mm_f32(queries.to(x.dtype), x)
    st, pos = _topk(s, min(k, x.shape[0]))
    cat_s = torch.cat([best_s, st], 1)
    cat_i = torch.cat([best_i, pos + int(base)], 1)
    top, mpos = torch.topk(cat_s, k, dim=-1)
    return top, torch.gather(cat_i, 1, mpos)


def exact_search_chunked(data: np.ndarray, queries, k=10,
                         chunk: int = 1 << 20, device="cuda"):
    """Exact MIPS over a HOST-resident (N, D) matrix, streamed through the
    device in bf16 chunks and merged on the host (stable order on ties):
    ground truth for indices larger than the device holds."""
    qd = torch.as_tensor(np.asarray(queries, np.float32),
                         device=device).bfloat16()
    Q = qd.shape[0]
    best_s = np.full((Q, k), -np.inf, np.float32)
    best_i = np.full((Q, k), -1, np.int64)
    for i in range(0, data.shape[0], chunk):
        x = torch.as_tensor(np.asarray(data[i:i + chunk], np.float32),
                            device=device).bfloat16()
        s, idx = _topk(_mm_f32(qd, x), min(k, x.shape[0]))
        cat_s = np.concatenate([best_s, s.cpu().numpy()], axis=1)
        cat_i = np.concatenate([best_i, idx.cpu().numpy().astype(np.int64)
                                + i], axis=1)
        sel = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(cat_s, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
    return best_s, best_i
