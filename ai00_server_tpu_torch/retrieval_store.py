"""Named vector indices for the retrieval API (the RAG serving tier).

Port of ``ai00_server_tpu/retrieval_store.py``: each index holds its
vectors and optional document texts on the host, an exact-search matrix on
the device in bf16, and an optional IVF structure (built on demand, probed
through ``ops/retrieval.ivf_score``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from .device import resolve_device
from .ops import retrieval as R


@dataclass
class VectorIndex:
    name: str
    dim: int
    vectors: np.ndarray                  # (N, D) f32, host
    texts: list[str] = field(default_factory=list)
    device: torch.Tensor | None = None   # (N, D) bf16 on the device
    ivf: R.IVFIndex | None = None
    dirty: bool = True

    @property
    def size(self) -> int:
        return int(self.vectors.shape[0])


class RetrievalStore:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._indices: dict[str, VectorIndex] = {}
        self._lock = threading.Lock()

    def create(self, name: str, dim: int) -> VectorIndex:
        with self._lock:
            idx = VectorIndex(name=name, dim=dim,
                              vectors=np.zeros((0, dim), np.float32))
            self._indices[name] = idx
            return idx

    def get(self, name: str) -> VectorIndex:
        idx = self._indices.get(name)
        if idx is None:
            raise KeyError(f"no such index: {name}")
        return idx

    def list(self) -> list[dict]:
        return [{"name": i.name, "dim": i.dim, "size": i.size,
                 "ivf": i.ivf is not None}
                for i in self._indices.values()]

    def drop(self, name: str) -> None:
        with self._lock:
            self._indices.pop(name, None)

    def add(self, name: str, vectors: np.ndarray,
            texts: list[str] | None = None) -> int:
        with self._lock:
            idx = self.get(name)
            vectors = np.asarray(vectors, np.float32).reshape(-1, idx.dim)
            idx.vectors = np.concatenate([idx.vectors, vectors], axis=0)
            if texts:
                idx.texts.extend(texts)
            idx.dirty = True
            return idx.size

    def build_ivf(self, name: str, nlist: int = 64, iters: int = 10,
                  quant: str | None = None) -> None:
        """``quant='int8'`` stores per-vector-scaled int8 codes (half the
        device bytes of bf16)."""
        idx = self.get(name)
        nlist = min(nlist, max(1, idx.size))
        idx.ivf = R.build_ivf(idx.vectors, nlist=nlist, iters=iters,
                              quant=quant, device=self.device)

    def _ensure_device(self, idx: VectorIndex) -> None:
        if idx.dirty or idx.device is None:
            idx.device = torch.as_tensor(idx.vectors,
                                         device=self.device).bfloat16()
            idx.dirty = False

    def search(self, name: str, queries: np.ndarray, top_k: int = 10,
               nprobe: int = 8, exact: bool | None = None):
        """Returns (scores (Q, k), ids (Q, k), texts list[list[str|None]])."""
        idx = self.get(name)
        if idx.size == 0:
            raise ValueError(f"index {name} is empty")
        q = torch.as_tensor(np.asarray(queries, np.float32).reshape(
            -1, idx.dim), device=self.device)
        k = min(top_k, idx.size)
        use_exact = exact if exact is not None else idx.ivf is None
        if use_exact or idx.ivf is None:
            self._ensure_device(idx)
            scores, ids = R.exact_search(idx.device, q.bfloat16(), k=k)
        else:
            ivf = idx.ivf
            scores, ids = R.ivf_search(
                ivf.centroids, ivf.packed, ivf.packed_ids, q, k=k,
                nprobe=min(nprobe, ivf.nlist), pscale=ivf.pscale)
        scores = scores.float().cpu().numpy()
        ids = ids.cpu().numpy()
        texts = [[idx.texts[i] if 0 <= i < len(idx.texts) else None
                  for i in row] for row in ids]
        return scores, ids, texts
