"""Build and load the hand-written CUDA kernels in ``csrc/``.

At first use each ``csrc/<name>.cu`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, cached under
``ai00_server_tpu_torch/_build/`` (ignored by git) by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with
``ctypes``.  Each library's C functions take raw device pointers and the
CUDA stream as ``void*`` and ints as ``int``, and return
``cudaGetLastError()`` after their launch.

The WKV sources (``HEAD_SOURCES``) are compiled once per head size N, with
``-DHEAD_N=<N>``, into a library of their own (``lib<name>_n<N>_<hash>.so``,
keyed by ``(name, N)``): their state tiles, sums and shared-memory layouts
are sized at compile time.  They take every ``N % 8 == 0`` with ``8 <= N <=
128`` (``head_size_ok``); the other sources do not depend on N.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures: "p" = device pointer or stream (c_void_p), "i" = c_int.
SIGNATURES = {
    "wkv7": {
        # S, r, w, k, v, kk, a, mask, S_out, y, B, H, N, vec_bf16, slices,
        # stream
        "wkv7_t1_launch": "ppppppppppiiiiip",
        # S, r, w, k, v, kk, a, mask, scratch, S_out, y, B, T, H, N, slices,
        # stream
        "wkv7_chunk_launch": "pppppppppppiiiiip",
        # -> floats of the chunk's scratch per (b, h, sub-chunk)
        "wkv7_chunk_scratch_floats": "",
    },
    "wkv56": {
        # S, r, k, v, w, u, mask, S_out, y, B, H, N, w_static, vec_bf16,
        # slices, stream
        "wkv56_t1_launch": "pppppppppiiiiiip",
        # S, r, k, v, w, u, mask, scratch, S_out, y, B, T, H, N, w_static,
        # slices, stream
        "wkv56_chunk_launch": "ppppppppppiiiiiip",
        # -> floats of the chunk's scratch per (b, h, sub-chunk)
        "wkv56_chunk_scratch_floats": "",
        # S, r, k, v, w, u, mask, S_out, y, B, T, H, N, w_static, stream
        "wkv56_chunk_seq_launch": "pppppppppiiiiip",
    },
    "v7_decode": {
        # x, ln, shift, mix, active, out, B, C, n_mix, base, dtype, stream
        "v7_ln_mix_launch": "ppppppiiiiip",
        # desc (host), n_prob, plan (host), n_launch, dtype, wbits, levels
        # (host), stream
        "v7_skinny_matmul_launch": "pipiiipp",
    },
    "v7_wkv_gn": {
        # r, k, v, w, a, g, vmix, v_first, vecs, active, S, out, B, H, N,
        # is_first, dtype, stream
        "v7_wkv_gn_launch": "ppppppppppppiiiiip",
    },
    "phased": {
        # desc (host), n_prob, plan (host), n_launch, dtype, wbits, levels
        # (host, null but for nf4 / sf4), stream
        "phased_matmul_launch": "pipiiipp",
        # kernel kind (0, 8, 4 or 16 for nf4 / sf4), rows, cluster size ->
        # clusters the card holds at once
        "phased_max_clusters": "iii",
    },
    "wkv4": {
        # r, k, v, vecs, active, aa, bb, pp, out, B, C, dtype, stream
        "v4_wkv_launch": "pppppppppiiip",
        # aa, bb, pp, k, v, w, u, mask, aa_out, bb_out, pp_out, y, B, T, C,
        # NS, dtype, stream
        "wkv4_chunk_launch": "ppppppppppppiiiiip",
        # the same without NS (T <= 16: one thread a channel)
        "wkv4_chunk_seq_launch": "ppppppppppppiiiip",
    },
    "v6_decode": {
        # r, k, v, w, g, vecs, active, S, out, B, H, N, w_stride, round_yf,
        # dtype, stream
        "v6_wkv_gn_launch": "pppppppppiiiiiip",
    },
    "quant": {
        # x, q, s, levels (host, null for int8), l, y, R, K, N, dtype,
        # out_f32, plan (host), n_launch, stream
        "quant_matmul_launch": "ppppipiiiiipip",
        # xf, shift, mix_k, active, key_q, key_s, val_q, val_s, levels (host,
        # null for int8), l, out, new_shift, hk, B, C, F, dtype, key plan
        # (host), value plan (host), n_launch, stream
        "ffn7_t1_l_launch": "pppppppppipppiiiippip",
    },
    "ivf": {
        # -> the largest D the kernel takes (not a status)
        "ivf_max_d": "",
        # dtype -> elements of a row a stage holds (not a status)
        "ivf_slice_elems": "i",
        # probe, P, nlist, scratch, stream (the grouping alone)
        "ivf_group_launch": "piipp",
        # q, probe, packed, packed_ids, pscale (null: none), scores, ids,
        # scratch, qs, Q, nprobe, nlist, cap, D, Dp, dtype, stream
        "ivf_score_launch": "pppppppppiiiiiiip",
    },
}

# The sources compiled once per head size (-DHEAD_N), and the sizes they take.
HEAD_SOURCES = ("wkv7", "wkv56", "v7_wkv_gn", "v6_decode")
HEAD_MIN, HEAD_MAX, HEAD_STEP = 8, 128, 8
DEFAULT_HEAD = 64

_libs: dict[tuple[str, int | None], ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_info: dict[str, str] = {}


def head_size_ok(n: int) -> bool:
    """Whether the WKV kernels take head size ``n``: ``n % 8 == 0`` and ``8
    <= n <= 128``."""
    return n % HEAD_STEP == 0 and HEAD_MIN <= n <= HEAD_MAX


def head_tile(n: int) -> int:
    """The size a WKV kernel lays a head of size ``n`` out at (``HEAD_P`` in
    ``csrc/decode_common.cuh``): the next power of two, at least 32.  Rows
    and columns past ``n`` are masked zeros."""
    p = 32
    while p < n:
        p *= 2
    return p


def check_head_size(n: int) -> None:
    """Raise ValueError naming ``n`` unless the WKV kernels take it."""
    if not head_size_ok(n):
        raise ValueError(
            f"head size {n}: the CUDA kernels take N % {HEAD_STEP} == 0 with "
            f"{HEAD_MIN} <= N <= {HEAD_MAX}")


def key(name: str, head: int = DEFAULT_HEAD) -> tuple[str, int | None]:
    """The library of ``name`` for head size ``head``: ``(name, head)`` for
    a source of ``HEAD_SOURCES``, ``(name, None)`` for the others."""
    if name not in SIGNATURES:
        raise KeyError(f"no kernel source {name!r}")
    if name not in HEAD_SOURCES:
        return name, None
    check_head_size(head)
    return name, head


def flags(name: str, head: int = DEFAULT_HEAD) -> list[str]:
    """``nvcc``'s flags for the library ``key(name, head)``."""
    n = key(name, head)[1]
    return NVCC_FLAGS + ([] if n is None else [f"-DHEAD_N={n}"])


def library_path(name: str, head: int = DEFAULT_HEAD) -> Path:
    """Where the library ``key(name, head)`` is cached: its name carries the
    head size and a hash of the source, the headers and the flags."""
    n = key(name, head)[1]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(flags(name, head)).encode()).hexdigest()[:16]
    return BUILD / (f"lib{name}_{digest}.so" if n is None
                    else f"lib{name}_n{n}_{digest}.so")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels build on a machine with the CUDA toolkit")


def _compile(k: tuple[str, int | None]) -> Path:
    name, n = k
    head = DEFAULT_HEAD if n is None else n
    out = library_path(name, head)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = CSRC / f"{name}.cu"
    proc = subprocess.run([_nvcc(), *flags(name, head), "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        at = "" if n is None else f" (head size {n})"
        raise RuntimeError(f"nvcc failed for {src}{at}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    label = name if n is None or n == DEFAULT_HEAD else f"{name} (N={n})"
    ptxas_info[label] = proc.stdout + proc.stderr
    return out


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for fn, sig in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = [kinds[c] for c in sig]
        f.restype = ctypes.c_int
    return lib


def _build_keys(keys) -> None:
    """Compile the libraries ``keys`` not loaded yet in parallel (one
    ``nvcc`` each) and load them."""
    with _lock:
        todo = [k for k in dict.fromkeys(keys) if k not in _libs]
        if not todo:
            return
        with ThreadPoolExecutor(max_workers=len(todo)) as ex:
            paths = dict(zip(todo, ex.map(_compile, todo)))
        for k, p in paths.items():
            _libs[k] = _load(k[0], p)


def build_all(heads=(DEFAULT_HEAD,)) -> dict[str, ctypes.CDLL]:
    """Compile every source in parallel (one ``nvcc`` each; the WKV sources
    once for each of ``heads``) and load them.  Returns the libraries of the
    first head size by source name."""
    _build_keys([key(name, h) for h in heads for name in SIGNATURES])
    return {name: _libs[key(name, heads[0])] for name in SIGNATURES}


def library(name: str, head: int = DEFAULT_HEAD) -> ctypes.CDLL:
    """The loaded library of ``name`` for head size ``head``, built at first
    use.  ``head`` outside ``head_size_ok`` raises ValueError."""
    k = key(name, head)
    lib = _libs.get(k)
    if lib is None:
        _build_keys([k])
        lib = _libs[k]
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
