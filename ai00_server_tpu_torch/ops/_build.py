"""Build and load the hand-written CUDA kernels in ``csrc/``.

At first use each ``csrc/<name>.cu`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, cached under
``ai00_server_tpu_torch/_build/`` (ignored by git) by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with
``ctypes``.  Each library's C functions take raw device pointers and the
CUDA stream as ``void*`` and ints as ``int``, and return
``cudaGetLastError()`` after their launch.

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
        # S, r, k, v, w, u, mask, S_out, y, B, H, N, w_static, stream
        "wkv56_t1_launch": "pppppppppiiiip",
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
        # r, k, v, w, a, g, vmix, v_first, vecs, active, S, out, B, H, N,
        # is_first, dtype, stream
        "v7_wkv_gn_launch": "ppppppppppppiiiiip",
    },
    "phased": {
        # desc (host), n_prob, plan (host), n_launch, dtype, wbits, stream
        "phased_matmul_launch": "pipiiip",
        # wbits, rows, cluster size -> clusters the card holds at once
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

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
ptxas_info: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels build on a machine with the CUDA toolkit")


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    ptxas_info[name] = proc.stdout + proc.stderr
    return out


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for fn, sig in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = [kinds[c] for c in sig]
        f.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source in parallel (one ``nvcc`` each) and load them."""
    with _lock:
        todo = [n for n in SIGNATURES if n not in _libs]
        with ThreadPoolExecutor(max_workers=max(1, len(todo))) as ex:
            paths = dict(zip(todo, ex.map(_compile, todo)))
        for n, p in paths.items():
            _libs[n] = _load(n, p)
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
