"""The file routes' work: directory listings with the safetensors header
and a sampled SHA-256, the model list, zip extraction.

Port of ``ai00_server_tpu/server/files.py``.  ``unzip`` checks each
member's containment by path components (``os.path.commonpath``), where
the JAX function compares string prefixes and lets ``../www2/x`` out of a
target ``.../www``.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zipfile

# The roots the file routes may touch, relative to the working directory.
PERMITTED = ["assets", "assets/www", "assets/models", "assets/configs"]

MODEL_SUFFIXES = (".st", ".safetensors", ".prefab", ".pth")


def sampled_sha(path: str) -> str:
    """SHA-256 of the whole file up to 10 MB; above that, of the first MB
    of each tenth of the file."""
    size = os.path.getsize(path)
    h = hashlib.sha256()
    meg = 1 << 20
    with open(path, "rb") as f:
        if size <= 10 * meg:
            while chunk := f.read(meg):
                h.update(chunk)
        else:
            stride = size // 10
            for i in range(10):
                f.seek(i * stride)
                h.update(f.read(meg))
    return h.hexdigest()


def safetensors_header(path: str) -> dict | None:
    """The safetensors JSON header, without reading the tensors (None for
    a file that has none, or one over 100 MB)."""
    try:
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            if n > 100 * (1 << 20):
                return None
            return json.loads(f.read(n))
    except Exception:
        return None


def list_dir(path: str, with_hash: bool = False) -> list[dict]:
    """Directory entries: name, is_dir, size; a file's ``sha`` with
    ``with_hash``; a safetensors file's tensor count and metadata."""
    out = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        is_dir = os.path.isdir(full)
        entry = {"name": name, "is_dir": is_dir,
                 "size": 0 if is_dir else os.path.getsize(full)}
        if not is_dir:
            if with_hash:
                entry["sha"] = sampled_sha(full)
            if name.endswith((".st", ".safetensors", ".state")):
                header = safetensors_header(full)
                if header is not None:
                    meta = header.pop("__metadata__", None)
                    entry["info"] = {"num_tensors": len(header),
                                     "metadata": meta}
        out.append(entry)
    return out


def list_models(model_dir: str) -> list[dict]:
    """The model files under ``model_dir``, recursively: name relative to
    it, size, sampled sha."""
    out = []
    if not os.path.isdir(model_dir):
        return out
    for root, _dirs, names in os.walk(model_dir):
        for name in sorted(names):
            if not name.endswith(MODEL_SUFFIXES):
                continue
            full = os.path.join(root, name)
            out.append({"name": os.path.relpath(full, model_dir),
                        "size": os.path.getsize(full),
                        "sha": sampled_sha(full)})
    return out


def unzip(source: str, target_dir: str) -> None:
    """Extract ``source`` under ``target_dir``; a member whose path leaves
    the target raises ``PermissionError`` before anything is written."""
    os.makedirs(target_dir, exist_ok=True)
    root = os.path.realpath(target_dir)
    with zipfile.ZipFile(source) as z:
        for member in z.namelist():
            dest = os.path.realpath(os.path.join(target_dir, member))
            if os.path.commonpath([root, dest]) != root:
                raise PermissionError(f"zip member escapes target: {member}")
        z.extractall(target_dir)
