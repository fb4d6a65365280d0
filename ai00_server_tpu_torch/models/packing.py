"""Flat state layout: pack and unpack between a model's row state and the
row-matrix form of ``/api/oai/states``, ``.state`` files and the runtime's
state registry.

Port of ``ai00_server_tpu/models/packing.py`` (the same layout, so a state
packed by either package unpacks in the other):

* v5/v6/v7: per layer ``head_size + 2`` rows of width ``num_emb``: row 0
  the att token shift, rows ``1..N+1`` the WKV matrix (row ``r``, column
  ``h*N + c`` = ``S[h, r, c]`` with ``S`` in ``(k, v)`` orientation; v7's
  in-model ``(v, k)`` layout is transposed at the boundary), the last row
  the ffn token shift.
* v4: 5 rows per layer: att shift, aa, bb, pp, ffn shift.

The shape reported over the API is ``[num_layer, rows_per_layer, num_emb,
1]``.  The keys of a row state are those of the version module's
``init_state`` (``models/v7.py``, ``models/v4.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .info import ModelInfo, ModelVersion


def state_shape(info: ModelInfo) -> tuple[int, int, int, int]:
    return (info.num_layer, info.state_rows_per_layer, info.num_emb, 1)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def pack_state(info: ModelInfo, state, batch_index: int = 0) -> np.ndarray:
    """A row state (tensors on any device or numpy, leading ``(L, B,
    ...)``, e.g. ``Engine.read_row_state``) -> the ``(L, rows, C)`` float32
    array of one batch row."""
    L, rows, C, _ = state_shape(info)
    H, N = info.num_head, info.head_size
    out = np.zeros((L, rows, C), np.float32)
    b = batch_index
    out[:, 0] = _f32(state["att_x"])[:, b]
    if info.version == ModelVersion.V4:
        out[:, 1] = _f32(state["aa"])[:, b]
        out[:, 2] = _f32(state["bb"])[:, b]
        out[:, 3] = _f32(state["pp"])[:, b]
        out[:, 4] = _f32(state["ffn_x"])[:, b]
        return out
    wkv = _f32(state["wkv"])[:, b]  # (L, H, N, N)
    if info.version == ModelVersion.V7:
        wkv = np.swapaxes(wkv, -1, -2)  # (v, k) -> (k, v)
    # Row r is the first matrix axis; the heads sit beside each other on
    # the columns.
    out[:, 1: N + 1] = np.moveaxis(wkv, 2, 1).reshape(L, N, H * N)
    out[:, N + 1] = _f32(state["ffn_x"])[:, b]
    return out


def unpack_state(info: ModelInfo, flat, dtype=np.float32) -> dict:
    """``(L, rows, C)`` (or the flat data of that shape) -> the batch-1 row
    state (numpy) that ``Engine.load_row_state`` takes."""
    L, rows, C, _ = state_shape(info)
    flat = np.asarray(flat, np.float32).reshape(L, rows, C)
    H, N = info.num_head, info.head_size
    if info.version == ModelVersion.V4:
        return {
            "att_x": flat[:, 0][:, None].astype(dtype),
            "aa": flat[:, 1][:, None].astype(np.float32),
            "bb": flat[:, 2][:, None].astype(np.float32),
            "pp": flat[:, 3][:, None].astype(np.float32),
            "ffn_x": flat[:, 4][:, None].astype(dtype),
        }
    wkv = np.moveaxis(flat[:, 1: N + 1].reshape(L, N, H, N), 1, 2)
    if info.version == ModelVersion.V7:
        wkv = np.swapaxes(wkv, -1, -2)  # (k, v) -> (v, k)
    return {
        "att_x": flat[:, 0][:, None].astype(dtype),
        "wkv": wkv[:, None].astype(dtype),
        "ffn_x": flat[:, N + 1][:, None].astype(dtype),
    }


def load_state_file(info: ModelInfo, path: str, dtype=np.float32) -> dict:
    """Read a ``.state`` file (safetensors, or ``.pth`` / ``.pt``) into a
    batch-1 row state.

    Takes either per-layer ``blocks.N.att.time_state`` tensors (state-tuning
    checkpoints: the WKV part only, shifts zero) or one packed ``state``
    tensor in the layout above.  A file that is neither raises, naming it
    (the JAX package builds a ``wkv`` entry for RWKV-4, which has none)."""
    from ..loader import _is_convert_transposed, read_checkpoint

    raw = read_checkpoint(path)
    if "state" in raw:
        return unpack_state(info, raw["state"], dtype)
    if info.version == ModelVersion.V4:
        raise ValueError(f"{path}: an RWKV-4 state file holds a packed "
                         "'state' tensor (v4 has no time_state)")
    H, N = info.num_head, info.head_size
    wkvs = []
    for i in range(info.num_layer):
        for key in (f"blocks.{i}.att.time_state", f"blocks.{i}.time_state"):
            if key in raw:
                v = raw[key]
                if _is_convert_transposed(key):
                    v = np.swapaxes(v, -1, -2)
                wkvs.append(v.reshape(H, N, N))
                break
        else:
            raise ValueError(f"{path}: missing time_state for layer {i}")
    wkv = np.stack(wkvs)  # (L, H, N_k, N_v)
    if info.version == ModelVersion.V7:
        wkv = np.swapaxes(wkv, -1, -2)
    return {
        "att_x": np.zeros((info.num_layer, 1, info.num_emb), dtype),
        "wkv": wkv[:, None].astype(dtype),
        "ffn_x": np.zeros((info.num_layer, 1, info.num_emb), dtype),
    }
