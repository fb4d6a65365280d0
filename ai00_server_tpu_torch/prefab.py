"""Prefab export and import: a loaded (possibly quantized) model in one file
that reloads without conversion or quantization.

Port of ``ai00_server_tpu/prefab.py`` with its on-disk format, so a prefab
written by either package loads in the other: a safetensors file whose
metadata ``prefab`` is a JSON object with

* ``magic`` ``"ai00-tpu-prefab-v2"``;
* ``skeleton``: the JAX package's param tree — ``emb``, ``ln_out_w``,
  ``ln_out_b``, ``head`` and ``groups`` (contiguous runs of layers of one
  quantization mode: ``{"layer_index": (K,) int32, "layers": the layer dict
  with every leaf stacked over the K layers}``) — where a leaf is
  ``{"__tensor__": key}`` and a quantized weight ``{"__quant__": mode,
  "shape", "q", "scale"}`` (4-bit codes in the split-half pack layout of
  ``ops/quant.py``);
* ``init_wkv`` (the embedded initial state or null), ``info`` (the
  ``ModelInfo`` fields), ``dtypes`` (bf16 is stored as its ``uint16`` bits)
  and ``config`` (the reload request that built the model).

The port keeps one dict per layer (``loader.py``); :func:`save_prefab`
stacks them back into groups of one mode and :func:`load_prefab` unstacks
them with ``loader.params_from_numpy``.  Derived ``_``-keys (the int8 LM
head ``_head_q``, the fused decode layouts) are never written: the lossless
originals in ``LoadedModel.host_params`` go in their place.  A prefab
written before the int8 head became derived holds it as ``head_q`` and no
lossless head: :func:`load_prefab` reads it as ``_head_q``, and
:func:`save_prefab` writes such a head back as ``head_q``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .loader import LoadedModel, _mode_runs, params_from_numpy
from .models.info import ModelInfo, ModelVersion
from .ops import quant as quant_ops

PREFAB_MAGIC = "ai00-tpu-prefab-v2"
# First bytes of a CBOR map: the reference's own (web-rwkv) prefab format.
CBOR_HEADS = (b"\xa2", b"\xa3", b"\xa4", b"\xbf", b"\xd9")


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor -> (host numpy array, dtype tag); bf16 as its uint16 bits."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _leaf(tensors: dict, arr: np.ndarray, dtype: str) -> dict:
    key = f"t{len(tensors)}"
    tensors[key] = (np.ascontiguousarray(arr), dtype)
    return {"__tensor__": key}


def _tensor_node(tensors: dict, t) -> dict:
    if isinstance(t, np.ndarray):
        return _leaf(tensors, t, str(t.dtype))
    return _leaf(tensors, *_host(t))


def _quant_node(tensors: dict, mode: str, shape, q, scale) -> dict:
    return {"__quant__": mode, "shape": list(shape),
            "q": _tensor_node(tensors, q),
            "scale": _tensor_node(tensors, scale)}


def _stacked_quant(tensors: dict, leaves: list) -> dict:
    """The quantized weight of one run of layers, stacked over the run: a
    run whose views cover one stacked ``QuantizedLinear`` in order is
    written from it as it is; other leaves (per-layer codes) are stacked."""
    first = leaves[0]
    qlin = getattr(first, "qlin", None)
    if qlin is not None and qlin.q.shape[0] == len(leaves) and all(
            getattr(v, "qlin", None) is qlin and v.idx == i
            for i, v in enumerate(leaves)):
        return _quant_node(tensors, qlin.mode, qlin.shape, qlin.q,
                           qlin.scale)
    q = np.stack([_host(v.q)[0] for v in leaves])
    scale = np.stack([_host(v.scale)[0] for v in leaves])
    return _quant_node(tensors, first.mode, first.shape, q, scale)


def _stack_layers(tensors: dict, layers: list):
    """Per-layer dicts of one run -> the skeleton of the stacked dict."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers(tensors, [p[k] for p in layers])
                for k in first}
    if quant_ops.is_quantized(first):
        return _stacked_quant(tensors, layers)
    parts = [_host(t) for t in layers]
    return _leaf(tensors, np.stack([a for a, _ in parts]), parts[0][1])


def _layer_mode(layer: dict) -> str:
    modes = {leaf.mode for part in ("att", "ffn")
             for leaf in layer[part].values() if quant_ops.is_quantized(leaf)}
    if len(modes) > 1:
        raise ValueError(f"a layer holds codes of several modes {modes}")
    return modes.pop() if modes else "none"


def save_prefab(path: str, model: LoadedModel, config: dict | None = None
                ) -> None:
    """Write ``model`` as a prefab at ``path`` (see the module docstring)."""
    from safetensors.numpy import save_file

    params = model.params
    tensors: dict = {}
    layers = params["layers"]
    groups = []
    for start, size in _mode_runs([_layer_mode(p) for p in layers]):
        groups.append({
            "layer_index": _leaf(
                tensors, np.arange(start, start + size, dtype=np.int32),
                "int32"),
            "layers": _stack_layers(tensors, layers[start: start + size]),
        })
    skeleton = {"groups": groups}
    top = {k: v for k, v in params.items()
           if not k.startswith("_") and k != "layers"}
    for k, v in (model.host_params or {}).items():
        top.setdefault(k, v)
    if "head" not in top and "_head_q" in params:
        top["head_q"] = params["_head_q"]  # no lossless head to write
    for k, v in top.items():
        skeleton[k] = (_quant_node(tensors, v.mode, v.shape, v.q, v.scale)
                       if quant_ops.is_quantized(v)
                       else _tensor_node(tensors, v))
    init = None
    if model.init_wkv is not None:
        init = _leaf(tensors, np.asarray(model.init_wkv, np.float32),
                     "float32")
    info = model.info
    meta = {
        "magic": PREFAB_MAGIC,
        "skeleton": skeleton,
        "init_wkv": init,
        "info": {
            "version": info.version.value,
            "num_layer": info.num_layer,
            "num_emb": info.num_emb,
            "num_hidden": info.num_hidden,
            "num_vocab": info.num_vocab,
            "num_head": info.num_head,
            "head_size": info.head_size,
        },
        "dtypes": {k: d for k, (a, d) in tensors.items()},
        "config": config or {},
    }
    save_file({k: a for k, (a, d) in tensors.items()}, path,
              metadata={"prefab": json.dumps(meta)})


def _from_skeleton(sk, tensors: dict):
    if isinstance(sk, list):
        return [_from_skeleton(v, tensors) for v in sk]
    if not isinstance(sk, dict):
        raise ValueError(f"bad prefab skeleton node {sk!r}")
    if "__tensor__" in sk:
        arr, dtype = tensors[sk["__tensor__"]]
        if dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    if "__quant__" in sk:
        return quant_ops.QuantizedLinear(
            sk["__quant__"], _from_skeleton(sk["q"], tensors),
            _from_skeleton(sk["scale"], tensors), sk["shape"])
    return {k: _from_skeleton(v, tensors) for k, v in sk.items()}


def load_prefab(path: str, device: str | torch.device = "cuda"
                ) -> LoadedModel:
    """Read a prefab onto ``device``.  A reference (web-rwkv CBOR) prefab or
    a file without the magic raises ``ValueError`` naming the file."""
    from safetensors import safe_open

    with open(path, "rb") as fh:
        first = fh.read(1)
    if first in CBOR_HEADS:
        raise ValueError(
            f"{path}: looks like a reference (web-rwkv cbor) prefab; those "
            "are not interchangeable with ai00-tpu prefabs.  Export one "
            "from the original .st / .pth with Middleware.save.")
    with safe_open(path, framework="numpy") as f:
        meta = json.loads((f.metadata() or {}).get("prefab", "{}"))
        if meta.get("magic") != PREFAB_MAGIC:
            raise ValueError(f"{path}: not an ai00-tpu prefab (magic "
                             f"{meta.get('magic')!r}, want {PREFAB_MAGIC!r})")
        dtypes = meta["dtypes"]
        tensors = {k: (f.get_tensor(k), dtypes[k]) for k in f.keys()}
    tree = _from_skeleton(meta["skeleton"], tensors)
    if "head_q" in tree:
        tree["_head_q"] = tree.pop("head_q")
    params = params_from_numpy(tree, device)
    init_wkv = None
    if meta.get("init_wkv") is not None:
        init_wkv = _from_skeleton(meta["init_wkv"], tensors).float().numpy()
    mi = meta["info"]
    info = ModelInfo(version=ModelVersion(mi["version"]),
                     num_layer=mi["num_layer"], num_emb=mi["num_emb"],
                     num_hidden=mi["num_hidden"], num_vocab=mi["num_vocab"],
                     num_head=mi["num_head"], head_size=mi["head_size"])
    return LoadedModel(info=info, params=params, init_wkv=init_wkv)
