"""Checkpoint loading: converted safetensors or raw ``.pth`` -> math-layout
weights -> params.

Port of ``ai00_server_tpu/loader.py`` (``load_safetensors``,
``save_safetensors``, ``convert_pth``, ``read_checkpoint``,
``to_math_layout``, ``apply_lora``, ``extract_time_state``, ``load_model``
and ``stack_params``) for RWKV-7, -6, -5 and -4 checkpoints, plain bf16/f32
or with the first N layers quantized (``quant={i: "int8" | "nf4" | "sf4" |
"int4"}``), with LoRA deltas blended in before quantization and the
embedded initial state of a state-tuned checkpoint kept as
``LoadedModel.init_wkv``.

The numpy half (reading the file, undoing the converter's orientation) is
this package's own copy.  The params are PyTorch tensors on one device:

    {"emb": (V, C), "layers": [per-layer dict] * L,
     "ln_out_w": (C,), "ln_out_b": (C,), "head": (C, V)}

with every linear weight in math orientation ``(in, out)`` (``x @ W``), ln0
folded into the embedding, zero ``v0/v1/v2`` for a v7 layer 0, the v6 keys
of the JAX package (``mix_*``, ``mix_w1`` (C, 5D), ``mix_w2`` (5, D, C),
``decay`` (C,), ``first`` (H, N), ...) and its v5 / v4 keys (``time_mix_*``,
``time_decay`` and ``time_first`` (H, N) for v5, (C,) for v4) — the same
values the JAX package stacks, one dict per layer instead of ``lax.scan``
layer groups.  The big projections of a quantized layer are
``ops.quant.QuantizedLayerView``: an index into the codes of its layer
group (a contiguous run of layers of one mode, the reference's group
boundaries), which stay in one stacked tensor on the device.
:func:`params_from_numpy` carries the JAX package's loaded params (as numpy
arrays), or a prefab's tree (``prefab.py``), across into that form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .models.info import ModelInfo, ModelVersion, detect_info
from .ops import quant as quant_ops

# Keys (substring match, per the reference converter) that the converter
# stores transposed relative to the torch parameter.
CONVERT_TRANSPOSED = (
    "time_mix_w1", "time_mix_w2", "time_decay_w1", "time_decay_w2",
    ".att.w1", ".att.w2", ".att.a1", ".att.a2", ".att.g1", ".att.g2",
    ".att.v1", ".att.v2", "time_state", "lora.0",
)

RENAME = (
    ("time_faaaa", "time_first"),
    ("time_maa", "time_mix"),
    ("lora_A", "lora.0"),
    ("lora_B", "lora.1"),
)

V7_ATT_VECTORS = ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "w0", "w1", "w2",
                  "a0", "a1", "a2", "g1", "g2", "k_k", "k_a", "r_k")


def _is_convert_transposed(key: str) -> bool:
    return any(t in key for t in CONVERT_TRANSPOSED)


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a safetensors file into float32 numpy arrays (bf16/f16 upcast)."""
    from safetensors import safe_open

    out = {}
    with safe_open(path, framework="numpy") as f:
        for key in f.keys():
            t = f.get_tensor(key)
            if t.dtype == np.float16 or str(t.dtype) == "bfloat16":
                t = t.astype(np.float32)
            out[key] = t
    return out


def save_safetensors(tensors: dict[str, np.ndarray], path: str,
                     dtype=np.float16) -> None:
    from safetensors.numpy import save_file

    cast = {
        k: np.ascontiguousarray(
            v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v)
        for k, v in tensors.items()
    }
    save_file(cast, path, metadata={"format": "pt"})


def _pth_version(loaded) -> float:
    """The reference converter's version sniffing of a raw state dict."""
    version = 4.0
    for x in loaded:
        if "ln_x" in x:
            version = max(5.0, version)
        if "gate.weight" in x:
            version = max(5.1, version)
        if int(version) == 5 and "att.time_decay" in x:
            if loaded[x].dim() > 1 and loaded[x].shape[1] > 1:
                version = max(5.2, version)
        if "time_maa" in x:
            version = max(6.0, version)
        if ".att.w0" in x or "att.r_k" in x:
            version = max(7.0, version)
    return version


def _converted_key(k: str) -> str:
    for a, b in RENAME:
        k = k.replace(a, b)
    return k.lower()


def _load_pth(path: str, mmap: bool = False) -> dict:
    loaded = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=mmap)
    return loaded["state_dict"] if "state_dict" in loaded else loaded


def convert_pth(path: str) -> dict[str, np.ndarray]:
    """A raw RWKV ``.pth`` / ``.pt`` in the converted-key layout, in memory
    (the reference converter's semantics): version sniffing, the v5.1
    repeat of ``time_decay`` / ``time_faaaa`` over each head's channels,
    the rename table, lowercased keys and the converter's transposes."""
    loaded = _load_pth(path)
    keys = list(loaded.keys())
    version = _pth_version(loaded)

    if version == 5.1:
        _, n_emb = loaded["emb.weight"].shape
        for k in keys:
            if "time_decay" in k or "time_faaaa" in k:
                loaded[k] = loaded[k].unsqueeze(1).repeat(
                    1, n_emb // loaded[k].shape[0])

    out = {}
    for k in keys:
        new_k = _converted_key(k)
        v = loaded[k].float()
        if _is_convert_transposed(new_k) and v.dim() >= 2:
            v = v.transpose(v.dim() - 2, v.dim() - 1)
        out[new_k] = np.ascontiguousarray(v.numpy())
    return out


def read_info(path: str) -> ModelInfo:
    """The ModelInfo of a converted ``.st``, a raw ``.pth`` / ``.pt`` or a
    prefab from its header and shapes alone, without reading the weights
    (``Middleware.reload`` checks a model's head size on a card before it
    unloads the model in service)."""
    if path.endswith(".prefab"):
        from .prefab import read_prefab_info

        return read_prefab_info(path)
    if path.endswith(".pth") or path.endswith(".pt"):
        loaded = _load_pth(path, mmap=True)
        version = _pth_version(loaded)
        n_emb = loaded["emb.weight"].shape[1]
        shapes = {}
        for k, v in loaded.items():
            shape = tuple(v.shape)
            if version == 5.1 and ("time_decay" in k or "time_faaaa" in k):
                shape = (shape[0], n_emb // shape[0])
            new_k = _converted_key(k)
            if _is_convert_transposed(new_k) and len(shape) >= 2:
                shape = (*shape[:-2], shape[-1], shape[-2])
            shapes[new_k] = shape
        return detect_info(shapes)
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as f:
        return detect_info({k: tuple(f.get_slice(k).get_shape())
                            for k in f.keys()})


def read_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Read a converted ``.st`` (safetensors) or a raw ``.pth`` / ``.pt``
    checkpoint as float32 arrays in the converted-key layout."""
    if path.endswith(".pth") or path.endswith(".pt"):
        return convert_pth(path)
    return load_safetensors(path)


def to_math_layout(raw: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Converted-file layout -> math layout.

    * ``*.weight`` 2-D tensors (torch ``(out, in)``) -> ``(in, out)``.
    * Converter-transposed low-rank weights -> back to the torch parameter
      orientation, which for these is already the math orientation.
    * ``(1, 1, C)``-shaped modulation vectors -> ``(C,)``.
    """
    out = {}
    for k, v in raw.items():
        if _is_convert_transposed(k) and v.ndim >= 2:
            v = np.swapaxes(v, -1, -2)
        elif k.endswith(".weight") and v.ndim == 2 and k != "emb.weight":
            v = v.T
        v = np.ascontiguousarray(np.squeeze(v)) if v.ndim == 3 and v.shape[0] == 1 else v
        if v.ndim == 2 and 1 in v.shape and not k.endswith(".weight") \
                and "w1" not in k and "w2" not in k and "time_first" not in k \
                and "time_decay" not in k and "r_k" not in k and "time_state" not in k:
            v = v.reshape(-1)
        out[k] = np.ascontiguousarray(v)
    return out


def apply_lora(math: dict[str, np.ndarray], lora_raw: dict[str, np.ndarray],
               alpha: float) -> None:
    """Blend LoRA deltas into math-layout weights in place.

    A converted LoRA file carries ``<name>.weight.lora.0`` (torch
    ``lora_A`` ``(rank, in)``, stored transposed by the converter) and
    ``<name>.weight.lora.1`` (torch ``lora_B`` ``(out, rank)``).  The torch
    delta ``B @ A`` is ``A^T @ B^T`` in math layout: ``W += alpha / rank *
    A^T @ B^T``, in f32 (the reference's full blend).  It runs before
    quantization, so a blended layer is quantized once, from its blended
    weights."""
    lora = to_math_layout(lora_raw)  # lora.0 back to torch (rank, in)
    pairs = {}
    for k in lora:
        if k.endswith(".lora.0"):
            base = k[: -len(".lora.0")]
            if base + ".lora.1" in lora:
                pairs[base] = (lora[k], lora[base + ".lora.1"])
    for base, (a, b) in pairs.items():
        if base not in math:
            continue
        rank = a.shape[0]
        delta = (a.T @ b.T) * (alpha / rank)
        math[base] = (math[base].astype(np.float32) + delta).astype(
            math[base].dtype)


def extract_time_state(raw: dict[str, np.ndarray], info: ModelInfo):
    """The embedded initial state of a state-tuned checkpoint: per layer
    ``blocks.N.att.time_state`` (stored transposed by the converter) as
    ``(L, H, N, N)`` in ``(k, v)`` orientation, or None.  The engine
    transposes it for v7, whose state is ``(v, k)``."""
    states = []
    for i in range(info.num_layer):
        k = f"blocks.{i}.att.time_state"
        if k not in raw:
            return None
        v = raw[k]
        if _is_convert_transposed(k):
            v = np.swapaxes(v, -1, -2)
        states.append(v.reshape(info.num_head, info.head_size,
                                info.head_size))
    return np.stack(states).astype(np.float32)


@dataclass
class LoadedModel:
    info: ModelInfo
    params: dict
    # The embedded time_state of a state-tuned checkpoint, (L, H, N, N) f32
    # in (k, v) orientation, or None.
    init_wkv: np.ndarray | None = None
    # Host originals of top-level params the engine replaced by a derived
    # ("_"-prefixed) device form: the lossless LM head of a model whose
    # logits run through "_head_q".  A prefab export writes them back.
    host_params: dict | None = None


def load_model(path: str, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda",
               quant: dict | None = None,
               loras: list[tuple[str, float]] | None = None) -> LoadedModel:
    """Read an RWKV checkpoint (converted ``.st``, or raw ``.pth`` / ``.pt``)
    onto ``device``: read -> math layout -> LoRA -> quantize and stack.

    ``quant``: {layer_index: "int8" | "nf4" | "sf4" | "int4"} per-layer
    quantization map.  ``loras``: ``(path, alpha)`` pairs blended into the
    f32 weights before quantization.  A state-tuned checkpoint's
    ``time_state`` becomes ``init_wkv``."""
    raw = read_checkpoint(path)
    info = detect_info({k: v.shape for k, v in raw.items()})
    math = to_math_layout(raw)
    for lora_path, alpha in loras or []:
        apply_lora(math, read_checkpoint(lora_path), alpha)
    params = stack_params(info, math, dtype=dtype, device=device,
                          quant=quant)
    return LoadedModel(info=info, params=params,
                       init_wkv=extract_time_state(raw, info))


def _mode_runs(modes: list[str]) -> list[tuple[int, int]]:
    """Contiguous runs of equal modes as (first layer, size)."""
    runs, start = [], 0
    for i in range(1, len(modes) + 1):
        if i == len(modes) or modes[i] != modes[start]:
            runs.append((start, i - start))
            start = i
    return runs


def _quantize_runs(layers: list[dict], modes: list[str], device) -> None:
    """Replace the big projections (numpy, still on the host) of every
    quantized run of layers by views into the run's stacked codes: the
    weights are stacked and quantized on the host, and only codes and scales
    reach the device."""
    big = (("att", quant_ops.QUANT_KEYS_ATT), ("ffn", quant_ops.QUANT_KEYS_FFN))
    for start, size in _mode_runs(modes):
        if modes[start] == "none":
            continue
        run = layers[start: start + size]
        stacked = {part: {k: np.stack([p[part][k] for p in run])
                          for k in keys if k in run[0][part]}
                   for part, keys in big}
        group = quant_ops.quantize_group(stacked, modes[start], device)
        for part, _ in big:
            for key, qlin in group[part].items():
                for i, p in enumerate(run):
                    p[part][key] = quant_ops.QuantizedLayerView(qlin, i)


def _v7_layer(math: dict, i: int, info: ModelInfo) -> dict:
    a, f = f"blocks.{i}.att.", f"blocks.{i}.ffn."
    C = info.num_emb
    att = {k: math[a + k] for k in V7_ATT_VECTORS}
    if a + "v0" in math:
        att.update({k: math[a + k] for k in ("v0", "v1", "v2")})
    else:  # layer 0 has no value residual: zeros of the others' rank
        D = next((math[f"blocks.{j}.att.v1"].shape[-1]
                  for j in range(info.num_layer)
                  if f"blocks.{j}.att.v1" in math), att["a1"].shape[-1])
        att.update({"v0": np.zeros(C, np.float32),
                    "v1": np.zeros((C, D), np.float32),
                    "v2": np.zeros((D, C), np.float32)})
    att.update({
        "receptance": math[a + "receptance.weight"],
        "key": math[a + "key.weight"],
        "value": math[a + "value.weight"],
        "output": math[a + "output.weight"],
        "ln_x_w": math[a + "ln_x.weight"],
        "ln_x_b": math[a + "ln_x.bias"],
    })
    return {"att": att,
            "ffn": {"x_k": math[f + "x_k"],
                    "key": math[f + "key.weight"],
                    "value": math[f + "value.weight"]}}


def _v6_layer(math: dict, i: int, info: ModelInfo) -> dict:
    a, f = f"blocks.{i}.att.", f"blocks.{i}.ffn."
    att = {"mix_" + k: math[a + "time_mix_" + k]
           for k in ("x", "w", "k", "v", "r", "g", "w1", "w2")}
    att.update({
        "decay": math[a + "time_decay"].reshape(-1),
        "decay_w1": math[a + "time_decay_w1"],
        "decay_w2": math[a + "time_decay_w2"],
        "first": math[a + "time_first"].reshape(info.num_head,
                                                info.head_size),
        "receptance": math[a + "receptance.weight"],
        "key": math[a + "key.weight"],
        "value": math[a + "value.weight"],
        "gate": math[a + "gate.weight"],
        "output": math[a + "output.weight"],
        "ln_x_w": math[a + "ln_x.weight"],
        "ln_x_b": math[a + "ln_x.bias"],
    })
    return {"att": att,
            "ffn": {"mix_k": math[f + "time_mix_k"],
                    "mix_r": math[f + "time_mix_r"],
                    "key": math[f + "key.weight"],
                    "receptance": math[f + "receptance.weight"],
                    "value": math[f + "value.weight"]}}


def _v54_layer(math: dict, i: int, info: ModelInfo) -> dict:
    """A v5 or v4 layer (JAX ``loader.py:398-440``): the mixes, decay and
    bonus under their checkpoint names; v5 adds the gate and ``ln_x``."""
    a, f = f"blocks.{i}.att.", f"blocks.{i}.ffn."
    v5 = info.version == ModelVersion.V5
    shape = (info.num_head, info.head_size) if v5 else (-1,)
    att = {k: math[a + k] for k in ("time_mix_k", "time_mix_v",
                                    "time_mix_r") + (("time_mix_g",) if v5
                                                     else ())}
    att.update({
        "time_decay": math[a + "time_decay"].reshape(shape),
        "time_first": math[a + "time_first"].reshape(shape),
        "receptance": math[a + "receptance.weight"],
        "key": math[a + "key.weight"],
        "value": math[a + "value.weight"],
        "output": math[a + "output.weight"],
    })
    if v5:
        att.update({"gate": math[a + "gate.weight"],
                    "ln_x_w": math[a + "ln_x.weight"],
                    "ln_x_b": math[a + "ln_x.bias"]})
    return {"att": att,
            "ffn": {"time_mix_k": math[f + "time_mix_k"],
                    "time_mix_r": math[f + "time_mix_r"],
                    "key": math[f + "key.weight"],
                    "receptance": math[f + "receptance.weight"],
                    "value": math[f + "value.weight"]}}


_LAYER = {ModelVersion.V7: _v7_layer, ModelVersion.V6: _v6_layer,
          ModelVersion.V5: _v54_layer, ModelVersion.V4: _v54_layer}


def stack_params(info: ModelInfo, math: dict[str, np.ndarray],
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 quant: dict | None = None) -> dict:
    """Math-layout weights -> the forward params (one dict per layer).

    ``quant``: {layer_index: "int8" | "nf4" | "sf4" | "int4"}; the big
    projections of those layers become codes of that mode, grouped by
    contiguous runs of one mode."""
    L = info.num_layer
    modes = [(quant or {}).get(i, "none") for i in range(L)]

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    # Fold ln0 into the embedding table (per-row layernorm, done once).
    emb = math["emb.weight"].astype(np.float64)
    mean = emb.mean(-1, keepdims=True)
    var = emb.var(-1, keepdims=True)
    emb = (emb - mean) / np.sqrt(var + 1e-5)
    emb = emb * math["blocks.0.ln0.weight"] + math["blocks.0.ln0.bias"]

    layers = []
    for i in range(L):
        b = f"blocks.{i}."
        layer = _LAYER[info.version](math, i, info)
        layers.append({
            "ln1_w": math[b + "ln1.weight"],
            "ln1_b": math[b + "ln1.bias"],
            "ln2_w": math[b + "ln2.weight"],
            "ln2_b": math[b + "ln2.bias"],
            **layer,
        })
    _quantize_runs(layers, modes, device)

    def place(node):
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        return t(node) if isinstance(node, np.ndarray) else node

    layers = [place(p) for p in layers]
    return {
        "emb": t(emb),
        "layers": layers,
        "ln_out_w": t(math["ln_out.weight"]),
        "ln_out_b": t(math["ln_out.bias"]),
        "head": t(math["head.weight"]),
    }


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, copy=True)
    x = np.array(x, order="C")  # a writable copy the tensor may own
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The JAX package's loaded params, as numpy arrays
    (``jax.tree.map(np.asarray, model.params)``), or a prefab's tree of CPU
    tensors -> this port's params on ``device``, dtypes kept.  Layer groups are unstacked into one dict per
    layer, except quantized leaves — any node with ``mode``, ``q``,
    ``scale`` and ``shape`` attributes and numpy children — whose stacked
    codes are moved once per group and viewed per layer.  The engine's int8
    LM head (``_head_q``) is carried across; the JAX fused-decode layout is
    dropped."""
    layers = []
    for group in tree["groups"]:
        K = int(np.asarray(group["layer_index"]).shape[0])
        stacked: dict[int, quant_ops.QuantizedLinear] = {}

        def take(node, i):
            if isinstance(node, dict):
                return {k: take(v, i) for k, v in node.items()}
            if _is_quantized_node(node):
                if id(node) not in stacked:
                    stacked[id(node)] = _quantized(node, device)
                return quant_ops.QuantizedLayerView(stacked[id(node)], i)
            if not isinstance(node, (np.ndarray, torch.Tensor)):
                raise TypeError(f"unsupported {type(node).__name__} leaf")
            return _tensor(node[i], device)

        layers.extend(take(group["layers"], i) for i in range(K))
    out = {
        "emb": _tensor(tree["emb"], device),
        "layers": layers,
        "ln_out_w": _tensor(tree["ln_out_w"], device),
        "ln_out_b": _tensor(tree["ln_out_b"], device),
    }
    if "head" in tree:
        out["head"] = _tensor(tree["head"], device)
    if "_head_q" in tree:
        out["_head_q"] = _quantized(tree["_head_q"], device)
    return out


def _is_quantized_node(node) -> bool:
    return all(hasattr(node, a) for a in ("mode", "q", "scale", "shape"))


def _quantized(node, device) -> "quant_ops.QuantizedLinear":
    return quant_ops.QuantizedLinear(
        node.mode, _tensor(node.q, device), _tensor(node.scale, device),
        node.shape)
