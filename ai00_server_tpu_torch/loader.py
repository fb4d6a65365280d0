"""Checkpoint loading: converted safetensors -> math-layout weights -> params.

Port of ``ai00_server_tpu/loader.py`` (``load_safetensors``,
``save_safetensors``, ``to_math_layout``, ``load_model``, ``stack_params``
at its lines 78-193 and 264-380) for plain bf16/f32 RWKV-7 checkpoints.

The numpy half (reading the file, undoing the converter's orientation) is
this package's own copy.  The params are PyTorch tensors on one device:

    {"emb": (V, C), "layers": [per-layer dict] * L,
     "ln_out_w": (C,), "ln_out_b": (C,), "head": (C, V)}

with every linear weight in math orientation ``(in, out)`` (``x @ W``), ln0
folded into the embedding and zero ``v0/v1/v2`` for layer 0 — the same
values the JAX package stacks, one dict per layer instead of ``lax.scan``
layer groups.  :func:`params_from_numpy` carries the JAX package's loaded
params (as numpy arrays) across into that form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .models.info import ModelInfo, ModelVersion, detect_info

# Keys (substring match, per the reference converter) that the converter
# stores transposed relative to the torch parameter.
CONVERT_TRANSPOSED = (
    "time_mix_w1", "time_mix_w2", "time_decay_w1", "time_decay_w2",
    ".att.w1", ".att.w2", ".att.a1", ".att.a2", ".att.g1", ".att.g2",
    ".att.v1", ".att.v2", "time_state", "lora.0",
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


@dataclass
class LoadedModel:
    info: ModelInfo
    params: dict


def load_model(path: str, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> LoadedModel:
    """Read a converted ``.st`` RWKV-7 checkpoint onto ``device``."""
    if not path.endswith(".st"):
        raise NotImplementedError(
            f"{path!r}: this port loads converted .st checkpoints only; "
            ".pth conversion and prefabs are ROADMAP queue 1 items")
    raw = load_safetensors(path)
    info = detect_info({k: v.shape for k, v in raw.items()})
    if "blocks.0.att.time_state" in raw:
        raise NotImplementedError(
            "state-tuned checkpoints (embedded time_state) are the ROADMAP "
            "'.state files, LoRA and prefab' item")
    params = stack_params(info, to_math_layout(raw), dtype=dtype,
                          device=device)
    return LoadedModel(info=info, params=params)


def _v7_only(info: ModelInfo) -> None:
    if info.version != ModelVersion.V7:
        raise NotImplementedError(
            f"RWKV {info.version.value} is the ROADMAP 'v6/v5/v4' item; "
            "this port serves V7")


def stack_params(info: ModelInfo, math: dict[str, np.ndarray],
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda") -> dict:
    """Math-layout v7 weights -> the forward params (one dict per layer)."""
    _v7_only(info)
    C, L = info.num_emb, info.num_layer

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
        a = b + "att."
        f = b + "ffn."
        att = {k: math[a + k] for k in V7_ATT_VECTORS}
        if a + "v0" in math:
            att.update({k: math[a + k] for k in ("v0", "v1", "v2")})
        else:  # layer 0 has no value residual
            D = att["a1"].shape[-1]
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
        layers.append({
            "ln1_w": t(math[b + "ln1.weight"]),
            "ln1_b": t(math[b + "ln1.bias"]),
            "ln2_w": t(math[b + "ln2.weight"]),
            "ln2_b": t(math[b + "ln2.bias"]),
            "att": {k: t(v) for k, v in att.items()},
            "ffn": {"x_k": t(math[f + "x_k"]),
                    "key": t(math[f + "key.weight"]),
                    "value": t(math[f + "value.weight"])},
        })
    return {
        "emb": t(emb),
        "layers": layers,
        "ln_out_w": t(math["ln_out.weight"]),
        "ln_out_b": t(math["ln_out.bias"]),
        "head": t(math["head.weight"]),
    }


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.array(x, order="C")  # a writable copy the tensor may own
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The JAX package's loaded v7 params, as numpy arrays
    (``jax.tree.map(np.asarray, model.params)``) -> this port's params on
    ``device``, dtypes kept.  Layer groups are unstacked into one dict per
    layer; derived ``_``-prefixed keys (the JAX fused-decode layout) are
    dropped."""
    layers = []
    for group in tree["groups"]:
        K = int(np.asarray(group["layer_index"]).shape[0])

        def take(node, i):
            if isinstance(node, dict):
                return {k: take(v, i) for k, v in node.items()}
            if not isinstance(node, np.ndarray):
                raise NotImplementedError(
                    f"{type(node).__name__} leaf: quantized layers are the "
                    "ROADMAP int8/4-bit items")
            return _tensor(node[i], device)

        layers.extend(take(group["layers"], i) for i in range(K))
    return {
        "emb": _tensor(tree["emb"], device),
        "layers": layers,
        "ln_out_w": _tensor(tree["ln_out_w"], device),
        "ln_out_b": _tensor(tree["ln_out_b"], device),
        "head": _tensor(tree["head"], device),
    }
