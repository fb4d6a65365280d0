"""Random RWKV-7, -6, -5 and -4 weights in the math layout, from a seed.

Port of ``ai00_server_tpu/testing.py:14-161`` (``tiny_info``,
``make_raw_weights``, ``make_params``), with the LoRA ranks as
arguments so a caller can build the published widths (RWKV-7 World 0.4B:
w 64, a 64, v 32, g 128; RWKV-6 World 1B6: token-shift ``tm`` 32, decay
``td`` 64).  For a given ``(info, seed, dtype)`` and the default ranks the
arrays equal the JAX package's — the draws come in its order — so tests can
feed one weight dict to both packages.
"""

from __future__ import annotations

import numpy as np

from .models import ModelInfo, ModelVersion

LORA_DIMS = {"w": 8, "a": 8, "v": 8, "g": 8, "tm": 8, "td": 8}


def tiny_info(version: ModelVersion = ModelVersion.V7, num_layer=3,
              num_emb=32, head_size=16, num_vocab=64,
              hidden_mult=4) -> ModelInfo:
    if version == ModelVersion.V4:  # one scalar WKV per channel
        num_head, head_size = num_emb, 1
    else:
        num_head = num_emb // head_size
    return ModelInfo(
        version=version,
        num_layer=num_layer,
        num_emb=num_emb,
        num_hidden=num_emb * hidden_mult,
        num_vocab=num_vocab,
        num_head=num_head,
        head_size=head_size,
    )


def make_raw_weights(info: ModelInfo, seed=0, dtype=np.float64,
                     lora_dims: dict | None = None) -> dict[str, np.ndarray]:
    """Random weights keyed like a converted checkpoint, oriented like the
    math layout (every linear ``(in, out)``)."""
    ver = info.version
    rng = np.random.default_rng(seed)
    D = {**LORA_DIMS, **(lora_dims or {})}
    C, V, F, L = info.num_emb, info.num_vocab, info.num_hidden, info.num_layer
    H, N = info.num_head, info.head_size

    def rand(*shape, scale=0.4):
        if dtype == np.float32:
            return rng.standard_normal(shape, dtype=np.float32) * scale
        return rng.standard_normal(shape).astype(np.float64) * scale

    w = {
        "emb.weight": rand(V, C),
        "blocks.0.ln0.weight": 1.0 + rand(C, scale=0.1),
        "blocks.0.ln0.bias": rand(C, scale=0.1),
        "ln_out.weight": 1.0 + rand(C, scale=0.1),
        "ln_out.bias": rand(C, scale=0.1),
        "head.weight": rand(C, V),
    }
    for i in range(L):
        b = f"blocks.{i}."
        w[b + "ln1.weight"] = 1.0 + rand(C, scale=0.1)
        w[b + "ln1.bias"] = rand(C, scale=0.1)
        w[b + "ln2.weight"] = 1.0 + rand(C, scale=0.1)
        w[b + "ln2.bias"] = rand(C, scale=0.1)

        a = b + "att."
        w[a + "receptance.weight"] = rand(C, C)
        w[a + "key.weight"] = rand(C, C)
        w[a + "value.weight"] = rand(C, C)
        w[a + "output.weight"] = rand(C, C)
        if ver == ModelVersion.V7:
            for nm in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g"):
                w[a + nm] = rand(C, scale=0.3)
            w[a + "w0"] = rand(C, scale=0.5)
            w[a + "w1"] = rand(C, D["w"])
            w[a + "w2"] = rand(D["w"], C)
            w[a + "a0"] = rand(C, scale=0.3)
            w[a + "a1"] = rand(C, D["a"])
            w[a + "a2"] = rand(D["a"], C)
            if i > 0:
                w[a + "v0"] = rand(C, scale=0.3)
                w[a + "v1"] = rand(C, D["v"])
                w[a + "v2"] = rand(D["v"], C)
            w[a + "g1"] = rand(C, D["g"])
            w[a + "g2"] = rand(D["g"], C)
            w[a + "k_k"] = 0.5 + rand(C, scale=0.2)
            w[a + "k_a"] = 0.5 + rand(C, scale=0.2)
            w[a + "r_k"] = rand(H, N, scale=0.3)
        elif ver == ModelVersion.V6:
            w[a + "time_mix_x"] = rand(C, scale=0.3)
            for nm in ("time_mix_w", "time_mix_k", "time_mix_v",
                       "time_mix_r", "time_mix_g"):
                w[a + nm] = rand(C, scale=0.3)
            w[a + "time_mix_w1"] = rand(C, 5 * D["tm"])
            w[a + "time_mix_w2"] = rand(5, D["tm"], C)
            w[a + "time_decay"] = rand(C, scale=0.5)
            w[a + "time_decay_w1"] = rand(C, D["td"])
            w[a + "time_decay_w2"] = rand(D["td"], C)
            w[a + "time_first"] = rand(H, N, scale=0.5)
            w[a + "gate.weight"] = rand(C, C)
        elif ver == ModelVersion.V5:
            for nm in ("time_mix_k", "time_mix_v", "time_mix_r",
                       "time_mix_g"):
                w[a + nm] = 0.5 + rand(C, scale=0.2)
            w[a + "time_decay"] = rand(H, N, scale=0.5)
            w[a + "time_first"] = rand(H, N, scale=0.5)
            w[a + "gate.weight"] = rand(C, C)
        else:  # V4: no heads, no GroupNorm
            for nm in ("time_mix_k", "time_mix_v", "time_mix_r"):
                w[a + nm] = 0.5 + rand(C, scale=0.2)
            w[a + "time_decay"] = rand(C, scale=0.5)
            w[a + "time_first"] = rand(C, scale=0.5)
        if ver != ModelVersion.V4:
            w[a + "ln_x.weight"] = 1.0 + rand(C, scale=0.1)
            w[a + "ln_x.bias"] = rand(C, scale=0.1)

        f = b + "ffn."
        w[f + "key.weight"] = rand(C, F)
        w[f + "value.weight"] = rand(F, C)
        if ver == ModelVersion.V7:
            w[f + "x_k"] = rand(C, scale=0.3)
        elif ver == ModelVersion.V6:
            w[f + "time_mix_k"] = rand(C, scale=0.3)
            w[f + "time_mix_r"] = rand(C, scale=0.3)
            w[f + "receptance.weight"] = rand(C, C)
        else:
            w[f + "time_mix_k"] = 0.5 + rand(C, scale=0.2)
            w[f + "time_mix_r"] = 0.5 + rand(C, scale=0.2)
            w[f + "receptance.weight"] = rand(C, C)
    return w


def make_params(info: ModelInfo, raw: dict[str, np.ndarray], dtype=None,
                quant: dict | None = None, device="cpu") -> dict:
    """Raw math-oriented weights -> the forward params: a thin wrapper over
    ``loader.stack_params``, so fixtures and the loader share one path.
    ``quant``: {layer_index: "int8" | "nf4" | "sf4" | "int4"}.  For equal
    seeds the codes, scales and
    plain weights equal the JAX package's ``testing.make_params``."""
    import torch

    from .loader import stack_params

    return stack_params(info, raw, dtype=dtype or torch.float32,
                        device=device, quant=quant)


def to_converted_layout(math: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Inverse of ``loader.to_math_layout``: store like the reference
    converter (torch ``(out, in)`` linears, transposed low-rank tables), so
    the arrays can be written as a ``.st`` file the loader reads back."""
    from .loader import _is_convert_transposed

    out = {}
    for k, v in math.items():
        if _is_convert_transposed(k) and v.ndim >= 2:
            v = np.swapaxes(v, -1, -2)
        elif k.endswith(".weight") and v.ndim == 2 and k != "emb.weight":
            v = v.T
        out[k] = np.ascontiguousarray(v)
    return out
