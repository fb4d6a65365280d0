"""Shared building blocks for the RWKV-7, -6, -5 and -4 forward passes.

Port of ``ai00_server_tpu/models/common.py``.  The JAX package's rounding
points are kept: norms and low-rank branches accumulate in f32; a plain
``linear`` accumulates in f32 and casts back to the activation dtype; a
quantized weight (``ops/quant``) brings its own ``matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
# v5/v6/v7 use GroupNorm with eps scaled by head_size_divisor**2 = 64.
GN_EPS = 64e-5


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least f32, but respect f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm(x, w, b, eps=LN_EPS):
    """LayerNorm over the last axis, computed in (at least) f32, cast back."""
    acc = acc_dtype(x.dtype)
    y = F.layer_norm(x.to(acc), (x.shape[-1],), w.to(acc), b.to(acc), eps)
    return y.to(x.dtype)


def group_norm(x, num_groups, w, b, eps=GN_EPS):
    """GroupNorm over the last axis of ``x`` (..., C), C split into groups."""
    acc = acc_dtype(x.dtype)
    shape = x.shape
    y = F.group_norm(x.to(acc).reshape(-1, shape[-1]), num_groups,
                     w.to(acc), b.to(acc), eps)
    return y.reshape(shape).to(x.dtype)


def linear(x, w):
    """``x @ w`` (``w`` is ``(in, out)``): f32 accumulation, activation-dtype
    result.  ``w`` is a plain tensor or a quantized weight from
    ``ops/quant`` (which exposes ``matmul(x)``)."""
    if not isinstance(w, torch.Tensor):
        return w.matmul(x)
    return torch.matmul(x, w.to(x.dtype))


def token_shift(shift_state, x):
    """Previous-token features: ``x_prev[:, t] = x[:, t-1]``, seeded by state.

    shift_state: (B, C) — the last token's features from the previous chunk.
    x: (B, T, C).
    """
    return torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def length_mask(lengths, T: int):
    """(B,) lengths -> (B, T) bool validity mask (suffix padding)."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def take_last_valid(x, lengths):
    """``x[b, lengths[b]-1]`` per batch row; rows with length 0 get x[b, 0].

    x: (B, T, ...) -> (B, ...)
    """
    idx = torch.clamp(lengths.long() - 1, min=0)
    idx = idx.reshape((-1,) + (1,) * (x.ndim - 1)).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx).squeeze(1)


def update_shift_state(old_shift, x, lengths):
    """New token-shift state: features of the last *valid* position.

    Rows that consumed no tokens keep their old shift state.
    """
    last = take_last_valid(x, lengths).to(old_shift.dtype)
    return torch.where((lengths > 0)[:, None], last, old_shift)


def masked_select(mask_t, new, old):
    """Gate a state update by per-batch validity at one timestep.

    mask_t: (B,) bool; new/old: (B, ...) — broadcasts the mask.
    """
    return torch.where(mask_t.reshape(mask_t.shape + (1,) * (new.ndim - 1)),
                       new, old)


def lora_mix(x, w1, w2, activation=torch.tanh):
    """Low-rank data-dependent modulation: ``act(x @ w1) @ w2``, returned in
    the f32 accumulation dtype.  Weights are ``(in, rank)`` / ``(rank, out)``.

    Both products take operands rounded to the activation dtype and sum
    in f32 (the JAX ``preferred_element_type`` contract): a bf16 x bf16
    product is exact in f32, so up-casting the operands is the same sum.
    """
    acc = acc_dtype(x.dtype)

    def up(t):
        return t.to(x.dtype).to(acc)

    h = activation(torch.matmul(x.to(acc), up(w1)))
    return torch.matmul(up(h), up(w2))


def gated_channel_mix(p, shift, x, lengths, mix_k, mix_r):
    """The receptance-gated squared-ReLU channel mix of v4, v5 and v6:
    ``xk = x + dx * mix_k``, ``xr = x + dx * mix_r`` (``dx = x_prev - x``),
    ``sigmoid(xr @ receptance) * (relu(xk @ key)^2 @ value)``.  Returns
    (out, new_shift)."""
    xp = token_shift(shift, x)
    dx = xp - x
    xk = x + dx * mix_k
    xr = x + dx * mix_r
    k = torch.square(torch.relu(linear(xk, p["key"])))
    r = torch.sigmoid(linear(xr, p["receptance"]))
    out = r * linear(k, p["value"])
    return out, update_shift_state(shift, x, lengths)


def channel_mix_v4(p, shift, x, lengths):
    """v4/v5 channel mix: the official ``x * mix + x_prev * (1 - mix)``,
    i.e. :func:`gated_channel_mix` with ``1 - time_mix_{k,r}`` (v6 stores
    its mixes in the other convention and passes them as they are)."""
    return gated_channel_mix(p, shift, x, lengths, 1.0 - p["time_mix_k"],
                             1.0 - p["time_mix_r"])


def channel_mix_v7(p, shift, x, lengths):
    """v7 channel mix: squared-ReLU FFN with no receptance gate.
    Returns (out, new_shift).  At T = 1 on a quantized layer the whole mix is
    one op on the stacked codes (``ops/ffn.ffn7_t1_l``)."""
    key, val = p["key"], p["value"]
    if x.shape[1] == 1 and hasattr(key, "qlin") and hasattr(val, "qlin"):
        from ..ops.ffn import ffn7_t1_l

        out, new_shift = ffn7_t1_l(
            x[:, 0].contiguous(), shift, p["x_k"], lengths > 0, key.qlin.q,
            key.qlin.scale, val.qlin.q, val.qlin.scale, key.idx,
            qmode=key.mode)
        return out[:, None].to(x.dtype), new_shift
    xp = token_shift(shift, x)
    xk = x + (xp - x) * p["x_k"]
    k = torch.square(torch.relu(linear(xk, p["key"])))
    out = linear(k, p["value"])
    return out, update_shift_state(shift, x, lengths)
