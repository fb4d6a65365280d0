"""RWKV v7 ("Goose") forward pass in PyTorch.

Port of ``ai00_server_tpu/models/v7.py`` (``init_state``, ``_att``,
``_layer``, ``forward``).  ``forward`` at T=1 takes the fused decode path
(``ops/v7_decode.forward_t1``, which updates the state in place) when the
engine has installed its layout on the params, or on a batch above 8 the
phased one (``ops/v7_phased.forward_t1``) where its ``can_phase`` holds
(plain, int8 or int4 weights).  Otherwise it runs the
layer-by-layer path: a plain Python loop over layers, with the WKV
recurrence in the hand-written CUDA kernels — ``ops/wkv_t1`` for T=1 decode
and ``ops/wkv_chunk`` for T>1 prefill chunks (their plain versions on CPU
tensors) — and returns a new state.

time-mix (per head, state ``S`` of shape ``(N_v, N_k)``):

    S_t = S_{t-1} diag(w_t) - (S_{t-1} kk_t)(kk_t * a_t)^T + v_t k_t^T
    y_t = S_t r_t

with ``w = exp(-exp(-0.5) sigmoid(w0 + lora_w(x)))`` kept in f32, the
removal key ``kk`` L2-normalised in f32 and cast to the activation dtype,
the layer-0 value residual ``v_first``, GroupNorm(eps=64e-5) and the bonus
``(r.k * r_k) v``.
"""

from __future__ import annotations

import torch

from ..ops import v7_decode as fd
from ..ops import v7_phased as pd
from ..ops.wkv_chunk import wkv7_chunk
from ..ops.wkv_t1 import wkv7_t1
from .common import (GN_EPS, acc_dtype, channel_mix_v7, group_norm,
                     layer_norm, length_mask, linear, lora_mix, token_shift,
                     update_shift_state)

W_SCALE = 0.6065306597126334  # exp(-0.5)


def init_state(info, batch: int, dtype=torch.float32, device="cpu"):
    L, C = info.num_layer, info.num_emb
    H, N = info.num_head, info.head_size
    return {
        "att_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, N, N), dtype=dtype, device=device),
        "ffn_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
    }


def _att(p, att_x, wkv, x, v_first, layer_idx: int, lengths):
    """v7 time mix over one chunk.

    x: (B, T, C).  Returns (out, new_att_x, new_wkv, v_first).
    """
    B, T, C = x.shape
    H = p["r_k"].shape[0]
    N = C // H
    acc = acc_dtype(x.dtype)

    xp = token_shift(att_x, x)
    dx = xp - x
    xr = x + dx * p["x_r"]
    xw = x + dx * p["x_w"]
    xk = x + dx * p["x_k"]
    xv = x + dx * p["x_v"]
    xa = x + dx * p["x_a"]
    xg = x + dx * p["x_g"]

    r = linear(xr, p["receptance"])
    k = linear(xk, p["key"])
    v = linear(xv, p["value"])

    w_lora = lora_mix(xw, p["w1"], p["w2"], torch.tanh)
    w = torch.exp(-W_SCALE * torch.sigmoid((p["w0"] + w_lora).to(acc)))

    a = torch.sigmoid(
        (p["a0"] + lora_mix(xa, p["a1"], p["a2"], lambda h: h)).to(acc)
    ).to(x.dtype)
    g = lora_mix(xg, p["g1"], p["g2"], torch.sigmoid)

    # Removal key: per-head L2-normalised k * k_k.
    kk = (k * p["k_k"]).reshape(B, T, H, N).to(acc)
    kk = kk / torch.clamp(torch.linalg.vector_norm(kk, dim=-1, keepdim=True),
                          min=1e-12)
    kk = kk.to(x.dtype)

    k = k * (1.0 + (a - 1.0) * p["k_a"])

    # Value residual from layer 0.
    if layer_idx == 0:
        v_first = v
    else:
        v_mix = torch.sigmoid(
            (p["v0"] + lora_mix(xv, p["v1"], p["v2"], lambda h: h)).to(acc)
        ).to(x.dtype)
        v = v + (v_first - v) * v_mix

    rh = r.reshape(B, T, H, N)
    kh = k.reshape(B, T, H, N)
    vh = v.reshape(B, T, H, N)
    wh = w.reshape(B, T, H, N)
    ah = a.reshape(B, T, H, N)
    mask = length_mask(lengths, T)
    if T == 1:
        new_wkv, yt = wkv7_t1(wkv, rh[:, 0], wh[:, 0], kh[:, 0], vh[:, 0],
                              kk[:, 0], ah[:, 0], mask[:, 0])
        y = yt[:, None]
    else:
        new_wkv, y = wkv7_chunk(wkv, rh, wh, kh, vh, kk, ah, mask)

    y = y.reshape(B, T, C).to(x.dtype)
    y = group_norm(y, H, p["ln_x_w"], p["ln_x_b"], GN_EPS)
    bonus = torch.sum(rh * kh * p["r_k"], dim=-1, keepdim=True) * vh
    y = y + bonus.reshape(B, T, C).to(x.dtype)

    out = linear(y * g.to(x.dtype), p["output"])
    new_att_x = update_shift_state(att_x, x, lengths)
    return out, new_att_x, new_wkv.to(wkv.dtype), v_first


def _layer(p, state, x, v_first, layer_idx: int, lengths):
    att_x, wkv, ffn_x = state
    xa = layer_norm(x, p["ln1_w"], p["ln1_b"])
    att_out, new_att_x, new_wkv, v_first = _att(
        p["att"], att_x, wkv, xa, v_first, layer_idx, lengths)
    x = x + att_out
    xf = layer_norm(x, p["ln2_w"], p["ln2_b"])
    ffn_out, new_ffn_x = channel_mix_v7(p["ffn"], ffn_x, xf, lengths)
    x = x + ffn_out
    return x, v_first, (new_att_x, new_wkv, new_ffn_x)


def forward(params, state, tokens, lengths):
    """Forward a chunk of tokens.

    tokens: (B, T) int; lengths: (B,) — number of valid tokens per row
    (suffix padding).  Returns (hidden (B, T, C) post-ln_out, new_state);
    on the fused T=1 path ``new_state`` is ``state`` itself, updated in
    place.
    """
    if tokens.shape[1] == 1 and fd.supports(params):
        if pd.can_phase(params, tokens.shape[0]):
            return pd.forward_t1(params, state, tokens, lengths)
        return fd.forward_t1(params, state, tokens, lengths)
    x = params["emb"][tokens.long()]  # ln0 folded into emb at load
    v_first = torch.zeros_like(x)
    new = {"att_x": [], "wkv": [], "ffn_x": []}
    for i, p in enumerate(params["layers"]):
        x, v_first, (att_x, wkv, ffn_x) = _layer(
            p, (state["att_x"][i], state["wkv"][i], state["ffn_x"][i]),
            x, v_first, i, lengths)
        new["att_x"].append(att_x)
        new["wkv"].append(wkv)
        new["ffn_x"].append(ffn_x)
    new_state = {k: torch.stack(v) for k, v in new.items()}
    hidden = layer_norm(x, params["ln_out_w"], params["ln_out_b"])
    return hidden, new_state
