"""RWKV v6 ("Finch") forward pass in PyTorch.

Port of ``ai00_server_tpu/models/v6.py`` (``init_state``, ``_att``,
``_channel_mix`` - here ``common.gated_channel_mix`` -, ``_layer``,
``forward``).  ``forward`` at T=1 takes the fused decode path
(``ops/v6_decode.forward_t1``, which updates the state in place) when the
engine has installed its layout on the params, or on a batch above 8 the
phased one (``ops/v56_phased.forward_t1``) where its ``can_phase`` holds
(plain, int8 or int4 weights).  Otherwise it runs the layer-by-layer path: a plain Python loop over layers, with the
WKV recurrence in the hand-written CUDA kernels — ``ops/wkv_t1.wkv56_t1``
for T=1 decode and ``ops/wkv_chunk.wkv56_chunk`` for T>1 prefill chunks
(their plain versions on CPU tensors) — and returns a new state.

v6 upgrades v5 with a data-dependent token shift (five low-rank offsets)
and a data-dependent per-token decay:

    dx   = x_prev - x
    xxx  = x + dx * mix_x
    m_f  = tanh(xxx @ w1)[f-th stage] @ w2[f]        (f = w, k, v, r, g)
    x_f  = x + dx * (mix_f + m_f)
    w_t  = exp(-exp(decay + tanh(x_w @ dw1) @ dw2))

then the v5 recurrence on a per-head state ``S`` of shape ``(N_k, N_v)``
with the bonus ``u`` (``first``), GroupNorm(eps=64e-5), a SiLU gate and a
receptance-gated squared-ReLU channel mix.  The JAX package's rounding
points are kept.
"""

from __future__ import annotations

import torch

from ..ops import v6_decode as fd
from ..ops import v56_phased as pd
from ..ops.wkv_chunk import wkv56_chunk
from ..ops.wkv_t1 import wkv56_t1
from .common import (GN_EPS, acc_dtype, gated_channel_mix, group_norm,
                     layer_norm, length_mask, linear, token_shift,
                     update_shift_state)


def init_state(info, batch: int, dtype=torch.float32, device="cpu"):
    L, C = info.num_layer, info.num_emb
    H, N = info.num_head, info.head_size
    return {
        "att_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
        "wkv": torch.zeros((L, batch, H, N, N), dtype=dtype,  # (k, v)
                           device=device),
        "ffn_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
    }


def _att(p, att_x, wkv, x, lengths):
    """v6 time mix over one chunk.  x: (B, T, C).  Returns (out,
    new_att_x, new_wkv)."""
    B, T, C = x.shape
    H, N = p["first"].shape
    acc = acc_dtype(x.dtype)

    xp = token_shift(att_x, x)
    dx = xp - x

    # Low-rank data-dependent shift offsets: 5 stages packed in w1/w2.
    xxx = x + dx * p["mix_x"]
    D = p["mix_w1"].shape[1] // 5
    h = torch.tanh(torch.matmul(xxx.to(acc), p["mix_w1"].to(x.dtype).to(acc))
                   ).to(x.dtype)
    m = torch.einsum("btfd,fdc->btfc", h.reshape(B, T, 5, D).to(acc),
                     p["mix_w2"].to(x.dtype).to(acc)).to(x.dtype)
    mw, mk, mv, mr, mg = (m[:, :, i] for i in range(5))

    xw = x + dx * (p["mix_w"] + mw)
    xk = x + dx * (p["mix_k"] + mk)
    xv = x + dx * (p["mix_v"] + mv)
    xr = x + dx * (p["mix_r"] + mr)
    xg = x + dx * (p["mix_g"] + mg)

    r = linear(xr, p["receptance"]).reshape(B, T, H, N)
    k = linear(xk, p["key"]).reshape(B, T, H, N)
    v = linear(xv, p["value"]).reshape(B, T, H, N)
    g = linear(xg, p["gate"])
    g = g * torch.sigmoid(g.to(acc)).to(x.dtype)  # SiLU

    dw = torch.tanh(torch.matmul(xw.to(acc),
                                 p["decay_w1"].to(x.dtype).to(acc))
                    ).to(x.dtype)
    ww = p["decay"].to(acc) + torch.matmul(
        dw.to(acc), p["decay_w2"].to(x.dtype).to(acc))
    w = torch.exp(-torch.exp(ww)).reshape(B, T, H, N)
    u = p["first"]

    mask = length_mask(lengths, T)
    if T == 1:
        new_wkv, yt = wkv56_t1(wkv, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                               mask[:, 0])
        y = yt[:, None]
    else:
        new_wkv, y = wkv56_chunk(wkv, r, k, v, w, u, mask)

    y = y.reshape(B, T, C).to(x.dtype)
    y = group_norm(y, H, p["ln_x_w"], p["ln_x_b"], GN_EPS)
    out = linear(y * g, p["output"])
    return (out, update_shift_state(att_x, x, lengths),
            new_wkv.to(wkv.dtype))


def _layer(p, state, x, lengths):
    att_x, wkv, ffn_x = state
    xa = layer_norm(x, p["ln1_w"], p["ln1_b"])
    att_out, new_att_x, new_wkv = _att(p["att"], att_x, wkv, xa, lengths)
    x = x + att_out
    xf = layer_norm(x, p["ln2_w"], p["ln2_b"])
    ffn_out, new_ffn_x = gated_channel_mix(p["ffn"], ffn_x, xf, lengths,
                                           p["ffn"]["mix_k"],
                                           p["ffn"]["mix_r"])
    x = x + ffn_out
    return x, (new_att_x, new_wkv, new_ffn_x)


def forward(params, state, tokens, lengths):
    """Forward a chunk of tokens.

    tokens: (B, T) int; lengths: (B,) — number of valid tokens per row
    (suffix padding).  Returns (hidden (B, T, C) post-ln_out, new_state);
    on the fused T=1 path ``new_state`` is ``state`` itself, updated in
    place.
    """
    if tokens.shape[1] == 1 and fd.supports(params):
        if pd.can_phase(params, tokens.shape[0], "V6"):
            return pd.forward_t1(params, state, tokens, lengths)
        return fd.forward_t1(params, state, tokens, lengths)
    x = params["emb"][tokens.long()]  # ln0 folded into emb at load
    new = {"att_x": [], "wkv": [], "ffn_x": []}
    for i, p in enumerate(params["layers"]):
        x, (att_x, wkv, ffn_x) = _layer(
            p, (state["att_x"][i], state["wkv"][i], state["ffn_x"][i]),
            x, lengths)
        new["att_x"].append(att_x)
        new["wkv"].append(wkv)
        new["ffn_x"].append(ffn_x)
    new_state = {k: torch.stack(v) for k, v in new.items()}
    hidden = layer_norm(x, params["ln_out_w"], params["ln_out_b"])
    return hidden, new_state
