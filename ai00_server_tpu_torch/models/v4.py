"""RWKV v4 forward pass in PyTorch.

Port of ``ai00_server_tpu/models/v4.py`` (``PP_INIT``, ``init_state``,
``_att``, ``_layer``, ``forward``).  v4 has a scalar WKV per channel on the
numerically stable exponential accumulator ``(aa, bb, pp)`` (the recurrence
is written out in ``csrc/wkv4.cu``), a sigmoid receptance gate and no heads;
the token shift uses the convention ``x + (x_prev - x) * (1 - mix)`` and
the channel mix is ``common.channel_mix_v4``.  The recurrence runs in f32
whatever the activation dtype: ``pp`` is a running log-scale.

``forward`` at T=1 takes the fused decode path (``ops/v4_decode.forward_t1``,
which updates the state in place) when the engine has installed its layout
on the params.  Otherwise it runs the layer-by-layer path with the WKV in
``ops/wkv4.wkv4_chunk`` (its plain version on CPU tensors), at T=1 too.
"""

from __future__ import annotations

import torch

from ..ops import v4_decode as fd
from ..ops.wkv4 import wkv4_chunk
from .common import (acc_dtype, channel_mix_v4, layer_norm, length_mask,
                     linear, token_shift, update_shift_state)

# The initial ``pp``: a finite stand-in for -inf (``pp - q`` with pp = -inf
# and q = -inf would be a NaN).
PP_INIT = -1e30

STATE_KEYS = ("att_x", "aa", "bb", "pp", "ffn_x")


def init_state(info, batch: int, dtype=torch.float32, device="cpu"):
    L, C = info.num_layer, info.num_emb
    acc = acc_dtype(dtype)
    return {
        "att_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
        "aa": torch.zeros((L, batch, C), dtype=acc, device=device),
        "bb": torch.zeros((L, batch, C), dtype=acc, device=device),
        "pp": torch.full((L, batch, C), PP_INIT, dtype=acc, device=device),
        "ffn_x": torch.zeros((L, batch, C), dtype=dtype, device=device),
    }


def _att(p, att_x, aa, bb, pp, x, lengths):
    """v4 time mix over one chunk.  x: (B, T, C).  Returns (out, new_att_x,
    aa, bb, pp)."""
    T = x.shape[1]
    acc = acc_dtype(x.dtype)

    xp = token_shift(att_x, x)
    dx = xp - x
    xk = x + dx * (1.0 - p["time_mix_k"])
    xv = x + dx * (1.0 - p["time_mix_v"])
    xr = x + dx * (1.0 - p["time_mix_r"])

    r = torch.sigmoid(linear(xr, p["receptance"]).to(acc)).to(x.dtype)
    k = linear(xk, p["key"])
    v = linear(xv, p["value"])

    w = -torch.exp(p["time_decay"].to(aa.dtype))
    u = p["time_first"].to(aa.dtype)

    mask = length_mask(lengths, T)
    (aa, bb, pp), wkv = wkv4_chunk(aa, bb, pp, k, v, w, u, mask)

    out = linear(r * wkv.to(x.dtype), p["output"])
    return out, update_shift_state(att_x, x, lengths), aa, bb, pp


def _layer(p, state, x, lengths):
    att_x, aa, bb, pp, ffn_x = state
    xa = layer_norm(x, p["ln1_w"], p["ln1_b"])
    att_out, new_att_x, aa, bb, pp = _att(p["att"], att_x, aa, bb, pp, xa,
                                          lengths)
    x = x + att_out
    xf = layer_norm(x, p["ln2_w"], p["ln2_b"])
    ffn_out, new_ffn_x = channel_mix_v4(p["ffn"], ffn_x, xf, lengths)
    x = x + ffn_out
    return x, (new_att_x, aa, bb, pp, new_ffn_x)


def forward(params, state, tokens, lengths):
    """Forward a chunk.  tokens: (B, T) int; lengths: (B,).  Returns
    (hidden (B, T, C) post-ln_out, new_state); on the fused T=1 path
    ``new_state`` is ``state`` itself, updated in place."""
    if tokens.shape[1] == 1 and fd.supports(params):
        return fd.forward_t1(params, state, tokens, lengths)
    x = params["emb"][tokens.long()]  # ln0 folded into emb at load
    new = {k: [] for k in STATE_KEYS}
    for i, p in enumerate(params["layers"]):
        x, layer_state = _layer(p, tuple(state[k][i] for k in STATE_KEYS), x,
                                lengths)
        for k, t in zip(STATE_KEYS, layer_state):
            new[k].append(t)
    new_state = {k: torch.stack(v) for k, v in new.items()}
    hidden = layer_norm(x, params["ln_out_w"], params["ln_out_b"])
    return hidden, new_state
