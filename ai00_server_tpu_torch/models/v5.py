"""RWKV v5 ("Eagle") forward pass in PyTorch.

Port of ``ai00_server_tpu/models/v5.py`` (``init_state``, ``_att``,
``_layer``, ``forward``).  v5.2 keeps a per-head matrix state ``S`` of shape
``(N_k, N_v)`` with a static per-channel decay ``w = exp(-exp(time_decay))``
and the bonus ``u`` (``time_first``):

    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),    S_t = diag(w) S_{t-1} + k_t v_t^T

then GroupNorm(eps=64e-5), a SiLU gate and the output projection; the token
shift uses the v4 convention ``x + (x_prev - x) * (1 - mix)`` and the channel
mix is v4's (``common.channel_mix_v4``).

``forward`` at T=1 takes the fused decode path (``ops/v5_decode.forward_t1``,
which updates the state in place) when the engine has installed its layout
on the params, or on a batch above 8 the phased one
(``ops/v56_phased.forward_t1``) where its ``can_phase`` holds (plain, int8 or
int4 weights).  Otherwise it runs the layer-by-layer path with the WKV in
the RWKV-5/6 kernels: ``ops/wkv_t1.wkv56_t1`` at T=1, ``ops/wkv_chunk.
wkv56_chunk`` for prefill chunks (their plain versions on CPU tensors).
The JAX model broadcasts the static (H, N) decay to (B, T, H, N); here the
kernels take it as it is and read it for every row and step (a stride of 0,
as ``v6_wkv_gn`` reads it on the fused path), so no broadcast is written.
"""

from __future__ import annotations

import torch

from ..ops import v5_decode as fd
from ..ops import v56_phased as pd
from ..ops.wkv_chunk import wkv56_chunk
from ..ops.wkv_t1 import wkv56_t1
from . import common
from .common import (GN_EPS, acc_dtype, channel_mix_v4, group_norm,
                     layer_norm, length_mask, linear, token_shift,
                     update_shift_state)
from .v6 import init_state  # noqa: F401  (the same state: att_x, wkv, ffn_x)


def _att(p, att_x, wkv, x, lengths, shard=None):
    """v5.2 time mix over one chunk.  x: (B, T, C).  Returns (out,
    new_att_x, new_wkv).

    ``shard=(j, tp)``: tp place ``j`` of ``tp`` (``parallel/sharding``):
    the projections ``p`` holds are its slices, ``wkv`` its H / tp heads;
    the (H, N) decay and bonus and ``ln_x_*`` are sliced here to its heads
    and ``out`` is its f32 partial sum of the output projection, to be
    summed over the tp places.
    """
    B, T, _ = x.shape
    H, N = p["time_first"].shape
    acc = acc_dtype(x.dtype)
    if shard is not None:
        j, tp = shard
        H //= tp
        p = dict(p)
        for k in ("time_decay", "time_first"):
            p[k] = p[k][j * H:(j + 1) * H]
        for k in ("ln_x_w", "ln_x_b"):
            p[k] = p[k][j * H * N:(j + 1) * H * N]
    C = H * N

    xp = token_shift(att_x, x)
    dx = xp - x
    xk = x + dx * (1.0 - p["time_mix_k"])
    xv = x + dx * (1.0 - p["time_mix_v"])
    xr = x + dx * (1.0 - p["time_mix_r"])
    xg = x + dx * (1.0 - p["time_mix_g"])

    r = linear(xr, p["receptance"]).reshape(B, T, H, N)
    k = linear(xk, p["key"]).reshape(B, T, H, N)
    v = linear(xv, p["value"]).reshape(B, T, H, N)
    g = linear(xg, p["gate"])
    g = g * torch.sigmoid(g.to(acc)).to(x.dtype)  # SiLU

    w = torch.exp(-torch.exp(p["time_decay"].to(acc)))  # (H, N), static
    u = p["time_first"]

    mask = length_mask(lengths, T)
    if T == 1:
        new_wkv, yt = wkv56_t1(wkv, r[:, 0], k[:, 0], v[:, 0], w, u,
                               mask[:, 0])
        y = yt[:, None]
    else:
        new_wkv, y = wkv56_chunk(wkv, r, k, v, w, u, mask)

    y = y.reshape(B, T, C).to(x.dtype)
    y = group_norm(y, H, p["ln_x_w"], p["ln_x_b"], GN_EPS)
    out = linear(y * g, p["output"],
                 None if shard is None else torch.float32)
    return (out, update_shift_state(att_x, x, lengths),
            new_wkv.to(wkv.dtype))


def _layer(p, state, x, lengths):
    att_x, wkv, ffn_x = state
    xa = layer_norm(x, p["ln1_w"], p["ln1_b"])
    att_out, new_att_x, new_wkv = _att(p["att"], att_x, wkv, xa, lengths)
    x = x + att_out
    xf = layer_norm(x, p["ln2_w"], p["ln2_b"])
    ffn_out, new_ffn_x = channel_mix_v4(p["ffn"], ffn_x, xf, lengths)
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
        if pd.can_phase(params, tokens.shape[0], "V5"):
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


def forward_tp(params, states, tokens, lengths):
    """The layer path on the tp places of one dp rank
    (:func:`common.forward_tp`): :func:`_att` with ``shard`` on H / tp
    heads, v4's channel mix on the place's slice of the hidden width."""
    def att(p, s, x, lengths, i, carry, shard):
        out, att_x, wkv = _att(p, s["att_x"], s["wkv"], x, lengths, shard)
        return out, {"att_x": att_x, "wkv": wkv}, None

    def ffn(p, shift, x, lengths):
        return channel_mix_v4(p, shift, x, lengths, partial=True)

    return common.forward_tp(params, states, tokens, lengths, att, ffn)
