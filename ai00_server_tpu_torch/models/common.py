"""Shared building blocks for the RWKV-7, -6, -5 and -4 forward passes.

Port of ``ai00_server_tpu/models/common.py``.  The JAX package's rounding
points are kept: norms and low-rank branches accumulate in f32; a plain
``linear`` accumulates in f32 and casts back to the activation dtype; a
quantized weight (``ops/quant``) brings its own ``matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.quant import product

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


def linear(x, w, out_dtype=None):
    """``x @ w`` (``w`` is ``(in, out)``): f32 accumulation, activation-dtype
    result, or the f32 sums un-rounded with ``out_dtype=torch.float32`` (a
    tensor-parallel shard's partial sum, rounded once after the shards'
    sums are added).  ``w`` is a plain tensor or a quantized weight from
    ``ops/quant`` (which exposes ``matmul(x, out_dtype)``)."""
    if not isinstance(w, torch.Tensor):
        return w.matmul(x, out_dtype)
    return product(x, w.to(x.dtype), out_dtype)


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


def gated_channel_mix(p, shift, x, lengths, mix_k, mix_r, partial=False):
    """The receptance-gated squared-ReLU channel mix of v4, v5 and v6:
    ``xk = x + dx * mix_k``, ``xr = x + dx * mix_r`` (``dx = x_prev - x``),
    ``sigmoid(xr @ receptance) * (relu(xk @ key)^2 @ value)``.  Returns
    (out, new_shift).

    ``partial=True`` (a tensor-parallel place, :func:`forward_tp`): ``p``
    holds the place's slices, so returns (the value product's f32 partial
    sum, new_shift, the place's slice of the gate ``r``): the partial sums
    are added over the places and rounded to the activation dtype before
    the gate, gathered whole, multiplies them, as ``r * round(k @ value)``
    does on one device."""
    xp = token_shift(shift, x)
    dx = xp - x
    xk = x + dx * mix_k
    xr = x + dx * mix_r
    k = torch.square(torch.relu(linear(xk, p["key"])))
    r = torch.sigmoid(linear(xr, p["receptance"]))
    new_shift = update_shift_state(shift, x, lengths)
    if partial:
        return linear(k, p["value"], torch.float32), new_shift, r
    return r * linear(k, p["value"]), new_shift


def channel_mix_v4(p, shift, x, lengths, partial=False):
    """v4/v5 channel mix: the official ``x * mix + x_prev * (1 - mix)``,
    i.e. :func:`gated_channel_mix` with ``1 - time_mix_{k,r}`` (v6 stores
    its mixes in the other convention and passes them as they are)."""
    return gated_channel_mix(p, shift, x, lengths, 1.0 - p["time_mix_k"],
                             1.0 - p["time_mix_r"], partial)


def channel_mix_v7(p, shift, x, lengths, out_dtype=None):
    """v7 channel mix: squared-ReLU FFN with no receptance gate.
    Returns (out, new_shift); ``out_dtype=torch.float32`` leaves the value
    product's sums un-rounded (a tensor-parallel shard's partial sum).  At
    T = 1 on a quantized layer the whole mix is one op on the stacked codes
    (``ops/ffn.ffn7_t1_l``)."""
    key, val = p["key"], p["value"]
    if x.shape[1] == 1 and hasattr(key, "qlin") and hasattr(val, "qlin"):
        from ..ops.ffn import ffn7_t1_l

        out, new_shift = ffn7_t1_l(
            x[:, 0].contiguous(), shift, p["x_k"], lengths > 0, key.qlin.q,
            key.qlin.scale, val.qlin.q, val.qlin.scale, key.idx,
            qmode=key.mode)
        return out[:, None].to(out_dtype or x.dtype), new_shift
    xp = token_shift(shift, x)
    xk = x + (xp - x) * p["x_k"]
    k = torch.square(torch.relu(linear(xk, p["key"])))
    out = linear(k, p["value"], out_dtype)
    return out, update_shift_state(shift, x, lengths)


def forward_tp(params, states, tokens, lengths, att, ffn):
    """The layer path with the heads (v4: the channels), the hidden width
    and the vocabulary split over the tp places of one dp rank
    (``parallel/sharding``), for one controller: ``params`` and ``states``
    hold one tree per place.  Each place runs its slice of every layer;
    the partial sums of the output projection and the FFN's value are
    added in f32 over the places (``parallel/collectives.all_reduce_sum``)
    and rounded once before the residual adds (v4-v6: before the
    receptance gate, gathered whole, multiplies them), so the activations
    stay whole and equal on every place.

    ``att(p, s, x, lengths, i, carry, shard)``: layer ``i``'s time mix on
    place ``shard = (j, tp)``, ``s`` the place's state of the layer;
    returns (the output projection's f32 partial sum, {key: new state},
    carry) - ``carry`` is what a place hands its next layer (v7's
    ``v_first``).  ``ffn(p, shift, x, lengths)``: the place's channel mix;
    returns (the value product's f32 partial sum, new shift, the place's
    slice of the gate or None).

    tokens: (B, T) int, lengths: (B,), on the first place.  Returns (hidden
    (B, T, C) post-ln_out on the first place, the new state of every
    place)."""
    from ..parallel.collectives import all_gather, all_reduce_sum, broadcast

    tp = len(params)
    places = [p["emb"].device for p in params]
    toks, lens = broadcast(tokens, places), broadcast(lengths, places)
    x = [p["emb"][t.long()] for p, t in zip(params, toks)]
    carry = [None] * tp
    new = [{k: [] for k in s} for s in states]
    for i in range(len(params[0]["layers"])):
        parts = []
        for j in range(tp):
            p = params[j]["layers"][i]
            xa = layer_norm(x[j], p["ln1_w"], p["ln1_b"])
            out, layer, carry[j] = att(
                p["att"], {k: v[i] for k, v in states[j].items()}, xa,
                lens[j], i, carry[j], (j, tp))
            parts.append(out)
            for k, v in layer.items():
                new[j][k].append(v)
        x = [xj + o.to(xj.dtype) for xj, o in zip(x, all_reduce_sum(parts))]
        parts, gates = [], []
        for j in range(tp):
            p = params[j]["layers"][i]
            xf = layer_norm(x[j], p["ln2_w"], p["ln2_b"])
            out, ffn_x, gate = ffn(p["ffn"], states[j]["ffn_x"][i], xf,
                                   lens[j])
            parts.append(out)
            gates.append(gate)
            new[j]["ffn_x"].append(ffn_x)
        outs = [o.to(xj.dtype) for xj, o in zip(x, all_reduce_sum(parts))]
        if gates[0] is not None:
            outs = [all_gather(gates, -1, place) * o
                    for place, o in zip(places, outs)]
        x = [xj + o for xj, o in zip(x, outs)]
    hidden = layer_norm(x[0], params[0]["ln_out_w"], params[0]["ln_out_b"])
    return hidden, [{k: torch.stack(v) for k, v in n.items()} for n in new]
