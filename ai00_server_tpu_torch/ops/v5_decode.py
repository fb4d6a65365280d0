"""The fused whole-network RWKV-5 decode step (T = 1) and its CUDA graph.

Port of ``ai00_server_tpu/ops/v5_decode_pallas.py`` (``FUSED_KEY``,
``supports``, ``can_fuse``, ``make_fused_layout``, ``forward_t1`` and the
Pallas ``_kernel`` at its lines 112-209) for plain bf16 / f32 weights and
for its quantized modes (the eight big projections of every layer as int8
or packed nf4 / sf4 / int4 codes, dequantized inside the product).  It needs
no kernel of its own: a layer is seven launches of the RWKV-6 stack's
kernels (``ops/v6_decode``, ``csrc/v6_decode.cu`` and ``csrc/v7_decode.cu``
say what bounds each and what its design does about it):

* ``v7_ln_mix`` — LayerNorm 1, the token shift and the four mixed inputs
  ``xa + dx * (1 - time_mix_{k,v,r,g})``, the new shift state;
* one ``v7_skinny_matmul`` for r, k, v (rounded through the activation
  dtype, used in f32) and g (SiLU, f32);
* ``v6_wkv_gn`` in its static-decay mode: the WKV step with the ``u`` bonus
  on the k-major state, the decay ``exp(-exp(time_decay))`` read from the
  layout's ``vecs`` row 0 for every row, GroupNorm, ``ln_x`` and the gate;
* ``v7_skinny_matmul`` for Wo, added into the f32 residual;
* ``v7_ln_mix`` — LayerNorm 2 and the channel mix's two mixed inputs;
* ``v7_skinny_matmul`` for the key (squared ReLU) and the receptance
  (sigmoid, f32);
* ``v7_skinny_matmul`` for the value, gated by the receptance and added
  into the residual.

Values round through the activation dtype at the Pallas kernel's points:
``r``, ``k``, ``v`` round and are used in f32, ``g`` stays f32 up to the
gate, the WKV output rounds after ``ln_x``, the residual stays f32 across
layers and the shift states keep the f32 LayerNorm.  :func:`forward_t1_plain`
is the stack composed of the kernels' plain versions.  Like
``ops/v7_decode`` this module updates the state IN PLACE and returns the
dict it was passed, so :class:`DecodeGraph` can capture the stack once.  No
VMEM budget applies on the card: every v5 model with a head size the WKV
kernel takes (``N % 8 == 0``, ``8 <= N <= 128``) whose big
projections are uniformly plain or uniformly quantized in one mode takes
this path.
"""

from __future__ import annotations

import torch

from ..models.common import layer_norm
from . import _build, fused_decode
from . import v7_decode as v7d
from .v6_decode import _wkv_gn_inplace_plain, v6_wkv_gn
from .v7_decode import _DTYPE_CODE, v7_ln_mix, v7_skinny_matmul

FUSED_KEY = "_fused_t1_v5"

# The fused layout holds the stacks ``mix`` (L, 4, C: 1 - time_mix_{k, v, r,
# g} in the activation dtype), ``vecs`` (L, 4, C) f32 (the static decay
# exp(-exp(time_decay)), time_first, ln_x weight and bias: the JAX layout's
# rows without its f32 copies of the channel mix's mixes), ``ln1``, ``ln2``
# (L, 2, C) and ``fmix`` (L, 2, C: 1 - the channel mix's time_mix_{k, r}, in
# the activation dtype), and the big projections as the lists of the L
# per-layer tensors of the params themselves (``name``, or ``name_q`` /
# ``name_s`` for codes).
_BIG_SRC = {"Wr": ("att", "receptance"), "Wk": ("att", "key"),
            "Wv": ("att", "value"), "Wg": ("att", "gate"),
            "Wo": ("att", "output"), "fkey": ("ffn", "key"),
            "frec": ("ffn", "receptance"), "fval": ("ffn", "value")}
_MIXES = ("time_mix_k", "time_mix_v", "time_mix_r", "time_mix_g")

KERNELS = (v7_ln_mix, v7_skinny_matmul, v6_wkv_gn)
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (v7_skinny_matmul, "int8_launches"),
           (v7_skinny_matmul, "q4_launches"))
_PLAIN_OPS = (v7d._ln_mix_inplace_plain, v7d._matmul_inplace_plain,
              _wkv_gn_inplace_plain)


def supports(params) -> bool:
    """True when the fused decode layout is installed on these params."""
    return FUSED_KEY in params


def can_fuse(params) -> bool:
    """Whether a fused layout can be built: a v5 model (``time_first`` of
    shape (H, N) and a gate), activations of one dtype (bf16 or f32), the
    big projections of ALL layers uniformly plain in that dtype or uniformly
    quantized in ONE mode (a mixed model keeps to the layer path), ``C ==
    H * N`` and a head size the WKV kernel is built for
    (``_build.head_size_ok``: ``N % 8 == 0``, ``8 <= N <= 128``)."""
    layers = params.get("layers")
    if not layers:
        return False
    att = layers[0]["att"]
    if "gate" not in att or getattr(att.get("time_first"), "ndim", 0) != 2:
        return False
    H, N = att["time_first"].shape
    C = att["time_mix_k"].shape[0]
    dtype = att["time_mix_k"].dtype
    return (C == H * N and _build.head_size_ok(N) and dtype in _DTYPE_CODE
            and fused_decode.uniform_mode(layers, _BIG_SRC, dtype))


def make_fused_layout(params) -> dict:
    """Decode weight stacks: the per-channel vectors, with the static decay
    and the ``1 - mix`` complements precomputed in f32 (the mixes then
    rounded once to the activation dtype), re-packed into a few stacked
    tensors; the matmul weights are the params' own tensors."""
    layers = params["layers"]
    att0 = layers[0]["att"]
    cd = att0["time_mix_k"].dtype
    C = att0["time_mix_k"].shape[0]

    def stack(rows_of):
        return torch.stack([torch.stack(rows_of(p)) for p in layers])

    def one_minus(t):
        return (1.0 - t.float()).to(cd)

    out = {
        "mix": stack(lambda p: [one_minus(p["att"][k]) for k in _MIXES]),
        "vecs": stack(lambda p: [
            torch.exp(-torch.exp(p["att"]["time_decay"].float())).reshape(C),
            p["att"]["time_first"].float().reshape(C),
            p["att"]["ln_x_w"].float(), p["att"]["ln_x_b"].float()]),
        "ln1": stack(lambda p: [p["ln1_w"], p["ln1_b"]]),
        "ln2": stack(lambda p: [p["ln2_w"], p["ln2_b"]]),
        "fmix": stack(lambda p: [one_minus(p["ffn"]["time_mix_k"]),
                                 one_minus(p["ffn"]["time_mix_r"])]),
    }
    for p in layers:
        for name, t in fused_decode.big_layout_entries(p, _BIG_SRC).items():
            out.setdefault(name, []).append(t)
    return out


def _forward(ops, params, state, tokens, lengths):
    """The stack over ``ops`` = (ln_mix, matmul, wkv_gn), the kernels or
    their plain versions (``ops/v56_phased`` runs it with
    ``phased_matmul``)."""
    ln_mix, matmul, wkv_gn = ops
    f = params[FUSED_KEY]
    L = f["ln1"].shape[0]
    cd = params["emb"].dtype
    active = lengths > 0
    # The f32 residual, carried across the layers without rounding.
    x = params["emb"][tokens[:, 0].long()].float()
    big = fused_decode.big_products(f, params["layers"][0], _BIG_SRC)
    for l in range(L):
        xk, xv, xr, xg = ln_mix(x, f["ln1"][l], state["att_x"][l],
                                f["mix"][l], active)
        r, k, v, g = matmul([
            big(xr, "Wr", l, round_cd=True, out="f32"),
            big(xk, "Wk", l, round_cd=True, out="f32"),
            big(xv, "Wv", l, round_cd=True, out="f32"),
            big(xg, "Wg", l, act="silu", out="f32")])
        # w=None: the static decay, vecs row 0.
        yg = wkv_gn(r, k, v, None, g, f["vecs"][l], active,
                    state["wkv"][l], cd)
        matmul([big(yg, "Wo", l, out="add", y=x)])
        fused_decode.gated_channel_mix(ln_mix, matmul, big, f, x,
                                       state["ffn_x"][l], l, active)
    hidden = layer_norm(x.to(cd), params["ln_out_w"], params["ln_out_b"])
    return hidden[:, None, :], state


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v5.forward`` at
    T = 1, through the hand-written kernels on CUDA tensors.

    Requires ``params[FUSED_KEY]`` (:func:`make_fused_layout`).  tokens:
    (B, 1); lengths: (B,) in {0, 1}.  ``state`` is updated IN PLACE (rows
    with length 0 keep theirs bit for bit) and returned beside the hidden
    (B, 1, C) after ``ln_out``.  The embedding gather and ``ln_out`` are
    plain PyTorch; everything between them is the kernels.
    """
    return _forward(KERNELS, params, state, tokens, lengths)


def forward_t1_plain(params, state, tokens, lengths):
    """:func:`forward_t1` composed of the kernels' plain versions, on
    whatever device the tensors are on; same in-place contract."""
    return _forward(_PLAIN_OPS, params, state, tokens, lengths)


class DecodeGraph(fused_decode.DecodeGraph):
    """:func:`forward_t1` captured once in a CUDA graph and replayed per
    decode step (:class:`fused_decode.DecodeGraph`)."""

    forward = staticmethod(forward_t1)
    kernels = KERNELS
    counts = _COUNTS
