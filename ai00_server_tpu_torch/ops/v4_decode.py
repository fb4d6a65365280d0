"""The fused whole-network RWKV-4 decode step (T = 1) and its CUDA graph.

Port of ``ai00_server_tpu/ops/v4_decode_pallas.py`` (``FUSED_KEY``,
``supports``, ``can_fuse``, ``make_fused_layout``, ``forward_t1`` and the
Pallas ``_kernel`` at its lines 93-186) for plain bf16 / f32 weights and
for its quantized modes (the seven big projections of every layer as int8
or packed nf4 / sf4 / int4 codes, dequantized inside the product).  A layer
is seven launches of three hand-written kernels:

* ``v7_ln_mix`` (``ops/v7_decode``) — LayerNorm 1, the token shift and the
  three mixed inputs ``xa + dx * (1 - time_mix_{k,v,r})``;
* one ``v7_skinny_matmul`` (``ops/v7_decode``) for r (sigmoid, f32), k and v
  (rounded through the activation dtype, used in f32);
* :func:`v4_wkv` (``csrc/wkv4.cu``) — the per-channel ``(aa, bb, pp)`` step
  in f32 and ``r * wkv`` rounded through the activation dtype, a
  programmatic dependent that reads the layer's state before it waits for
  the product before it (whatever fills the state must have finished when
  it starts: a synchronisation, or a launch without PDL between);
* ``v7_skinny_matmul`` for Wo, added into the f32 residual;
* ``v7_ln_mix``, the key (squared ReLU) and receptance (sigmoid) products,
  and the value gated by the receptance and added into the residual, as in
  ``ops/v5_decode``.

Beside the new kernel is its plain PyTorch version, and
:func:`forward_t1_plain` is the stack composed of the plain versions.  A
wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.  The state is updated IN PLACE and the dict
it came in returned, so :class:`DecodeGraph` can capture the stack once.
As in the JAX package (``v4_decode_pallas.py:48-61``) there is no head-size
rule: every v4 model whose big projections are uniformly plain or
uniformly quantized in one mode takes this path.
"""

from __future__ import annotations

import torch

from ..models.common import layer_norm
from . import _build, fused_decode
from . import v7_decode as v7d
from .v7_decode import (_DTYPE_CODE, _dense, _one_cuda_device, _require,
                        _stream, v7_ln_mix, v7_skinny_matmul)

FUSED_KEY = "_fused_t1_v4"

# The fused layout holds the stacks ``mix`` (L, 3, C: 1 - time_mix_{k, v,
# r} in the activation dtype), ``vecs`` (L, 2, C) f32 (w = -exp(time_decay),
# u = time_first: the JAX layout's first two rows; its f32 copies of the
# mixes are ``mix`` and ``fmix`` here), ``ln1``, ``ln2`` (L, 2, C), ``fmix``
# (L, 2, C: 1 - the channel mix's time_mix_{k, r}) and the big projections
# as the lists of the L per-layer tensors of the params themselves.
_BIG_SRC = {"Wr": ("att", "receptance"), "Wk": ("att", "key"),
            "Wv": ("att", "value"), "Wo": ("att", "output"),
            "fkey": ("ffn", "key"), "frec": ("ffn", "receptance"),
            "fval": ("ffn", "value")}
_MIXES = ("time_mix_k", "time_mix_v", "time_mix_r")


def supports(params) -> bool:
    """True when the fused decode layout is installed on these params."""
    return FUSED_KEY in params


def can_fuse(params) -> bool:
    """Whether a fused layout can be built: a v4 model (``time_first`` of
    shape (C,)), activations of one dtype (bf16 or f32) and the big
    projections of ALL layers uniformly plain in that dtype or uniformly
    quantized in ONE mode (a mixed model keeps to the layer path)."""
    layers = params.get("layers")
    if not layers:
        return False
    att = layers[0]["att"]
    if getattr(att.get("time_first"), "ndim", 0) != 1:
        return False
    dtype = att["time_mix_k"].dtype
    return (dtype in _DTYPE_CODE
            and fused_decode.uniform_mode(layers, _BIG_SRC, dtype))


def make_fused_layout(params) -> dict:
    """Decode weight stacks: ``w = -exp(time_decay)``, ``u`` and the
    ``1 - mix`` complements precomputed in f32 (the mixes then rounded once
    to the activation dtype); the matmul weights are the params' own
    tensors."""
    layers = params["layers"]
    cd = layers[0]["att"]["time_mix_k"].dtype

    def stack(rows_of):
        return torch.stack([torch.stack(rows_of(p)) for p in layers])

    def one_minus(t):
        return (1.0 - t.float()).to(cd)

    out = {
        "mix": stack(lambda p: [one_minus(p["att"][k]) for k in _MIXES]),
        "vecs": stack(lambda p: [
            -torch.exp(p["att"]["time_decay"].float()),
            p["att"]["time_first"].float()]),
        "ln1": stack(lambda p: [p["ln1_w"], p["ln1_b"]]),
        "ln2": stack(lambda p: [p["ln2_w"], p["ln2_b"]]),
        "fmix": stack(lambda p: [one_minus(p["ffn"]["time_mix_k"]),
                                 one_minus(p["ffn"]["time_mix_r"])]),
    }
    for p in layers:
        for name, t in fused_decode.big_layout_entries(p, _BIG_SRC).items():
            out.setdefault(name, []).append(t)
    return out


# ---------------------------------------------------------------------------
# v4_wkv
# ---------------------------------------------------------------------------


def v4_wkv_plain(r, k, v, vecs, active, aa, bb, pp, dtype):
    """The plain PyTorch version of :func:`v4_wkv`, functional: returns
    ``(out (B, C) dtype, aa, bb, pp)``."""
    w, u = vecs[0], vecs[1]
    ww = u + k
    q = torch.maximum(pp, ww)
    e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
    wkv = (e1 * aa + e2 * v) / (e1 * bb + e2)
    ww = pp + w
    q = torch.maximum(ww, k)
    e1, e2 = torch.exp(ww - q), torch.exp(k - q)
    act = active[:, None]
    return ((r * wkv).to(dtype),
            torch.where(act, e1 * aa + e2 * v, aa),
            torch.where(act, e1 * bb + e2, bb),
            torch.where(act, q, pp))


def _wkv_inplace_plain(r, k, v, vecs, active, aa, bb, pp, dtype):
    out, *new = v4_wkv_plain(r, k, v, vecs, active, aa, bb, pp, dtype)
    for t, n in zip((aa, bb, pp), new):
        t.copy_(n)
    return out


def v4_wkv(r, k, v, vecs, active, aa, bb, pp, dtype):
    """The WKV stage of one v4 layer's decode step, per (b, c).

    r (the sigmoid receptance), k, v: (B, C) f32; vecs: (2, C) f32 (w =
    -exp(time_decay), u = time_first); active: (B,) bool; aa, bb, pp: (B, C)
    f32.  Computes ``wkv`` from the state before the step for every row,
    advances ``(aa, bb, pp)`` IN PLACE for active rows (an inactive row
    keeps its state bit for bit) and returns ``r * wkv`` rounded through
    ``dtype``: the operand of the output projection, (B, C).  On the card C
    is a multiple of 4 and every f32 operand 16-byte aligned (four channels
    a thread)."""
    if aa.device.type == "cpu":
        return _wkv_inplace_plain(r, k, v, vecs, active, aa, bb, pp, dtype)
    f32s = (r, k, v)
    state = (aa, bb, pp)
    dev = _one_cuda_device(aa, *f32s, *state, vecs, active)
    _require(dtype in _DTYPE_CODE, f"unsupported activation dtype {dtype}")
    B, C = aa.shape
    for t in f32s + state:
        _dense(t, (B, C), torch.float32, "r/k/v/aa/bb/pp")
    _dense(vecs, (2, C), torch.float32, "vecs")
    _dense(active, (B,), torch.bool, "active")
    _require(C % 4 == 0, f"C must be a multiple of 4, got {C}")
    _require(all(t.data_ptr() % 16 == 0 for t in (*f32s, *state, vecs)),
             "r/k/v/aa/bb/pp and vecs must be 16-byte aligned")
    out = torch.empty((B, C), dtype=dtype, device=dev)
    status = _build.library("wkv4").v4_wkv_launch(
        *(t.data_ptr() for t in (*f32s, vecs, active, *state, out)), B, C,
        _DTYPE_CODE[dtype], _stream(dev))
    _build.check(status, "v4_wkv")
    v4_wkv.launches += 1
    return out


v4_wkv.launches = 0

KERNELS = (v7_ln_mix, v7_skinny_matmul, v4_wkv)
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (v7_skinny_matmul, "int8_launches"),
           (v7_skinny_matmul, "q4_launches"))
_PLAIN_OPS = (v7d._ln_mix_inplace_plain, v7d._matmul_inplace_plain,
              _wkv_inplace_plain)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


def _forward(ops, params, state, tokens, lengths):
    ln_mix, matmul, wkv = ops
    f = params[FUSED_KEY]
    L = f["ln1"].shape[0]
    cd = params["emb"].dtype
    active = lengths > 0
    # The f32 residual, carried across the layers without rounding.
    x = params["emb"][tokens[:, 0].long()].float()
    big = fused_decode.big_products(f, params["layers"][0], _BIG_SRC)
    for l in range(L):
        xk, xv, xr = ln_mix(x, f["ln1"][l], state["att_x"][l], f["mix"][l],
                            active)
        r, k, v = matmul([
            big(xr, "Wr", l, act="sigmoid", out="f32"),
            big(xk, "Wk", l, round_cd=True, out="f32"),
            big(xv, "Wv", l, round_cd=True, out="f32")])
        rv = wkv(r, k, v, f["vecs"][l], active, state["aa"][l],
                 state["bb"][l], state["pp"][l], cd)
        matmul([big(rv, "Wo", l, out="add", y=x)])
        fused_decode.gated_channel_mix(ln_mix, matmul, big, f, x,
                                       state["ffn_x"][l], l, active)
    hidden = layer_norm(x.to(cd), params["ln_out_w"], params["ln_out_b"])
    return hidden[:, None, :], state


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v4.forward`` at
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
