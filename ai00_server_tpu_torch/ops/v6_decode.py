"""The fused whole-network RWKV-6 decode step (T = 1) and its CUDA graph.

Port of ``ai00_server_tpu/ops/v6_decode_pallas.py`` (``FUSED_KEY``,
``supports``, ``can_fuse``, ``make_fused_layout``, ``forward_t1`` and the
Pallas ``_kernel`` at its lines 126-232) for plain bf16 / f32 weights and
for its quantized modes: the eight big projections of every layer (``Wr``,
``Wk``, ``Wv``, ``Wg``, ``Wo``, ``fkey``, ``frec``, ``fval``) as int8 or
packed nf4 / sf4 / int4 codes, dequantized inside the product.  The Pallas
kernel is one sequential grid over the layers; on the card a layer is
eleven launches of three hand-written kernels (``csrc/v6_decode.cu`` says
what bounds each and what its design does about it):

* ``v7_ln_mix`` (``ops/v7_decode``) — LayerNorm 1 and the token shift:
  ``xa``, ``dx`` and ``xxx = xa + dx * mix_x`` (``with_xa_dx``), the new
  shift state; LayerNorm 2 and the channel mix's two mixed inputs;
* ``v7_skinny_matmul`` (``ops/v7_decode``) — every product, with the
  RWKV-6 epilogues: the token-shift combine ``xa + dx * (mix_f + m_f)``,
  SiLU, the decay ``exp(-exp(.))`` and the receptance-gated residual add;
* :func:`v6_wkv_gn` — the WKV step with the ``u`` bonus on the k-major
  state, GroupNorm, ``ln_x`` and the gate by ``g``.

Beside the new kernel is its plain PyTorch version (``*_plain``), and
:func:`forward_t1_plain` is the stack composed of the plain versions.  A
wrapper runs the plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.  Values round through the activation dtype
at the Pallas kernel's points, which differ from the layer-by-layer path's
(``models/v6.py``): ``r``, ``k``, ``v`` round through it and are used in
f32, ``g`` stays f32 up to the gate, the residual stays f32 across layers
and the shift states keep the f32 LayerNorm.

The TPU kernel splits the (C, 5D) token-shift LoRA into five (C, D) stages
so that it never slices lanes at non-tile offsets; here it is one (C, 5D)
product whose output the five (D, C) products read as strided views.  Like
``ops/v7_decode`` this module updates the state IN PLACE and returns the
dict it was passed, so :class:`DecodeGraph` can capture the stack once.  No
VMEM budget applies on the card: every v6 model with head size 64 whose big
projections are uniformly plain or uniformly quantized in one mode takes
this path.
"""

from __future__ import annotations

import torch

from ..models.common import GN_EPS, layer_norm
from . import _build, fused_decode
from . import v7_decode as v7d
from .v7_decode import (_DTYPE_CODE, Product, _dense, _one_cuda_device,
                        _require, _stream, head_norm, pair_sum,
                        v7_ln_mix, v7_skinny_matmul)

FUSED_KEY = "_fused_t1_v6"

# The fused layout holds the stacks ``mix`` (L, 6, C: mix_x, mix_w, mix_k,
# mix_v, mix_r, mix_g), ``vecs`` (L, 4, C) f32 (the JAX layout's rows
# without its f32 copies of the channel mix's mixes, which nothing here
# reads), ``ln1``, ``ln2`` (L, 2, C) and ``fmix`` (L, 2, C: the channel
# mix's mix_k, mix_r, in the activation dtype), and every matmul
# weight as the list of the L per-layer tensors of the params themselves:
# ``mw1`` (C, 5D), ``mw2`` (5, D, C), ``dw1`` (C, Dw), ``dw2`` (Dw, C) and
# the big projections (``name``, or ``name_q`` / ``name_s`` for codes).
_VEC_NAMES = ("decay", "first", "lnx_w", "lnx_b")
_VEC_IDX = {n: i for i, n in enumerate(_VEC_NAMES)}
_BIG_SRC = {"Wr": ("att", "receptance"), "Wk": ("att", "key"),
            "Wv": ("att", "value"), "Wg": ("att", "gate"),
            "Wo": ("att", "output"), "fkey": ("ffn", "key"),
            "frec": ("ffn", "receptance"), "fval": ("ffn", "value")}
_LORA = {"mw1": "mix_w1", "mw2": "mix_w2", "dw1": "decay_w1",
         "dw2": "decay_w2"}
_MIXES = ("mix_x", "mix_w", "mix_k", "mix_v", "mix_r", "mix_g")


def supports(params) -> bool:
    """True when the fused decode layout is installed on these params."""
    return FUSED_KEY in params


def can_fuse(params) -> bool:
    """Whether a fused layout can be built: activations of one dtype (bf16
    or f32), the big projections of ALL layers uniformly plain in that dtype
    or uniformly quantized in ONE mode (a mixed model keeps to the layer
    path, as a model of several layer groups does in the reference),
    ``C == H * N`` and head size 64 (the WKV kernel's register layout)."""
    layers = params.get("layers")
    if not layers or "first" not in layers[0]["att"]:
        return False
    att = layers[0]["att"]
    H, N = att["first"].shape[-2:]
    C = att["mix_w1"].shape[0]
    dtype = att["mix_w1"].dtype
    if C != H * N or N != 64 or dtype not in _DTYPE_CODE:
        return False
    return fused_decode.uniform_mode(layers, _BIG_SRC, dtype)


def make_fused_layout(params) -> dict:
    """Decode weight stacks: only the per-channel vectors are re-packed into
    a few stacked tensors; the matmul weights are the params' own tensors."""
    layers = params["layers"]
    C = layers[0]["att"]["mix_w1"].shape[0]

    def stack(rows_of):
        return torch.stack([torch.stack(rows_of(p)) for p in layers])

    out = {
        "mix": stack(lambda p: [p["att"][k] for k in _MIXES]),
        "vecs": stack(lambda p: [v.float() for v in (
            p["att"]["decay"], p["att"]["first"].reshape(C),
            p["att"]["ln_x_w"], p["att"]["ln_x_b"])]),
        "ln1": stack(lambda p: [p["ln1_w"], p["ln1_b"]]),
        "ln2": stack(lambda p: [p["ln2_w"], p["ln2_b"]]),
        "fmix": stack(lambda p: [p["ffn"]["mix_k"], p["ffn"]["mix_r"]]),
    }
    for name, key in _LORA.items():
        out[name] = [p["att"][key] for p in layers]
    for p in layers:
        for name, t in fused_decode.big_layout_entries(p, _BIG_SRC).items():
            out.setdefault(name, []).append(t)
    return out


# ---------------------------------------------------------------------------
# v6_wkv_gn
# ---------------------------------------------------------------------------


def v6_wkv_gn_plain(r, k, v, w, g, vecs, active, S, dtype, round_yf=True):
    """The plain PyTorch version of :func:`v6_wkv_gn`, functional: returns
    ``(out (B, C) dtype, S_new)``."""
    B, H, N, _ = S.shape
    C = H * N

    def heads(t):
        return t.reshape(B, H, N)

    if w is None:  # RWKV-5's static decay, the same for every row
        w = vecs[_VEC_IDX["decay"]].expand(B, C)
    u = vecs[_VEC_IDX["first"]].reshape(H, N)
    a = heads(k)[..., :, None] * heads(v)[..., None, :]   # (B, H, N_k, N_v)
    y = torch.einsum("bhk,bhkv->bhv", heads(r), S + u[None, :, :, None] * a)
    S_new = torch.where(active[:, None, None, None],
                        heads(w)[..., None] * S + a, S)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    yn = ((y - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, C)
    yf = yn * vecs[_VEC_IDX["lnx_w"]] + vecs[_VEC_IDX["lnx_b"]]
    if round_yf:
        yf = yf.to(dtype).float()
    return (yf * g).to(dtype), S_new


def v6_wkv_gn_mirror(r, k, v, w, g, vecs, active, S, dtype, round_yf=True):
    """The arithmetic of ``csrc/v6_decode.cu``'s kernel in PyTorch: the
    partial y of the 16 groups of four k rows (each group's rows in order)
    summed in pairs of neighbouring groups, then pairs of those (the
    kernel's fixed tree), and normalised (``v7_decode.head_norm``).  The
    kernel fuses multiply-adds, so the two differ by f32 roundings.  Same
    contract as :func:`v6_wkv_gn_plain`; for the tests, never on a serving
    path."""
    B, H, N, _ = S.shape
    C = H * N

    def heads(t):
        return t.reshape(B, H, N)

    if w is None:  # RWKV-5's static decay
        w = vecs[_VEC_IDX["decay"]].expand(B, C)
    rr, kr, wr, vv = heads(r), heads(k), heads(w), heads(v)
    ur = vecs[_VEC_IDX["first"]].reshape(H, N)
    a = kr[..., :, None] * vv[..., None, :]                 # (B, H, N_k, N)
    t = (rr[..., :, None] * (ur[:, :, None] * a + S)).reshape(
        B, H, N // 4, 4, N)
    part = ((t[:, :, :, 0] + t[:, :, :, 1]) + t[:, :, :, 2]) \
        + t[:, :, :, 3]                                      # (B, H, 16, N)
    yn = head_norm(pair_sum(part.transpose(-1, -2))).reshape(B, C)
    S_new = torch.where(active[:, None, None, None],
                        wr[..., :, None] * S + a, S)
    yf = yn * vecs[_VEC_IDX["lnx_w"]] + vecs[_VEC_IDX["lnx_b"]]
    if round_yf:
        yf = yf.to(dtype).float()
    return (yf * g).to(dtype), S_new


def _wkv_gn_inplace_plain(r, k, v, w, g, vecs, active, S, dtype,
                          round_yf=True):
    out, S_new = v6_wkv_gn_plain(r, k, v, w, g, vecs, active, S, dtype,
                                 round_yf)
    S.copy_(S_new)
    return out


def v6_wkv_gn(r, k, v, w, g, vecs, active, S, dtype, round_yf=True):
    """The WKV stage of one v6 (or v5) layer's decode step, per (b, h).

    r, k, v, w, g: (B, C) f32 (``w`` the decay ``exp(-exp(.))``, ``g`` the
    SiLU gate); vecs: (4, C) f32 (decay, first, lnx_w, lnx_b; ``first`` is
    the bonus ``u``); active: (B,) bool; S: (B, H, 64, 64) f32 (k-dim,
    v-dim).  Computes ``y = r (S + u k v^T)`` from the state before the step
    for every row, ``S = w S + k v^T`` IN PLACE for active rows (an
    inactive row keeps its state bit for bit), GroupNorm of the f32 ``y``
    per head, ``ln_x``, rounding through ``dtype`` (the fused stacks' point;
    the phased ones, ``round_yf=False``, keep the f32 ``ln_x`` up to the
    gate) and the gate by ``g``.  Returns the operand of the output
    projection, (B, C) in ``dtype``.

    ``w=None`` is RWKV-5's static-decay mode: every row decays by vecs row
    0, which then holds ``exp(-exp(time_decay))`` (the kernel reads it with
    a batch stride of 0).

    On the card one launch of ``B * H`` blocks, a programmatic dependent
    that reads ``S``, ``vecs`` and, in the static mode, the decay before it
    waits for the kernel launched before it on the stream: whatever writes
    them must have finished when this kernel starts (as for
    ``v7_wkv_gn``)."""
    if S.device.type == "cpu":
        return _wkv_gn_inplace_plain(r, k, v, w, g, vecs, active, S, dtype,
                                     round_yf)
    static = w is None
    f32s = (r, k, v, vecs if static else w, g)
    dev = _one_cuda_device(S, *f32s, vecs, active)
    B, H, N, N2 = S.shape
    _require(N == 64 and N2 == 64,
             f"the CUDA kernel takes head size 64, got {N}x{N2}")
    _require(dtype in _DTYPE_CODE, f"unsupported activation dtype {dtype}")
    C = H * N
    _dense(S, (B, H, N, N), torch.float32, "S")
    for t in (r, k, v, g) if static else (r, k, v, w, g):
        _dense(t, (B, C), torch.float32, "r/k/v/w/g")
    _dense(vecs, (len(_VEC_NAMES), C), torch.float32, "vecs")
    _require(all(t.data_ptr() % 16 == 0 for t in (S, *f32s, vecs)),
             "S, r/k/v/w/g and vecs must be 16-byte aligned")
    _dense(active, (B,), torch.bool, "active")
    out = torch.empty((B, C), dtype=dtype, device=dev)
    status = _build.library("v6_decode").v6_wkv_gn_launch(
        *(t.data_ptr() for t in f32s), vecs.data_ptr(), active.data_ptr(),
        S.data_ptr(), out.data_ptr(), B, H, N, 0 if static else C,
        int(round_yf), _DTYPE_CODE[dtype], _stream(dev))
    _build.check(status, "v6_wkv_gn")
    v6_wkv_gn.launches += 1
    return out


v6_wkv_gn.launches = 0

KERNELS = (v7_ln_mix, v7_skinny_matmul, v6_wkv_gn)
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (v7_skinny_matmul, "int8_launches"),
           (v7_skinny_matmul, "q4_launches"))
_PLAIN_OPS = (v7d._ln_mix_inplace_plain, v7d._matmul_inplace_plain,
              _wkv_gn_inplace_plain)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


def _forward(ops, params, state, tokens, lengths):
    """The stack over ``ops`` = (ln_mix, matmul, wkv_gn), the kernels or
    their plain versions (``ops/v56_phased`` runs it with
    ``phased_matmul``)."""
    ln_mix, matmul, wkv_gn = ops
    f = params[FUSED_KEY]
    L = f["ln1"].shape[0]
    cd = params["emb"].dtype
    D = f["mw2"][0].shape[1]
    active = lengths > 0
    # The f32 residual, carried across the layers without rounding.
    x = params["emb"][tokens[:, 0].long()].float()
    P = Product
    big = fused_decode.big_products(f, params["layers"][0], _BIG_SRC)
    for l in range(L):
        vec, mix = f["vecs"][l], f["mix"][l]
        xa, dx, xxx = ln_mix(x, f["ln1"][l], state["att_x"][l], mix[0:1],
                             active, with_xa_dx=True)
        # The five data-dependent token-shift offsets (w, k, v, r, g).
        (h,) = matmul([P(xxx, f["mw1"][l], act="tanh")])
        xw, xk, xv, xr, xg = matmul([
            P(h[:, i * D:(i + 1) * D], f["mw2"][l][i], out="mix", xa=xa,
              dx=dx, mix=mix[1 + i]) for i in range(5)])
        (hd,) = matmul([P(xw, f["dw1"][l], act="tanh")])
        r, k, v, g = matmul([
            big(xr, "Wr", l, round_cd=True, out="f32"),
            big(xk, "Wk", l, round_cd=True, out="f32"),
            big(xv, "Wv", l, round_cd=True, out="f32"),
            big(xg, "Wg", l, act="silu", out="f32")])
        (w,) = matmul([P(hd, f["dw2"][l], act="expexp",
                         bias=vec[_VEC_IDX["decay"]], out="f32")])
        yg = wkv_gn(r, k, v, w, g, vec, active, state["wkv"][l], cd)
        matmul([big(yg, "Wo", l, out="add", y=x)])
        fused_decode.gated_channel_mix(ln_mix, matmul, big, f, x,
                                       state["ffn_x"][l], l, active)
    hidden = layer_norm(x.to(cd), params["ln_out_w"], params["ln_out_b"])
    return hidden[:, None, :], state


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v6.forward`` at
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
