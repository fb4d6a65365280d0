"""The fused whole-network RWKV-7 decode step (T = 1) and its CUDA graph.

Port of ``ai00_server_tpu/ops/v7_decode_pallas.py`` (``FUSED_KEY``,
``supports``, ``can_fuse``, ``make_fused_layout``, ``forward_t1`` and the
Pallas ``_kernel`` at its lines 140-270) for plain bf16 / f32 weights and
for its quantized modes: the six big projections of every layer as int8
codes with per-128-row-block scales, or as packed nf4 / sf4 / int4 codes
with per-64-row-block scales, dequantized inside the product.  The Pallas
kernel is one sequential grid over the layers; on the card a layer
is nine launches of three hand-written kernels
(``csrc/v7_decode.cu`` and, built once per head size, ``csrc/v7_wkv_gn.cu``;
the notes there say what bounds each and what its design does about it):

* :func:`v7_ln_mix` — LayerNorm, token shift, the mixed inputs, the new
  shift state;
* :func:`v7_skinny_matmul` — up to five ``epilogue(x @ W)`` with at most a
  few batch rows, the weight in its ``(in, out)`` layout — plain, or int8 or
  packed 4-bit codes and scales — streamed once (the RWKV-6 stack,
  ``ops/v6_decode.py``, runs its products through it too);
* :func:`v7_wkv_gn` — the WKV step with its vector prologue and the
  GroupNorm / bonus / gate epilogue.

Beside each is its plain PyTorch version (``*_plain``), and
:func:`forward_t1_plain` is the stack composed of those.  A wrapper runs the
plain version only for CPU tensors; on a CUDA tensor it launches its kernel
or raises.  Values round through the activation dtype at the Pallas
kernel's points, which differ from the layer-by-layer path's
(``models/v7.py``): the residual stays f32 across layers, the shift states
keep the f32 LayerNorm, ``g`` and the WKV output stay f32 up to the gate.

Where the JAX package is functional this module updates IN PLACE: the
wrappers write the new shift state, WKV state, ``v_first`` and residual
into the tensors they were given, and ``forward_t1`` returns the state
dict it was passed.  Fixed addresses are what lets :class:`DecodeGraph`
capture the whole stack once in a ``torch.cuda.CUDAGraph`` and replay it
for every decode step.

No VMEM budget applies on the card, so every v7 model whose head size the
WKV kernels take (``N % 8 == 0``, ``8 <= N <= 128``: ``_build.head_size_ok``,
as the JAX package's ``N % 8 == 0``) and whose big projections are
uniformly plain or uniformly quantized in one mode takes this path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..models.common import GN_EPS, LN_EPS, layer_norm
from . import _build, fused_decode
from .device import H100_SMS, sm_count
from .quant import LEVELS, MODES
from .quant_matmul import (INT8_BLOCK, NF4_BLOCK, dequant_mode_cd,
                           levels_table)

W_SCALE = 0.6065306597126334  # exp(-0.5)

FUSED_KEY = "_fused_t1"

# The fused layout holds the Pallas kernel's entries under its names: the
# stacks ``mix``, ``vecs``, ``ln1``, ``ln2``, ``fmix`` as (L, ...) tensors,
# and every matmul weight as the list of the L per-layer tensors of the
# params themselves (referenced, never copied).  A quantized model has
# ``name_q`` / ``name_s`` in place of each big ``name``: lists of the
# per-layer VIEWS into the group's stacked codes and scales.
_VEC_NAMES = ("w0", "a0", "v0", "k_k", "k_a", "r_k", "lnx_w", "lnx_b")
_VEC_IDX = {n: i for i, n in enumerate(_VEC_NAMES)}
_BIG_SRC = {"Wr": ("att", "receptance"), "Wk": ("att", "key"),
            "Wv": ("att", "value"), "Wo": ("att", "output"),
            "fkey": ("ffn", "key"), "fval": ("ffn", "value")}
_LORA = ("w1", "a1", "v1", "g1", "w2", "a2", "v2", "g2")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"none": 0, "tanh": 1, "sigmoid": 2, "wdecay": 3, "relu2": 4,
             "silu": 5, "expexp": 6}
_OUT_CODE = {"cd": 0, "f32": 1, "add": 2, "mix": 3, "gadd": 4}
_MM_MAXP = 5  # products per launch
_MM_NB = 8  # batch rows per launch
MAX_CLUSTER = 8  # blocks of a cluster: the portable limit
SKINNY_WARPS = 8  # a block's warps, each a run of steps of its K slice
SKINNY_STEP = 16  # stored rows (4-bit: byte rows, two rows of K) a step
SKINNY_DEEP = 8  # a warp's steps that justify a second block on an SM
_ADDS = ("add", "gadd")  # outputs added into the f32 y in place
_LN_MAXC = 4096  # the widest row v7_ln_mix stages (csrc/decode_common.cuh)


def supports(params) -> bool:
    """True when the fused decode layout is installed on these params."""
    return FUSED_KEY in params


def can_fuse(params) -> bool:
    """Whether a fused layout can be built: activations of one dtype (bf16
    or f32), the big projections of ALL layers uniformly plain in that dtype
    or uniformly quantized in ONE mode — int8, nf4, sf4 or int4 — (a mixed
    model keeps to the layer path), ``C == H * N`` and a head size the WKV
    kernel is built for (``_build.head_size_ok``: ``N % 8 == 0``, ``8 <= N
    <= 128``)."""
    layers = params.get("layers")
    if not layers:
        return False
    att = layers[0]["att"]
    H, N = att["r_k"].shape[-2:]
    C = att["receptance"].shape[0]
    dtype = att["w1"].dtype
    if C != H * N or not _build.head_size_ok(N) or dtype not in _DTYPE_CODE:
        return False
    return fused_decode.uniform_mode(layers, _BIG_SRC, dtype)


def make_fused_layout(params) -> dict:
    """Decode weight stacks: only the per-channel vectors are re-packed into
    a few stacked tensors; the matmul weights are the params' own tensors."""
    layers = params["layers"]
    atts = [p["att"] for p in layers]
    C = atts[0]["receptance"].shape[0]

    def stack(rows_of):
        return torch.stack([torch.stack(rows_of(p)) for p in layers])

    out = {
        "mix": stack(lambda p: [p["att"][k] for k in
                                ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g")]),
        "vecs": stack(lambda p: [
            v.float() for v in (
                *(p["att"][n] for n in ("w0", "a0", "v0", "k_k", "k_a")),
                p["att"]["r_k"].reshape(C), p["att"]["ln_x_w"],
                p["att"]["ln_x_b"])]),
        "ln1": stack(lambda p: [p["ln1_w"], p["ln1_b"]]),
        "ln2": stack(lambda p: [p["ln2_w"], p["ln2_b"]]),
        "fmix": stack(lambda p: [p["ffn"]["x_k"]]),
    }
    for name in _LORA:
        out[name] = [a[name] for a in atts]
    for p in layers:
        for name, t in fused_decode.big_layout_entries(p, _BIG_SRC).items():
            out.setdefault(name, []).append(t)
    return out


# ---------------------------------------------------------------------------
# v7_ln_mix
# ---------------------------------------------------------------------------


def ln_shift_plain(x, ln, shift, active, cd):
    """LayerNorm of the f32 residual and the token shift, as the decode
    kernels compute them: ``(xa, dx, new_shift)`` with ``xa = ln`` and
    ``dx = shift - ln`` rounded through ``cd`` and ``new_shift`` the f32
    LayerNorm where ``active``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    lnv = (xf - mean) * torch.rsqrt(var + LN_EPS) * ln[0].float() \
        + ln[1].float()
    prev = shift.float()
    new_shift = torch.where(active[:, None], lnv, prev).to(shift.dtype)
    return lnv.to(cd), (prev - lnv).to(cd), new_shift


def v7_ln_mix_plain(x, ln, shift, mix, active, with_xa_dx=False):
    """The plain PyTorch version of :func:`v7_ln_mix`, functional:
    returns ``(out (n_mix, B, C) or (2 + n_mix, B, C), new_shift (B,
    C))``."""
    xa, dx, new_shift = ln_shift_plain(x, ln, shift, active, mix.dtype)
    out = xa[None] + dx[None] * mix[:, None, :]
    if with_xa_dx:
        out = torch.cat([xa[None], dx[None], out])
    return out, new_shift


def _ln_mix_inplace_plain(x, ln, shift, mix, active, with_xa_dx=False):
    out, new_shift = v7_ln_mix_plain(x, ln, shift, mix, active, with_xa_dx)
    shift.copy_(new_shift)
    return out


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _dense(t, shape, dtype, name: str) -> None:
    _require(tuple(t.shape) == tuple(shape) and t.dtype == dtype
             and t.is_contiguous(),
             f"{name} must be contiguous {dtype} {tuple(shape)}, got "
             f"{t.dtype} {tuple(t.shape)}")


def _one_cuda_device(*tensors) -> torch.device:
    dev = tensors[0].device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(all(t.device == dev for t in tensors),
             "all operands must be on one device")
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def v7_ln_mix(x, ln, shift, mix, active, with_xa_dx=False):
    """LayerNorm of the f32 residual ``x`` (B, C) with ``ln`` (2, C: weight,
    bias), token shift against ``shift`` (B, C) f32, and ``n_mix`` mixed
    outputs ``ln + (shift - ln) * mix[i]`` in ``mix``'s dtype, returned as
    (n_mix, B, C); ``with_xa_dx`` puts ``xa = ln`` and ``dx = shift - ln``
    first (RWKV-6 mixes its token shift after a LoRA on them), returning
    (2 + n_mix, B, C).  ``shift`` becomes the f32 LayerNorm IN PLACE where
    ``active`` (B,) bool."""
    if x.device.type == "cpu":
        return _ln_mix_inplace_plain(x, ln, shift, mix, active, with_xa_dx)
    dev = _one_cuda_device(x, ln, shift, mix, active)
    B, C = x.shape
    cd = mix.dtype
    _require(cd in _DTYPE_CODE, f"unsupported activation dtype {cd}")
    n_mix = mix.shape[0]
    _dense(x, (B, C), torch.float32, "x")
    _dense(shift, (B, C), torch.float32, "shift")
    _dense(ln, (2, C), cd, "ln")
    _dense(mix, (n_mix, C), cd, "mix")
    _dense(active, (B,), torch.bool, "active")
    _require(C % 4 == 0 and C <= _LN_MAXC and n_mix <= 6,
             f"the kernel takes C a multiple of 4 up to {_LN_MAXC} and up to "
             f"6 mixes, got C={C}, {n_mix}")
    base = 2 if with_xa_dx else 0
    out = torch.empty((base + n_mix, B, C), dtype=cd, device=dev)
    status = _build.library("v7_decode").v7_ln_mix_launch(
        x.data_ptr(), ln.data_ptr(), shift.data_ptr(), mix.data_ptr(),
        active.data_ptr(), out.data_ptr(), B, C, n_mix, base,
        _DTYPE_CODE[cd], _stream(dev))
    _build.check(status, "v7_ln_mix")
    v7_ln_mix.launches += 1
    return out


v7_ln_mix.launches = 0


# ---------------------------------------------------------------------------
# v7_skinny_matmul
# ---------------------------------------------------------------------------


@dataclass
class Product:
    """One ``y = epilogue(x @ W)`` of a :func:`v7_skinny_matmul` launch.

    x: (B, K) in the activation dtype ``cd`` (rows may be a strided view,
    elements contiguous); W: (K, N) in ``cd``, or —
    with ``scale`` and ``mode`` — codes that the product dequantizes in
    ``cd`` per scale block (``ops/quant_matmul``): ``mode="int8"`` int8
    codes (K/128, 128, N) with ``scale`` (K/128, 1, N) f32; ``mode`` nf4 /
    sf4 / int4 packed uint8 codes (K/64, 32, N) with ``scale`` (K/64, 1, N).
    An empty ``mode`` means ``"int8"`` where a scale is given, else
    ``"none"`` (:attr:`weight_mode`).
    Sums are f32.  The epilogue adds ``bias`` ((N,) f32) if given, applies ``act``
    (``none``, ``tanh``, ``sigmoid``, ``wdecay`` = exp(-W_SCALE * sigmoid),
    ``relu2`` = relu squared, ``silu`` = s sigmoid(s), ``expexp`` =
    exp(-exp(s)), RWKV-6's decay), and then ``out`` says what is stored:
    ``"cd"`` a cd tensor, ``"f32"`` an f32 tensor (rounded through cd first
    if ``round_cd``), ``"add"`` nothing new — the result is added into the
    f32 ``y`` (B, N) in place; ``"gadd"`` the same, times the f32 ``gate``
    (B, N); ``"mix"`` a cd tensor ``xa + dx * (mix + s)`` with ``xa``, ``dx``
    (B, N) and ``mix`` (N,) in cd, every step rounded through cd (RWKV-6's
    token-shift combine).
    """

    x: torch.Tensor
    W: torch.Tensor
    act: str = "none"
    bias: torch.Tensor | None = None
    round_cd: bool = False
    out: str = "cd"
    y: torch.Tensor | None = None
    scale: torch.Tensor | None = None
    mode: str = ""
    gate: torch.Tensor | None = None
    xa: torch.Tensor | None = None
    dx: torch.Tensor | None = None
    mix: torch.Tensor | None = None

    @property
    def weight_mode(self) -> str:
        """``"none"`` for a plain weight, else how the codes decode."""
        return self.mode or ("none" if self.scale is None else "int8")

    @property
    def KN(self) -> tuple[int, int]:
        return self.x.shape[1], self.W.shape[-1]


@dataclass(frozen=True)
class Launch:
    """One launch of a product kernel (``v7_skinny_matmul``,
    ``phased_matmul``): batch rows ``b0 .. b0 + rows``; ``cs`` blocks a
    cluster (each sums one K slice of the cluster's tile); per product its
    first tile ``blk0`` and the rows of K a slice holds ``kb``.  Cluster
    ``c`` takes tile ``c - blk0[p]`` of the product ``p`` whose tiles hold
    it, and its rank ``r`` rows ``r kb[p] .. (r + 1) kb[p]`` of K (the
    kernels read the same)."""

    b0: int
    rows: int
    cs: int
    clusters: int
    blk0: tuple
    kb: tuple


def plan_table(launches) -> ctypes.Array:
    """``launches`` as the kernels' plan table: per launch b0, rows, cs,
    clusters, then (blk0, kb) for each of ``_MM_MAXP`` products."""
    rows = []
    for ln in launches:
        pairs = [v for i in range(_MM_MAXP) for v in (
            (ln.blk0[i], ln.kb[i]) if i < len(ln.blk0) else (0, 0))]
        rows += [ln.b0, ln.rows, ln.cs, ln.clusters, *pairs]
    return (ctypes.c_int64 * len(rows))(*rows)


def uses_tensor_cores(shapes, dtype, mode: str) -> bool:
    """Whether a :func:`v7_skinny_matmul` launch over ``shapes`` [(K, N)]
    runs on the tensor-core kernel: bf16 with every N a multiple of 8 (16
    for codes: whole 16-byte loads) and K even; else on the FMA kernel (f32,
    and ragged bf16 shapes)."""
    vec = 8 if mode == "none" else 16
    return dtype == torch.bfloat16 and all(N % vec == 0 and K % 2 == 0
                                           for K, N in shapes)


def skinny_tile(shapes, dtype, mode: str) -> int:
    """Output columns a ``v7_skinny_matmul`` block owns: on the tensor
    cores 64 of bf16 weights and 128 of codes (a 16-byte load a thread, 8
    threads a row), on the FMA kernel 128 (4 columns a lane)."""
    plain_tc = mode == "none" and uses_tensor_cores(shapes, dtype, mode)
    return 64 if plain_tc else 128


def slice_rows(mode: str) -> int:
    """The rows of K a cluster rank's slice holds a multiple of: whole
    scale blocks of codes (128 rows int8, 64 packed 4-bit, whose byte rows
    pair row i with row 32 + i), else a step."""
    if mode == "int8":
        return INT8_BLOCK
    return NF4_BLOCK if mode in LEVELS else SKINNY_STEP


def _rows_per_stored(mode: str) -> int:
    return 2 if mode in LEVELS else 1


def plan(shapes, B: int, mode: str, dtype=torch.bfloat16,
         sms: int = H100_SMS) -> list:
    """The launches of one :func:`v7_skinny_matmul` call over ``shapes``
    [(K, N)] in weight mode ``mode``: one per 8 rows.  Tiles are
    :func:`skinny_tile` columns, in the products' order, one cluster each;
    K is split over ``cs`` blocks a cluster in slices of whole
    :func:`slice_rows`, and each block's slice over its ``SKINNY_WARPS``
    warps in steps.  ``cs`` is at most ``MAX_CLUSTER``, no more than K has
    slices, and leaves every warp of the longest product a step (a step of
    4-bit codes counts twice: it decodes twice the values).  Within that,
    the finest split whose blocks fit one an SM (``sms``).  Where that is
    no split at all, the finest that leaves every warp ``SKINNY_DEEP``
    steps with up to two blocks an SM.  (On the card a second block on an
    SM slowed the short 0.4B launches, whose fixed part dominates,
    1.4-1.6x, and the v6 ones already split over 4 blocks 1.25x, and sped
    up the long unsplit v6 ones 1.15-1.9x: ``tools/torch_skinny_ab.py``.)
    """
    tile, align = skinny_tile(shapes, dtype, mode), slice_rows(mode)
    rpk = _rows_per_stored(mode)
    weight = 2 if mode in LEVELS else 1
    tiles = [-(-N // tile) for _, N in shapes]
    total = sum(tiles)
    k_max = max(K for K, _ in shapes)

    def rows_of(cs):
        return tuple(-(-K // (cs * align)) * align for K, _ in shapes)

    def warp_steps(cs):  # a warp's steps in the longest block, weighted
        return weight * max(-(-(-(-kb // (rpk * SKINNY_STEP)))
                               // SKINNY_WARPS) for kb in rows_of(cs))

    top = max(1, min(MAX_CLUSTER, -(-k_max // align),
                     -(-weight * -(-k_max // (rpk * SKINNY_STEP))
                       // SKINNY_WARPS)))
    fits = [cs for cs in range(1, top + 1) if total * cs <= sms]
    cs = max(fits) if fits else 1
    if cs == 1:
        deep = [c for c in range(2, top + 1) if total * c <= 2 * sms
                and warp_steps(c) >= SKINNY_DEEP]
        cs = max(deep, default=1)
    blk0 = tuple(sum(tiles[:i]) for i in range(len(shapes)))
    return [Launch(b0, min(_MM_NB, B - b0), cs, total, blk0, rows_of(cs))
            for b0 in range(0, B, _MM_NB)]


def block_items(launch: Launch, shapes, dtype, mode: str):
    """The (product, first column, end column, first K row, end K row) of
    every block of ``launch`` that sums something, as the kernel reads the
    plan."""
    tile = skinny_tile(shapes, dtype, mode)
    items = []
    for c in range(launch.clusters):
        p = max(i for i, b in enumerate(launch.blk0) if b <= c)
        K, N = shapes[p]
        col0 = (c - launch.blk0[p]) * tile
        for r in range(launch.cs):
            k0 = r * launch.kb[p]
            k1 = min(K, k0 + launch.kb[p])
            if k1 > k0:
                items.append((p, col0, min(N, col0 + tile), k0, k1))
    return items


def warp_rows(k0: int, k1: int, mode: str) -> list:
    """The rows of K each warp of a block with slice [k0, k1) sums, in the
    kernel's order: a contiguous run of steps a warp (a step of packed
    4-bit codes is byte rows i .. i + 15 of a 64-row block: rows of K i ..
    i + 15 and 32 + i .. 47 + i)."""
    rpk = _rows_per_stored(mode)
    r0, r1 = k0 // rpk, k1 // rpk
    steps = -(-(r1 - r0) // SKINNY_STEP)
    per = -(-steps // SKINNY_WARPS)
    out = []
    for w in range(SKINNY_WARPS):
        s0, s1 = min(steps, w * per), min(steps, w * per + per)
        rows = []
        for st in range(s0, s1):
            base = r0 + SKINNY_STEP * st
            if rpk == 1:
                rows += range(base, min(r1, base + SKINNY_STEP))
            else:
                blk, i = divmod(base, NF4_BLOCK // 2)
                k = NF4_BLOCK * blk + i
                rows += [*range(k, k + SKINNY_STEP),
                         *range(k + 32, k + 32 + SKINNY_STEP)]
        out.append(rows)
    return out


def plan_sums_plain(x, W, launch: Launch, p: int, shapes, dtype,
                    mode: str):
    """``x @ W`` (f32, (rows, N)) of product ``p`` added in the order the
    kernel's plan fixes: each warp's rows of K summed, the warps of a
    block in order, the blocks of a cluster in rank order.  (Inside a
    warp's k-steps the tensor cores' order is the hardware's.)"""
    N = shapes[p][1]
    out = torch.zeros(x.shape[0], N, dtype=torch.float32)
    for q, c0, c1, k0, k1 in block_items(launch, shapes, dtype, mode):
        if q != p:
            continue
        block = torch.zeros(x.shape[0], c1 - c0, dtype=torch.float32)
        for rows in warp_rows(k0, k1, mode):
            if rows:
                idx = torch.tensor(rows)
                block = block + x[:, idx].float() @ W[idx, c0:c1].float()
        out[:, c0:c1] = out[:, c0:c1] + block
    return out


def epilogue_plain(p: Product, s):
    """What the product kernels store for ``p`` from its f32 sums ``s``
    (B, N): the bias, the activation and the output kind of
    :class:`Product`, functional (for ``out="add"``, ``y + s``)."""
    cd = p.x.dtype
    if p.bias is not None:
        s = s + p.bias
    if p.act == "tanh":
        s = torch.tanh(s)
    elif p.act == "sigmoid":
        s = torch.sigmoid(s)
    elif p.act == "wdecay":
        s = torch.exp(-W_SCALE * torch.sigmoid(s))
    elif p.act == "relu2":
        s = torch.square(torch.relu(s))
    elif p.act == "silu":
        s = s * torch.sigmoid(s)
    elif p.act == "expexp":
        s = torch.exp(-torch.exp(s))
    elif p.act != "none":
        raise ValueError(f"unknown activation {p.act!r}")
    if p.out == "add":
        return p.y + s
    if p.out == "gadd":
        return p.y + p.gate * s
    if p.out == "mix":  # each op rounds through cd
        return p.xa + p.dx * (p.mix + s.to(cd))
    if p.out == "f32":
        return s.to(cd).float() if p.round_cd else s
    if p.out == "cd":
        return s.to(cd)
    raise ValueError(f"unknown output kind {p.out!r}")


def v7_skinny_matmul_plain(products):
    """The plain PyTorch version of :func:`v7_skinny_matmul`, functional:
    returns the list of results (for ``out="add"``, ``y + x @ W``)."""
    outs = []
    for p in products:
        mode = p.weight_mode
        W = p.W if mode == "none" else dequant_mode_cd(p.W, p.scale, mode,
                                                       p.x.dtype)
        outs.append(epilogue_plain(p, torch.matmul(p.x.float(), W.float())))
    return outs


def store_adds(products, outs):
    """The in-place contract of the product kernels on the results of a
    plain version: ``add`` / ``gadd`` results are copied into their ``y``,
    which is what the launch returns for them."""
    for p, o in zip(products, outs):
        if p.out in _ADDS:
            p.y.copy_(o)
    return [p.y if p.out in _ADDS else o for p, o in zip(products, outs)]


def _matmul_inplace_plain(products):
    return store_adds(products, v7_skinny_matmul_plain(products))


def launch_table(products, modes):
    """Check the :class:`Product` of one launch of a product kernel and lay
    them out as its descriptor table (``csrc/matmul_common.cuh``,
    ``parse_problem``).  ``modes``: the weight modes the kernel takes.
    Returns ``(table, outs, mode, B, dev)``: the ctypes int64 table, the
    output tensors in order (allocated here, or the ``y`` added into), the
    launch's one weight mode, its rows and its device."""
    dev = _one_cuda_device(*(t for p in products
                             for t in (p.x, p.W, p.bias, p.y, p.scale,
                                       p.gate, p.xa, p.dx, p.mix)
                             if t is not None))
    cd = products[0].x.dtype
    _require(cd in _DTYPE_CODE, f"unsupported activation dtype {cd}")
    mode = products[0].weight_mode
    _require(mode in modes, f"weight mode {mode!r} is not one of {modes}")
    _require(all(p.weight_mode == mode and (p.scale is not None)
                 == (mode != "none") for p in products),
             "the products of a launch are all plain or all int8 or all of "
             "one 4-bit mode, each quantized one with its scale")
    quant, four = mode != "none", mode in LEVELS
    wd = torch.uint8 if four else torch.int8 if quant else cd
    # Rows of K per scale block, and code rows a block is stored as.
    qblock, qrows = (NF4_BLOCK, NF4_BLOCK // 2) if four else (INT8_BLOCK,
                                                              INT8_BLOCK)
    vec = 4 // wd.itemsize  # a thread loads 4 bytes of a weight row
    B = products[0].x.shape[0]
    outs, desc = [], []
    for p in products:
        K, N = p.KN
        if quant:
            _require(K % qblock == 0, f"K={K} must be a multiple of "
                     f"{qblock} for {mode} codes")
            nb = K // qblock
            _dense(p.W, (nb, qrows, N), wd, "W (codes)")
            _dense(p.scale, (nb, 1, N), torch.float32, "scale")
            _require(p.scale.data_ptr() % 16 == 0,
                     "scale must be 16-byte aligned")
        else:
            _dense(p.W, (K, N), wd, "W")
        _require(tuple(p.x.shape) == (B, K) and p.x.dtype == cd
                 and p.x.stride(1) == 1 and p.x.stride(0) >= K,
                 f"x must be {cd} {(B, K)} with contiguous rows, got "
                 f"{p.x.dtype} {tuple(p.x.shape)} strides {p.x.stride()}")
        _require(N % vec == 0 and p.W.data_ptr() % 4 == 0,
                 f"W needs 4-byte aligned rows: N={N} a multiple of {vec}")
        if p.bias is not None:
            _dense(p.bias, (N,), torch.float32, "bias")
        ops = [None, None, None]
        if p.out in _ADDS:
            _require(p.y is not None, f'out="{p.out}" needs y')
            _dense(p.y, (B, N), torch.float32, "y")
            y = p.y
            if p.out == "gadd":
                _require(p.gate is not None, 'out="gadd" needs gate')
                _dense(p.gate, (B, N), torch.float32, "gate")
                ops[0] = p.gate
        else:
            y = torch.empty((B, N), device=dev, dtype=torch.float32
                            if p.out == "f32" else cd)
            if p.out == "mix":
                _require(all(t is not None for t in (p.xa, p.dx, p.mix)),
                         'out="mix" needs xa, dx and mix')
                _dense(p.xa, (B, N), cd, "xa")
                _dense(p.dx, (B, N), cd, "dx")
                _dense(p.mix, (N,), cd, "mix")
                ops = [p.xa, p.dx, p.mix]
        outs.append(y)
        flags = (_ACT_CODE[p.act] | int(p.round_cd) << 8
                 | _OUT_CODE[p.out] << 16)
        desc += [p.x.data_ptr(), p.W.data_ptr(), y.data_ptr(),
                 p.bias.data_ptr() if p.bias is not None else 0, K, N,
                 flags, p.scale.data_ptr() if quant else 0, p.x.stride(0),
                 *(t.data_ptr() if t is not None else 0 for t in ops)]
    return (ctypes.c_int64 * len(desc))(*desc), outs, mode, B, dev


def v7_skinny_matmul(products):
    """Up to five :class:`Product` in one launch per 8 rows; returns their
    results in order (for ``out="add"`` / ``"gadd"`` the tensor that was
    added into).  Every weight byte is read once for up to 8 rows; the
    sums' order is fixed by :func:`plan`, so equal inputs give equal bits.
    bf16 runs on the tensor cores where :func:`uses_tensor_cores` holds (then
    ``W`` 16-byte and the rows of ``x`` 4-byte aligned), else on CUDA-core
    FMAs as f32 does.  No work space: the partial sums stay in shared
    memory."""
    if products[0].x.device.type == "cpu":
        return _matmul_inplace_plain(products)
    _require(1 <= len(products) <= _MM_MAXP,
             f"1 to {_MM_MAXP} products per launch")
    table, outs, mode, B, dev = launch_table(products, ("none", *MODES))
    quant, four = mode != "none", mode in LEVELS
    cd = products[0].x.dtype
    shapes = [p.KN for p in products]
    if uses_tensor_cores(shapes, cd, mode):
        for p in products:
            _require(p.W.data_ptr() % 16 == 0 and p.x.data_ptr() % 4 == 0
                     and p.x.stride(0) % 2 == 0,
                     "the tensor-core kernel needs W 16-byte and the rows "
                     "of x 4-byte aligned")
    launches = plan(shapes, B, mode, cd, sm_count(dev.index))
    ptab = plan_table(launches)
    levels = levels_table(mode) if four else None
    status = _build.library("v7_decode").v7_skinny_matmul_launch(
        ctypes.addressof(table), len(products), ctypes.addressof(ptab),
        len(launches), _DTYPE_CODE[cd], 4 if four else 8 if quant else 0,
        ctypes.addressof(levels) if four else None, _stream(dev))
    _build.check(status, "v7_skinny_matmul")
    n = len(launches)
    v7_skinny_matmul.launches += n
    if four:
        v7_skinny_matmul.q4_launches += n
    elif quant:
        v7_skinny_matmul.int8_launches += n
    return outs


v7_skinny_matmul.launches = 0
v7_skinny_matmul.int8_launches = 0  # those of them on int8 codes
v7_skinny_matmul.q4_launches = 0    # those of them on packed 4-bit codes


# ---------------------------------------------------------------------------
# v7_wkv_gn
# ---------------------------------------------------------------------------


def v7_wkv_gn_plain(r, k, v, w, a, g, vmix, v_first, vecs, active, S,
                    is_first: bool, dtype):
    """The plain PyTorch version of :func:`v7_wkv_gn`, functional: returns
    ``(out (B, C) dtype, S_new, v_first_new)``."""
    B, H, N, _ = S.shape
    C = H * N

    def vec(name):
        return vecs[_VEC_IDX[name]]

    def heads(t):
        return t.reshape(B, H, N)

    kk = k * vec("k_k")
    k2 = k * (1.0 + (a - 1.0) * vec("k_a"))
    if is_first:
        v_first, v2 = v, v
    else:
        v2 = v + (v_first - v) * vmix
    rk = r * k2 * vec("r_k")
    act = active[:, None]
    w = torch.where(act, w, torch.ones_like(w))
    k2 = torch.where(act, k2, torch.zeros_like(k2))
    kk = torch.where(act, kk, torch.zeros_like(kk))

    kk = heads(kk)
    kk = kk / torch.clamp(
        torch.sqrt(torch.sum(kk * kk, dim=-1, keepdim=True)), min=1e-12)
    kk = kk.to(dtype).float()
    skk = torch.sum(S * kk[:, :, None, :], dim=-1)
    S_new = (S * heads(w)[:, :, None, :]
             - skk[..., None] * (kk * heads(a))[:, :, None, :]
             + heads(v2)[..., None] * heads(k2)[:, :, None, :])
    y = torch.sum(S_new * heads(r)[:, :, None, :], dim=-1)     # (B, H, N)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    yn = ((y - mean) * torch.rsqrt(var + GN_EPS)).reshape(B, C)
    bonus = (heads(rk).sum(-1, keepdim=True) * heads(v2)).reshape(B, C)
    yf = (yn * vec("lnx_w") + vec("lnx_b")) + bonus
    return (yf * g).to(dtype), S_new, v_first


# ---------------------------------------------------------------------------
# The kernels' order of sums, in PyTorch (v7_wkv_gn, v6_wkv_gn)
# ---------------------------------------------------------------------------


def pad_to(x, n: int):
    """``x`` with its last dimension zero-padded to ``n``: the lanes or row
    groups of a kernel's tile past the head, which add zero to its sums."""
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def halving_sum(x):
    """Sum over the last dimension (a power of two) in the kernels' order
    (``csrc/decode_common.cuh:head_moments``, ``warp_sum``): element i plus
    element i + n/2 first, then the same on that half, down to one.  On
    the same f32 inputs it gives the kernels' bits."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def pair_sum(x):
    """Sum over the last dimension (a power of two) by neighbours in pairs,
    then pairs of those, down to one: the lanes xor 1, 2, 4 ... of the
    kernels' shuffle sums (and v6's row groups)."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def quad_sum(x):
    """Sum over a v7 head's N channels (the last dimension) in
    ``csrc/v7_wkv_gn.cu``'s order: thread cq of a row group holds channels
    4 cq + e and adds them in pairs, ``(e0 + e1) + (e2 + e3)``; the row
    group's ``head_tile(N) / 4`` threads then add theirs by :func:`pair_sum`
    (those past the head add zero).  On the same f32 inputs it gives the
    kernel's bits."""
    n = x.shape[-1]
    t = x.reshape(*x.shape[:-1], n // 4, 4)
    return pair_sum(pad_to((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]),
                           _build.head_tile(n) // 4))


def head_norm(y):
    """GroupNorm of a head's y (..., N) as the kernels take it: the two-pass
    mean and variance in :func:`halving_sum` order over the head's tile
    (``head_tile(N)`` values, zero past N), each divided by N, then ``(y -
    mean) rsqrt(var + eps)``."""
    n = y.shape[-1]
    p = _build.head_tile(n)
    mean = halving_sum(pad_to(y, p)) / n
    d = y - mean[..., None]
    var = halving_sum(pad_to(d * d, p)) / n
    return d * torch.rsqrt(var + GN_EPS)[..., None]


def v7_wkv_gn_mirror(r, k, v, w, a, g, vmix, v_first, vecs, active, S,
                     is_first: bool, dtype):
    """The arithmetic of ``csrc/v7_wkv_gn.cu``'s ``wkv_gn_kernel`` in
    PyTorch: the removal key's norm and the bonus in :func:`quad_sum` order
    over the head, the value rows updated and read out, the head's y
    normalised (:func:`head_norm`).  The norm's order is the kernel's, so
    ``kk`` rounds through ``dtype`` to its bits; the rest differs from it by
    f32 roundings (the kernel fuses multiply-adds).  Same contract as
    :func:`v7_wkv_gn_plain`; for the tests, never on a serving path."""
    B, H, N, _ = S.shape

    def heads(t):
        return t.reshape(B, H, N)

    def vec(name):
        return vecs[_VEC_IDX[name]].reshape(H, N)

    rv, kv, av, vv = heads(r), heads(k), heads(a), heads(v)
    kk = kv * vec("k_k")
    k2 = kv * (1.0 + (av - 1.0) * vec("k_a"))
    bonus = quad_sum(rv * k2 * vec("r_k"))  # the unmasked k2
    act = active[:, None, None]
    wv = torch.where(act, heads(w), torch.ones_like(kv))
    k2 = torch.where(act, k2, torch.zeros_like(k2))
    kk = torch.where(act, kk, torch.zeros_like(kk))
    norm = torch.clamp(torch.sqrt(quad_sum(kk * kk)), min=1e-12)
    kk = (kk / norm[..., None]).to(dtype).float()
    v2 = vv if is_first else vv + (heads(v_first) - vv) * heads(vmix)
    skk = torch.sum(S * kk[:, :, None, :], dim=-1)
    S_new = (S * wv[:, :, None, :]
             - skk[..., None] * (kk * av)[:, :, None, :]
             + v2[..., None] * k2[:, :, None, :])
    S_new = torch.where(active[:, None, None, None], S_new, S)
    yn = head_norm(torch.sum(S_new * rv[:, :, None, :], dim=-1))
    yf = (yn * vec("lnx_w") + vec("lnx_b")) + bonus[..., None] * v2
    out = (yf * heads(g)).reshape(B, H * N).to(dtype)
    return out, S_new, (v.clone() if is_first else v_first)


def _wkv_gn_inplace_plain(r, k, v, w, a, g, vmix, v_first, vecs, active, S,
                          is_first, dtype):
    out, S_new, vf = v7_wkv_gn_plain(r, k, v, w, a, g, vmix, v_first, vecs,
                                     active, S, is_first, dtype)
    S.copy_(S_new)
    if is_first:
        v_first.copy_(vf)
    return out


def v7_wkv_gn(r, k, v, w, a, g, vmix, v_first, vecs, active, S,
              is_first: bool, dtype):
    """The WKV stage of one layer's decode step, per (b, h).

    r, k, v, w, a, g, vmix, v_first: (B, C) f32; vecs: (8, C) f32 (w0, a0,
    v0, k_k, k_a, r_k, lnx_w, lnx_b); active: (B,) bool; S: (B, H, N, N)
    f32, N a head size the kernel takes (``_build.check_head_size``).  Computes the removal key (L2-normalised ``k * k_k``, rounded
    through ``dtype``), ``k2 = k (1 + (a - 1) k_a)``, the value residual
    (layer 0 — ``is_first`` — writes ``v_first``, later layers read it),
    the delta-rule update of ``S`` IN PLACE (an inactive row keeps its
    state bit for bit), ``y = S' r``, GroupNorm of the f32 ``y`` per head,
    the bonus ``sum(r k2 r_k) v2`` and the gate by ``g``.  Returns the
    operand of the output projection, (B, C) in ``dtype``.

    On the card one launch of ``B * H`` blocks, a programmatic dependent
    that reads ``S`` and ``vecs`` before it waits for the kernel launched
    before it on the stream.  So whatever writes them must have finished
    when this kernel starts: in the stacks ``S`` is written only by this
    launch a step earlier (an earlier graph replay) and ``vecs`` never; a
    caller that has just filled ``S`` synchronises, or lets a launch
    without PDL (any PyTorch operation) come between.
    """
    if S.device.type == "cpu":
        return _wkv_gn_inplace_plain(r, k, v, w, a, g, vmix, v_first, vecs,
                                     active, S, is_first, dtype)
    f32s = (r, k, v, w, a, g, vmix, v_first)
    dev = _one_cuda_device(S, *f32s, vecs, active)
    B, H, N, N2 = S.shape
    _require(N == N2, f"the state must be square, got {N}x{N2}")
    _build.check_head_size(N)
    _require(dtype in _DTYPE_CODE, f"unsupported activation dtype {dtype}")
    C = H * N
    _dense(S, (B, H, N, N), torch.float32, "S")
    _require(S.data_ptr() % 16 == 0, "S must be 16-byte aligned")
    for t in f32s:
        _dense(t, (B, C), torch.float32, "r/k/v/w/a/g/vmix/v_first")
    _dense(vecs, (8, C), torch.float32, "vecs")
    _require(all(t.data_ptr() % 16 == 0 for t in (S, *f32s, vecs)),
             "S, r/k/v/w/a/g/vmix/v_first and vecs must be 16-byte aligned")
    _dense(active, (B,), torch.bool, "active")
    out = torch.empty((B, C), dtype=dtype, device=dev)
    status = _build.library("v7_wkv_gn", N).v7_wkv_gn_launch(
        *(t.data_ptr() for t in f32s), vecs.data_ptr(), active.data_ptr(),
        S.data_ptr(), out.data_ptr(), B, H, N, int(is_first),
        _DTYPE_CODE[dtype], _stream(dev))
    _build.check(status, "v7_wkv_gn")
    v7_wkv_gn.launches += 1
    return out


v7_wkv_gn.launches = 0

KERNELS = (v7_ln_mix, v7_skinny_matmul, v7_wkv_gn)
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (v7_skinny_matmul, "int8_launches"),
           (v7_skinny_matmul, "q4_launches"))
_PLAIN_OPS = (_ln_mix_inplace_plain, _matmul_inplace_plain,
              _wkv_gn_inplace_plain)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


def _forward(ops, params, state, tokens, lengths):
    """The stack over ``ops`` = (ln_mix, matmul, wkv_gn), the kernels or
    their plain versions (``ops/v7_phased`` runs it with
    ``phased_matmul``)."""
    ln_mix, matmul, wkv_gn = ops
    f = params[FUSED_KEY]
    L = f["ln1"].shape[0]
    cd = params["emb"].dtype
    active = lengths > 0
    # The f32 residual, carried across the layers without rounding.
    x = params["emb"][tokens[:, 0].long()].float()
    v_first = torch.empty_like(x)
    P = Product
    big = fused_decode.big_products(f, params["layers"][0], _BIG_SRC)
    for l in range(L):
        vec = f["vecs"][l]
        xr, xw, xk, xv, xa, xg = ln_mix(x, f["ln1"][l], state["att_x"][l],
                                        f["mix"][l], active)
        r, k, v = matmul([
            big(xr, "Wr", l, round_cd=True, out="f32"),
            big(xk, "Wk", l, round_cd=True, out="f32"),
            big(xv, "Wv", l, round_cd=True, out="f32")])
        hw, ha, hv, hg = matmul([
            P(xw, f["w1"][l], act="tanh"), P(xa, f["a1"][l]),
            P(xv, f["v1"][l]), P(xg, f["g1"][l], act="sigmoid")])
        w, a, vmix, g = matmul([
            P(hw, f["w2"][l], act="wdecay", bias=vec[0], out="f32"),
            P(ha, f["a2"][l], act="sigmoid", bias=vec[1], round_cd=True,
              out="f32"),
            P(hv, f["v2"][l], act="sigmoid", bias=vec[2], round_cd=True,
              out="f32"),
            P(hg, f["g2"][l], out="f32")])
        yg = wkv_gn(r, k, v, w, a, g, vmix, v_first, vec, active,
                    state["wkv"][l], l == 0, cd)
        matmul([big(yg, "Wo", l, out="add", y=x)])
        (fx,) = ln_mix(x, f["ln2"][l], state["ffn_x"][l], f["fmix"][l],
                       active)
        (hk,) = matmul([big(fx, "fkey", l, act="relu2")])
        matmul([big(hk, "fval", l, out="add", y=x)])
    hidden = layer_norm(x.to(cd), params["ln_out_w"], params["ln_out_b"])
    return hidden[:, None, :], state


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v7.forward`` at
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
