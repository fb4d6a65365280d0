"""The phased RWKV-6 / RWKV-5 decode step (T = 1) for wide batches, and its
CUDA graph: one module for both versions, as on the TPU.

Port of ``ai00_server_tpu/ops/v56_phased_pallas.py`` (``can_phase``,
``forward_t1`` and the Pallas ``_kernel``), the counterpart of
``ops/v7_phased`` (whose docstring says why the card runs it for batches
above 8).  A layer is the launch sequence of the fused stack of its
version — ``ops/v6_decode._forward`` (the five token-shift LoRA stages and
the decay LoRA, the TPU entry's lines 244-262) or ``ops/v5_decode._forward``
(the static ``1 - mix`` shift and decay, :231-242) — over the same
``FUSED_KEY`` layout, with every product through ``ops/phased_matmul``
(int8 / int4 scales on the f32 sub-sums) and ``v6_wkv_gn`` (dense decay for
v6, the stride-0 static decay for v5).  One rounding of the TPU's phased
kernel differs from its fused one and is followed: the epilogue gates the
f32 ``ln_x`` output, ``(yn lnx_w + lnx_b) * silu(g)``, and rounds only the
product as Wo's input (:362-369), where the fused kernels round ``ln_x``
first (``v6_wkv_gn(round_yf=False)``).  The other phases round as the
fused step does: r, k, v through the activation dtype (:308-312), the
WKV and GroupNorm (:320-359), Wo, and the gated channel mix (:374-418: the
receptance's sigmoid and the value's gate f32, the key's squared ReLU
rounded).

Intended divergences as in ``ops/v7_phased``: no VMEM budget or tile count
``na``; nf4 / sf4 keep the fused stack at any batch.  The version is read
off the layout the params carry (``v6_decode.FUSED_KEY`` or
``v5_decode.FUSED_KEY``), so one :class:`DecodeGraph` serves both.
"""

from __future__ import annotations

import functools

from . import fused_decode
from . import v5_decode, v6_decode
from . import v7_decode as v7d
from .phased_matmul import MODES, _matmul_inplace_plain, phased_matmul
from .v6_decode import _wkv_gn_inplace_plain, v6_wkv_gn
from .v7_decode import v7_ln_mix

_FUSED = {"V6": v6_decode, "V5": v5_decode}

KERNELS = (v7_ln_mix, phased_matmul, v6_wkv_gn)
_OPS = (v7_ln_mix, phased_matmul,
        functools.partial(v6_wkv_gn, round_yf=False))
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (phased_matmul, "int8_launches"),
           (phased_matmul, "int4_launches"))
_PLAIN_OPS = (v7d._ln_mix_inplace_plain, _matmul_inplace_plain,
              functools.partial(_wkv_gn_inplace_plain, round_yf=False))


def can_phase(params, batch: int, version: str) -> bool:
    """Whether the phased stack takes a step of ``batch`` rows of a
    ``version`` ("V6" or "V5") model: a batch wider than the fused products
    hold (8), a model the version's fused layout fits (its ``can_fuse``:
    ``C == H * N``, head size 64, one activation dtype), and big projections
    uniformly plain or uniformly int8 or int4."""
    fd = _FUSED.get(version)
    return (fd is not None and batch > v7d._MM_NB and fd.can_fuse(params)
            and fused_decode.group_mode(params["layers"][0],
                                        fd._BIG_SRC) in MODES)


def _forward(ops, params, state, tokens, lengths):
    fd = v6_decode if v6_decode.FUSED_KEY in params else v5_decode
    return fd._forward(ops, params, state, tokens, lengths)


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v6.forward`` or
    ``models/v5.forward`` at T = 1 on a batch above 8, through the
    hand-written kernels on CUDA tensors.  Requires the version's fused
    layout; same contract as ``ops/v6_decode.forward_t1`` (state updated IN
    PLACE, rows of length 0 keep theirs bit for bit)."""
    return _forward(_OPS, params, state, tokens, lengths)


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
