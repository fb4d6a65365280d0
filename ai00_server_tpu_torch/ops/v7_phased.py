"""The phased RWKV-7 decode step (T = 1) for wide batches, and its CUDA
graph.

Port of ``ai00_server_tpu/ops/v7_phased_pallas.py`` (``can_phase``,
``forward_t1`` and the Pallas ``_kernel``).  On the TPU the phased kernel is
the T=1 step of a model whose layer does not fit the fused kernel's VMEM
window: it streams K-tiled weight windows with all B rows resident, so each
weight byte is read once per step whatever B is.  On the card the fused
stack (``ops/v7_decode``) holds 8 batch rows in its products and reads
every weight again for each 8 rows, so the phased stack is the step of a
batch wider than that: the same launch sequence, the same
``FUSED_KEY`` layout and the same ``v7_ln_mix`` / ``v7_wkv_gn`` kernels,
with every product through ``ops/phased_matmul`` (up to 64 rows a launch,
int8 / int4 scales on the f32 sub-sums as the TPU kernel applies them).

The other roundings of the TPU kernel's phases are the fused step's: the
entry's LayerNorm, shifts and LoRA stages (its lines 400-465: ``hw``,
``ha``, ``hv``, ``hg`` through the activation dtype, ``a`` and ``vmix``
rounded after their sigmoid, ``g`` and the decay f32), ``r``, ``k``, ``v``
rounded through it and used in f32 (:500-505), the masking and the bonus
``r k2 r_k`` on the unmasked ``k2`` (:506-563), the head groups' WKV and
GroupNorm (:565-698), the epilogue ``(yn lnx_w + lnx_b + bonus) g`` in f32
and rounded only as Wo's input (:699-722), and the channel mix (:723-768).

Intended divergences: no VMEM budget, tile count ``na`` or head group
applies on the card (they are the TPU's tiling), so ``can_phase`` asks
only for the layout, the weight mode and a batch above 8; nf4 / sf4 reach
the TPU's phased kernel only as int8 surrogate codes, which the port does
not carry, so they keep the fused stack at any batch.
"""

from __future__ import annotations

from . import fused_decode
from . import v7_decode as fd
from .phased_matmul import MODES, _matmul_inplace_plain, phased_matmul
from .v7_decode import v7_ln_mix, v7_wkv_gn

FUSED_KEY = fd.FUSED_KEY
supports = fd.supports
make_fused_layout = fd.make_fused_layout

KERNELS = (v7_ln_mix, phased_matmul, v7_wkv_gn)
_OPS = KERNELS
# Every launch count a replayed graph has to keep up to date.
_COUNTS = (*((k, "launches") for k in KERNELS),
           (phased_matmul, "int8_launches"),
           (phased_matmul, "int4_launches"))
_PLAIN_OPS = (fd._ln_mix_inplace_plain, _matmul_inplace_plain,
              fd._wkv_gn_inplace_plain)


def can_phase(params, batch: int) -> bool:
    """Whether the phased stack takes a step of ``batch`` rows: a batch
    wider than the fused products hold (8), a model the fused layout fits
    (``v7_decode.can_fuse``: ``C == H * N``, head size 64, one activation
    dtype), and big projections uniformly plain or uniformly int8 or int4
    (the TPU kernel's modes)."""
    return (batch > fd._MM_NB and fd.can_fuse(params)
            and fused_decode.group_mode(params["layers"][0],
                                        fd._BIG_SRC) in MODES)


def _forward(ops, params, state, tokens, lengths):
    return fd._forward(ops, params, state, tokens, lengths)


def forward_t1(params, state, tokens, lengths):
    """Single-token decode forward: drop-in for ``models/v7.forward`` at
    T = 1 on a batch above 8, through the hand-written kernels on CUDA
    tensors.  Requires ``params[FUSED_KEY]``; same contract as
    ``ops/v7_decode.forward_t1`` (state updated IN PLACE, rows of length 0
    keep theirs bit for bit)."""
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
