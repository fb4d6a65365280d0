"""The RWKV-7 channel mix at T = 1 on a quantized layer of stacked codes
(int8, nf4, sf4 or int4), as one op.

Port of ``ai00_server_tpu/ops/ffn_pallas.py:ffn7_t1_l``.  The
Pallas grid walks hidden tiles and keeps the ``(B, C)`` sum on chip; on the
card the value product needs every column of the key product's result, so
the hand-written kernel is two launches of the dequantizing product in
``csrc/quant.cu`` per 64 rows (``quant_matmul.plan``): the key product with
the token-shift mix as its prologue and ``relu^2`` as its epilogue, then
the value product, a programmatic dependent launch that streams its codes
while the key product runs.  The layer is picked by offsetting base
pointers into the stacked codes.

    fxk = round_cd(xf + (shift - xf) * mix_k)
    hk  = round_cd(relu(fxk @ K_l)^2)
    out = hk @ V_l                        (f32, not rounded)
    new_shift = where(active, xf, shift)

with ``K_l``, ``V_l`` dequantized in ``cd`` as in ``ops/quant_matmul``
(``qmode`` says how the codes decode; key and value share it).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quant_matmul import (_DTYPE_CODE, _require, check_codes,
                           dequant_mode_cd, launch_plan, levels_table,
                           require_aligned)


def ffn7_t1_l_plain(xf, shift, mix_k, active, key_q, key_s, val_q, val_s,
                    l: int, qmode: str = "int8"):
    """The plain PyTorch version of :func:`ffn7_t1_l`."""
    cd = xf.dtype
    x = xf.float()
    prev = shift.float()
    fxk = (x + (prev - x) * mix_k.float()).to(cd)
    hk = torch.matmul(
        fxk.float(), dequant_mode_cd(key_q[l], key_s[l], qmode, cd).float())
    hk = torch.square(torch.relu(hk)).to(cd)
    out = torch.matmul(
        hk.float(), dequant_mode_cd(val_q[l], val_s[l], qmode, cd).float())
    new_shift = torch.where(active[:, None], x, prev).to(shift.dtype)
    return out, new_shift


def ffn7_t1_l(xf, shift, mix_k, active, key_q, key_s, val_q, val_s, l: int,
              qmode: str = "int8"):
    """One fused v7 channel-mix step on layer ``l`` of stacked codes.

    xf: (B, C) post-ln2 activations (f32 / bf16); shift: (B, C) f32
    token-shift state; mix_k: (C,) in xf's dtype; active: (B,) bool;
    qmode "int8": key_q (L, C/128, 128, F) int8, key_s (L, C/128, 1, F) f32,
    val_q (L, F/128, 128, C), val_s (L, F/128, 1, C); qmode nf4 / sf4 /
    int4: key_q (L, C/64, 32, F) packed uint8, key_s (L, C/64, 1, F),
    val_q (L, F/64, 32, C), val_s (L, F/64, 1, C); l: host int.
    Returns (out (B, C) f32, new_shift (B, C) f32) — functional: ``shift``
    is not written.
    """
    if xf.device.type == "cpu":
        return ffn7_t1_l_plain(xf, shift, mix_k, active, key_q, key_s, val_q,
                               val_s, l, qmode)
    dev = xf.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    cd = xf.dtype
    _require(cd in _DTYPE_CODE, f"unsupported activation dtype {cd}")
    B, C = xf.shape
    Ck, F = check_codes(key_q, key_s, 4, dev, qmode)
    Fv, Cv = check_codes(val_q, val_s, 4, dev, qmode)
    _require(Ck == C and Cv == C and Fv == F and key_q.shape[0]
             == val_q.shape[0],
             f"key codes ({Ck}, {F}) / value codes ({Fv}, {Cv}) do not fit "
             f"C={C}")
    _require(0 <= l < key_q.shape[0], f"layer {l} of {key_q.shape[0]}")
    for t, shape, dtype, name in ((xf, (B, C), cd, "xf"),
                                  (shift, (B, C), torch.float32, "shift"),
                                  (mix_k, (C,), cd, "mix_k"),
                                  (active, (B,), torch.bool, "active")):
        _require(tuple(t.shape) == shape and t.dtype == dtype
                 and t.is_contiguous() and t.device == dev,
                 f"{name} must be contiguous {dtype} {shape} on {dev}, got "
                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
    require_aligned(("xf", xf), ("shift", shift), ("mix_k", mix_k))
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    new_shift = torch.empty((B, C), dtype=torch.float32, device=dev)
    hk = torch.empty((B, F), dtype=cd, device=dev)
    key_plan, key_table = launch_plan(C, F, B, qmode, dev)
    _, val_table = launch_plan(F, C, B, qmode, dev)
    # The 16 levels of a 4-bit mode; int8 codes are their own levels.
    table = None if qmode == "int8" else levels_table(qmode)
    status = _build.library("quant").ffn7_t1_l_launch(
        xf.data_ptr(), shift.data_ptr(), mix_k.data_ptr(), active.data_ptr(),
        key_q.data_ptr(), key_s.data_ptr(), val_q.data_ptr(),
        val_s.data_ptr(), ctypes.addressof(table) if table else None,
        int(l), out.data_ptr(), new_shift.data_ptr(),
        hk.data_ptr(), B, C, F, _DTYPE_CODE[cd], key_table, val_table,
        len(key_plan), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "ffn7_t1_l")
    ffn7_t1_l.launches += len(key_plan)
    return out, new_shift


ffn7_t1_l.launches = 0
