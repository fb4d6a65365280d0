"""Dispatch table of the fused whole-network T=1 decode paths.

Port of ``ai00_server_tpu/ops/fused_decode.py:module_for``.  One module per
RWKV version, all with the same surface: ``FUSED_KEY``, ``can_fuse(params)``,
``make_fused_layout(params)``, ``supports(params)``, ``forward_t1(...)``.

``group_mode`` and ``big_layout_entries`` (the JAX module's lines 34 and 67)
let a kernel module take the big projections as plain weights or as codes +
scales (int8, nf4, sf4, int4); here they look at ONE layer's dict, since the
port keeps a dict per layer.  The JAX module's ``make_W`` (the in-kernel
dequantize) is the weight load of ``v7_skinny_matmul`` in
``csrc/v7_decode.cu``.  Its ``mode_packs`` hands the Pallas kernel a 4-bit
mode's levels as four packed constants for a select tree; the card's kernel
gathers from a 16-entry table in shared memory instead, so the counterpart
is the plain tuple ``ops.quant.LEVELS[mode]``.
"""

from __future__ import annotations

from .quant import is_quantized


def module_for(version: str):
    """The fused-decode module for a ModelVersion value string."""
    if version == "V7":
        from . import v7_decode as fd

        return fd
    raise NotImplementedError(
        f"fused decode for RWKV {version} is the ROADMAP 'v6/v5/v4' item; "
        "this port fuses V7")


def group_mode(layer: dict, big_src: dict):
    """``"none"`` / ``"int8"`` / ``"nf4"`` / ``"sf4"`` / ``"int4"`` when the
    layer's big projections are uniformly plain or uniformly quantized in
    one mode; None otherwise."""
    modes = {layer[part][key].mode if is_quantized(layer[part][key])
             else "none" for part, key in big_src.values()}
    return modes.pop() if len(modes) == 1 else None


def big_layout_entries(layer: dict, big_src: dict) -> dict:
    """The fused-layout entries of one layer's big projections: ``name``
    for a plain weight, ``name_q`` + ``name_s`` (codes and scales, views
    into the group's stacked tensors) for a quantized one."""
    out = {}
    for name, (part, key) in big_src.items():
        leaf = layer[part][key]
        if is_quantized(leaf):
            out[f"{name}_q"] = leaf.q
            out[f"{name}_s"] = leaf.scale
        else:
            out[name] = leaf
    return out
