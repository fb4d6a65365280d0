"""Dispatch table of the fused whole-network T=1 decode paths.

Port of ``ai00_server_tpu/ops/fused_decode.py:module_for``.  One module per
RWKV version, all with the same surface: ``FUSED_KEY``, ``can_fuse(params)``,
``make_fused_layout(params)``, ``supports(params)``, ``forward_t1(...)``.
The quantized-weight helpers of the JAX module (``group_mode``,
``big_layout_entries``, ``make_W`` ...) come with the int8 and 4-bit items
of the ROADMAP.
"""

from __future__ import annotations


def module_for(version: str):
    """The fused-decode module for a ModelVersion value string."""
    if version == "V7":
        from . import v7_decode as fd

        return fd
    raise NotImplementedError(
        f"fused decode for RWKV {version} is the ROADMAP 'v6/v5/v4' item; "
        "this port fuses V7")
