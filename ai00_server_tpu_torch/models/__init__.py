"""RWKV model families in PyTorch.

Port of ``ai00_server_tpu/models/__init__.py``.  A version module offers
``init_state(info, batch, dtype, device)`` (layer-major ``(L, B, ...)``
tensors) and ``forward(params, state, tokens, lengths) -> (hidden,
new_state)``.  This port has RWKV-7; v6/v5/v4 are a ROADMAP item.
"""

from .info import ModelInfo, ModelVersion  # noqa: F401


def get_version_module(version):
    if version == ModelVersion.V7:
        from . import v7

        return v7
    if version in (ModelVersion.V4, ModelVersion.V5, ModelVersion.V6):
        raise NotImplementedError(
            f"RWKV {version.value} is the ROADMAP 'v6/v5/v4' item; this port "
            "serves V7")
    raise ValueError(f"unknown model version {version}")
