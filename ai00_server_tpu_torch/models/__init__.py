"""RWKV model families in PyTorch.

Port of ``ai00_server_tpu/models/__init__.py``.  A version module offers
``init_state(info, batch, dtype, device)`` (layer-major ``(L, B, ...)``
tensors) and ``forward(params, state, tokens, lengths) -> (hidden,
new_state)``.  This port has RWKV-7 and RWKV-6; v5/v4 are a ROADMAP item.
"""

from .info import ModelInfo, ModelVersion  # noqa: F401

SUPPORTED = (ModelVersion.V7, ModelVersion.V6)


def require_supported(version: ModelVersion) -> None:
    """Raise for a version this port does not serve yet (v5, v4)."""
    if version not in SUPPORTED:
        raise NotImplementedError(
            f"RWKV {version.value} is the ROADMAP 'v5/v4' item; this port "
            "serves V7 and V6")


def get_version_module(version):
    if version == ModelVersion.V7:
        from . import v7

        return v7
    if version == ModelVersion.V6:
        from . import v6

        return v6
    if version in (ModelVersion.V4, ModelVersion.V5):
        require_supported(version)
    raise ValueError(f"unknown model version {version}")
