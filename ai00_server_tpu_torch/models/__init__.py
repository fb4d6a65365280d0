"""RWKV model families in PyTorch.

Port of ``ai00_server_tpu/models/__init__.py``.  A version module offers
``init_state(info, batch, dtype, device)`` (layer-major ``(L, B, ...)``
tensors) and ``forward(params, state, tokens, lengths) -> (hidden,
new_state)``, for each of RWKV-7, -6, -5 and -4.
"""

from .info import ModelInfo, ModelVersion  # noqa: F401


def get_version_module(version):
    from . import v4, v5, v6, v7

    modules = {ModelVersion.V7: v7, ModelVersion.V6: v6,
               ModelVersion.V5: v5, ModelVersion.V4: v4}
    if version not in modules:
        raise ValueError(f"unknown model version {version}")
    return modules[version]
