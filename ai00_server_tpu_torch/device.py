"""Device resolution for the port's entry points.

Every entry point (``Engine``, ``Middleware``, ``main --device``) defaults
to ``"cuda"``.  The CPU is used only when the caller asks for it (the CPU
tests pass ``device="cpu"``); a CUDA request on a machine without a usable
card raises instead of falling back quietly.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) -> ``torch.device``; raises when a
    CUDA device is requested and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
