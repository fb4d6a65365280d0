"""ai00_server_tpu_torch: the PyTorch/CUDA port of ``ai00_server_tpu``.

An RWKV inference server whose hot path runs on an NVIDIA GPU.  Plain
tensor code is PyTorch; every kernel the JAX package wrote in Pallas is a
hand-written CUDA kernel here (``csrc/``, built with ``nvcc`` at first
use).  The package imports ``torch`` and never ``jax``, and nothing of
``ai00_server_tpu``: module names mirror the JAX package so a reader finds
each counterpart.

Entry points run on the card unless the caller passes ``device="cpu"``
(see :mod:`.device`).
"""

__version__ = "0.1.0"
