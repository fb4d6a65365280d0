"""Kernels (``csrc/``, bound with ctypes) and the device-side sampler."""
