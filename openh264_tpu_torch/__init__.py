"""PyTorch/CUDA port of the openh264_tpu encoder session.

The JAX package `openh264_tpu` is the unchanged reference; this package
imports nothing of it (nor of JAX). Its main path is
`encoder.session_device.DeviceSessionEncoder`, whose in-loop deblock
runs as a hand-written CUDA kernel for Hopper (`csrc/deblock.cu`) on a
CUDA device and as its plain PyTorch version on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
