"""PyTorch/CUDA port of the openh264_tpu encoder.

The JAX package `openh264_tpu` is the unchanged reference; this package
imports nothing of it (nor of JAX). Its entry points are the
device-resident session `encoder.session_device.DeviceSessionEncoder`,
the host encoder `encoder.encoder.H264Encoder` (CAVLC or CABAC), the
encoder API `api.CWelsH264SVCEncoder`, the console `cli.h264enc`,
`parallel.SimulcastEncoder` and `parallel.GopParallelEncoder`, and the
functions of `processing`. Their in-loop deblock runs as a hand-written
CUDA kernel for Hopper (`csrc/deblock.cu`) on a CUDA device and as its
plain PyTorch version on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
