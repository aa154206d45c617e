"""Parallel encoding across devices (port of openh264_tpu/parallel):
spatial simulcast with one encoder per layer (simulcast.py) and closed
GOPs encoded side by side (gop_parallel.py). Slice-parallel encoding
over several devices is not ported yet (ROADMAP.md, queue A)."""

from .gop_parallel import GopParallelEncoder
from .simulcast import SimulcastEncoder

__all__ = ["GopParallelEncoder", "SimulcastEncoder"]
