"""Parallel encoding across devices (port of openh264_tpu/parallel):
spatial simulcast with one encoder per layer (simulcast.py), closed
GOPs encoded side by side (gop_parallel.py), and the MB-row bands of
each frame's slices on a list of devices (slice_parallel.py)."""

from .gop_parallel import GopParallelEncoder
from .simulcast import SimulcastEncoder
from .slice_parallel import (SliceParallelEncoder, make_mesh, sliced_i_step,
                             sliced_p_step)

__all__ = ["GopParallelEncoder", "SimulcastEncoder", "SliceParallelEncoder",
           "make_mesh", "sliced_i_step", "sliced_p_step"]
