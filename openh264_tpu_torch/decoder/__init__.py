"""The decoder (port of openh264_tpu/decoder): H264Decoder for I/P
streams (CAVLC or CABAC), and the decoder-side data structures that the
host encoder's writers share (FrameSymbols, MV prediction, the CABAC
context tables)."""

from .decoder import H264Decoder

__all__ = ["H264Decoder"]
