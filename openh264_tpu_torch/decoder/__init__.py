"""The decoder (port of openh264_tpu/decoder): H264Decoder for CAVLC I/P
streams, and the decoder-side data structures that the host encoder's
writers share (FrameSymbols, MV prediction, the CABAC context tables)."""

from .decoder import H264Decoder

__all__ = ["H264Decoder"]
