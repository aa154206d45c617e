"""Decoder-side data structures that the host encoder's writers share:
FrameSymbols and MV prediction (copied from openh264_tpu/decoder)."""
