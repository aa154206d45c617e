"""Decoder-side data structures that the host encoder's writers share:
FrameSymbols, MV prediction and the CABAC context tables (copied from
openh264_tpu/decoder)."""
