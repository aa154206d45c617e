"""Host numpy references that the port reuses: the bS computation of the
deblocking filter (copied from openh264_tpu/oracle)."""
