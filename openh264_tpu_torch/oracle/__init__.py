"""Host numpy references that the port reuses, copied from
openh264_tpu/oracle: the bS computation of the deblocking filter, and
the intra predictors and 8x8 inverse transform of the decoder's Python
intra recon."""
