"""Pre-processing for the host encoder: VAA statistics, adaptive quant,
scroll and scene-change detection (port of openh264_tpu/processing).
The statistics run as torch on the encoder's device; the per-MB maps
they feed are host numpy, as in the JAX package."""
