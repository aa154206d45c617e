"""Console application of the port: `h264enc`, the YUV420 to Annex-B
encoder (port of openh264_tpu/cli/h264enc.py, mirroring the reference's
codec/console/enc/src/welsenc.cpp)."""
