"""Annex-B file → YUV420 decoder console app.

Port of openh264_tpu/cli/h264dec.py, which mirrors the reference
`h264dec` (codec/console/dec/src/h264dec.cpp:218 H264DecodeInstance):
reads a .264 elementary stream, decodes all access units with the
port's decoder on `device` (the card unless the caller asks for the
CPU), writes planar YUV420 in display order, prints frame count and
decode speed like the reference's console output.

Usage: python -m openh264_tpu_torch.cli.h264dec in.264 [out.yuv]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="h264dec",
                                 description="PyTorch/CUDA H.264 decoder")
    ap.add_argument("input", help="Annex-B .264 elementary stream")
    ap.add_argument("output", nargs="?", default=None,
                    help="output YUV420 file (omit to decode only)")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="decode parallelism (frame-level), like "
                         "DECODER_OPTION_NUM_OF_THREADS")
    args = ap.parse_args(argv)

    from ..decoder import H264Decoder
    from ..decoder.decoder import write_yuv

    dec = H264Decoder(device=device)
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    frames = dec.decode_annexb(data)
    dt = time.perf_counter() - t0
    if args.output:
        write_yuv(frames, args.output)
    if frames:
        h, w = frames[0].y.shape
        print(f"Width:\t\t{w}\nHeight:\t\t{h}")
    print(f"Frames:\t\t{len(frames)}")
    print(f"decode time:\t{dt:.6f} sec")
    if dt > 0:
        print(f"FPS:\t\t{len(frames) / dt:.6f} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
