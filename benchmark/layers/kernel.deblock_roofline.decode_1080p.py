"""kernel.deblock_roofline.decode_1080p: the deblock kernel's share of
its roofline in the traced sub-window of a 1920x1080 decode cell, as
kernel.deblock_roofline.decode, with the frozen least time of a frame of
120x68 MBs (benchmark/roofline.py, DECODER_MB_ARRAYS)."""

from benchmark import profiling, roofline

MB_W, MB_H = 120, 68


def read(rec):
    if rec["side"] != "decode" or rec.get("trace") is None:
        return None
    return roofline.roofline_percent(
        rec["profiled_frames"], profiling.device_seconds(rec["trace"],
                                                         "deblock"),
        MB_W, MB_H, roofline.DECODER_MB_ARRAYS)
