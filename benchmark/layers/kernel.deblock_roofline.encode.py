"""kernel.deblock_roofline.encode: the deblock kernel's share of its
roofline in the traced sub-window: the frozen least time of one frame
(benchmark/roofline.py, ENCODER_MB_ARRAYS) times the
frames coded there by the harness's own record ("profiled_frames"),
over the device time of the operations whose name contains
"deblock"."""

from benchmark import profiling, roofline


def read(rec):
    if rec["side"] != "encode" or rec.get("trace") is None:
        return None
    return roofline.roofline_percent(
        rec["profiled_frames"], profiling.device_seconds(rec["trace"],
                                                         "deblock"),
        rec["mb_w"], rec["mb_h"], roofline.ENCODER_MB_ARRAYS)
