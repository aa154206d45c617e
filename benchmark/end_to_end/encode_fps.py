"""encode_fps: the frames handed in during the window, over the seconds
from the window's start until the last Annex-B byte of those frames is
on the host."""


def read(rec):
    if rec["side"] != "encode" or rec["frames_in"] == 0:
        return None
    return rec["frames_in"] / rec["window_s"]
