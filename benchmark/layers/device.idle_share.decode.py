"""device.idle_share.decode: the share of the traced sub-window's wall
time in which no operation ran on the card (1 - the union of the
profiler's device intervals over the sub-window)."""

from benchmark import profiling


def read(rec):
    if rec["side"] != "decode" or rec.get("trace") is None:
        return None
    return profiling.idle_share_percent(rec["trace"])
