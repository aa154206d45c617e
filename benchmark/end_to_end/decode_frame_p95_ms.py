"""decode_frame_p95_ms: the 95th percentile over all pictures of the
window of the wall time of the feed_annexb call that returned each, its
planes on the host included (linear interpolation between ranks)."""

import numpy as np


def read(rec):
    if rec["side"] != "decode" or not rec["latencies"]:
        return None
    return 1e3 * float(np.percentile(rec["latencies"], 95))
