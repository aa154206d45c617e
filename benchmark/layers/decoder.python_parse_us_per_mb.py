"""decoder.python_parse_us_per_mb: the time of the port's decoder.parse
spans that count cabac_python_mbs (the per-MB Python CABAC parser),
recorded over the staged part of the traced run, over those MBs."""


def read(rec):
    spans, counters = rec.get("spans"), rec.get("counters") or {}
    if rec["side"] != "decode" or not spans:
        return None
    ns = mbs = 0
    for s in spans:
        n = counters.get(s.id, {}).get("cabac_python_mbs", 0)
        if s.name == "decoder.parse" and n:
            ns += s.end_ns - s.start_ns
            mbs += n
    return 1e-3 * ns / mbs if mbs else None
