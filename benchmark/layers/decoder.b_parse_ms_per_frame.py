"""decoder.b_parse_ms_per_frame: the time of the port's decoder.parse
spans of B slices (attr slice_type 1), recorded over the staged part of
the traced run, over the B pictures they belong to (their parents'
span ids). None where no decoder.parse span carries slice_type."""

B_SLICE = 1


def read(rec):
    spans = rec.get("spans")
    if rec["side"] != "decode" or not spans:
        return None
    b = [s for s in spans if s.name == "decoder.parse"
         and s.attrs.get("slice_type") == B_SLICE]
    if not b:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in b) / len(
        {s.parent for s in b})
