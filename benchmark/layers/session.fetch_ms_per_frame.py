"""session.fetch_ms_per_frame: DeviceSessionEncoder.last_stats["fetch_s"],
summed over the traced run's encode_stream calls, per frame handed in."""


def read(rec):
    st = rec.get("stats")
    if rec["side"] != "encode" or not st or not st.get("frames"):
        return None
    return 1e3 * st["fetch_s"] / st["frames"]
