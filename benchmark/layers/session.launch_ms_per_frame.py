"""session.launch_ms_per_frame: DeviceSessionEncoder.last_stats["launch_s"],
summed over the traced run's encode_stream calls, per frame handed in."""


def read(rec):
    st = rec.get("stats")
    if rec["side"] != "encode" or not st or not st.get("frames"):
        return None
    return 1e3 * st["launch_s"] / st["frames"]
