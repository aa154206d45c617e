"""decode_fps: the pictures whose planes the decoder returned to the host
in the window, over the window's whole seconds."""


def read(rec):
    if rec["side"] != "decode" or not rec["latencies"]:
        return None
    return len(rec["latencies"]) / rec["window_s"]
