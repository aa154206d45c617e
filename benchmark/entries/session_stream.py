"""DeviceSessionEncoder(device="cuda").encode_stream, fed closed loop
by a generator that stops yielding when the window's seconds have
passed.

Frames come from a pool of `pool_frames` frames of content.frames made
from the seed at set-up; frame i of the session is pool[i % pool_frames],
so with the configuration's IDR interval equal to the pool the pan
restarts with each IDR. Set-up encodes the first `warmup_frames` (an IDR
and a P frame); the window goes on from there. The control: the session
with its in-loop deblocking filter left out while its slices still say
the filter is on (disable_deblocking_filter_idc 0).
"""

from __future__ import annotations

import time

from benchmark import compare, content, profiling


class State:
    pass


def setup(cell):
    from openh264_tpu_torch.encoder.config import EncoderConfig
    from openh264_tpu_torch.encoder.session_device import \
        DeviceSessionEncoder
    c = cell.config
    s = State()
    s.cell = cell
    s.pool = content.frames(cell.mix["pool_frames"], cell.seed, c["width"],
                            c["height"])
    cfg = EncoderConfig(width=c["width"], height=c["height"], **c["encoder"])
    if cell.control:
        _plant_control()
    s.enc = DeviceSessionEncoder(cfg, device=cell.device)
    s.out = list(s.enc.encode_stream(s.pool[:cell.mix["warmup_frames"]]))
    cell.sync()
    return s


def _plant_control():
    """The session's in-loop deblocking filter made the identity."""
    from openh264_tpu_torch.encoder import session_device as sd
    sd._deblock_ms = lambda rec_y, rec_u, rec_v, *_a, **_k: (
        rec_y, rec_u, rec_v)


def _frames(s, until):
    """Pool frames from the session's next index while until() allows."""
    while until(len(s.out) + s.pending):
        s.pending += 1
        yield s.pool[(len(s.out) + s.pending - 1) % len(s.pool)]


def _encode(s, until, stats):
    s.pending = 0
    out = s.enc.encode_stream(_frames(s, until))
    s.out += out
    for k, v in s.enc.last_stats.items():
        stats[k] = stats.get(k, 0) + v
    return len(out)


def window(s, seconds: float, trace: bool) -> dict:
    stats: dict = {}
    rec = {"side": "encode", "stats": stats}
    t0 = time.perf_counter()

    def timed(_i):
        return time.perf_counter() - t0 < seconds
    if not trace:
        rec["frames_in"] = _encode(s, timed, stats)
        rec["window_s"] = time.perf_counter() - t0
        return rec
    tr = s.cell.mix["trace"]
    n_pool = len(s.pool)
    # run to a third of the window, then on to the GOP position where
    # the profiled frames (all P) start
    n = _encode(s, lambda i: time.perf_counter() - t0 < seconds / 3
                or i % n_pool != tr["profile_from"], stats)
    n0, stop = len(s.out), len(s.out) + tr["profile_frames"]
    _, rec["trace"], launches = profiling.capture(
        lambda: _encode(s, lambda i: i < stop, stats), "encode_window")
    # the frames coded (not skipped by rate control) in the sub-window
    rec["profiled_frames"] = sum(1 for au in s.out[n0:] if au)
    rec["diagnostics"] = {"deblock_launches": launches}
    n += tr["profile_frames"]
    n += _encode(s, timed, stats)
    rec["frames_in"] = n
    rec["window_s"] = time.perf_counter() - t0
    return rec


def close(s):
    """After the window: where the run from the last IDR holds fewer than
    `chain_pictures` frames, the session codes the pool's next frames
    until it holds that many, so that the check reaches P pictures; then
    the encoder's reconstruction of its last picture (its reference
    picture) is kept and the program's state goes."""
    g, _ = compare.last_run(s.out)
    k = s.cell.limits["chain_pictures"]
    if len(s.out) < g + k:
        _encode(s, lambda i: i < g + k, {})
    s.recon = tuple(s.enc.export_state()["dpb"][-1][p] for p in "yuv")
    s.enc = None


def check(s, rec):
    return compare.encode_check(s, rec)
