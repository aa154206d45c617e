"""CWelsH264SVCEncoder(device="cuda").EncodeFrame, one frame per call,
closed loop: the live sender's path (host encoder control, intra-in-P
with I4x4 in host C, the host CAVLC writers, the core on the device).

Frames come from a pool of `pool_frames` frames of content.frames made
from the seed, frame i being pool[i % pool_frames]. Set-up encodes the
first `warmup_frames` (the IDR and a P frame). The configuration's
encoder settings map onto SEncParamExt. The control: the encoder with
its in-loop deblocking filter left out while its slices still say the
filter is on (disable_deblocking_filter_idc 0).
"""

from __future__ import annotations

import time

from benchmark import compare, content, profiling


class State:
    pass


def _params(c):
    from openh264_tpu_torch.api import SEncParamExt
    e = c["encoder"]
    return SEncParamExt(
        iPicWidth=c["width"], iPicHeight=c["height"],
        iTargetBitrate=e["target_bitrate"], iRCMode=e["rc_mode"],
        fMaxFrameRate=e["max_frame_rate"], uiIntraPeriod=e["idr_interval"],
        iEntropyCodingModeFlag=int(e["entropy_cabac"]),
        iNumRefFrame=e["num_ref_frames"],
        iLoopFilterDisableIdc=e["deblock_idc"])


def setup(cell):
    from openh264_tpu_torch.api import WelsCreateSVCEncoder
    c = cell.config
    s = State()
    s.cell = cell
    s.pool = content.frames(cell.mix["pool_frames"], cell.seed, c["width"],
                            c["height"])
    if cell.control:
        _plant_control()
    s.enc = WelsCreateSVCEncoder(device=cell.device)
    if s.enc.InitializeExt(_params(c)) != 0:
        raise ValueError("InitializeExt refused the configuration")
    s.out = []
    for _ in range(cell.mix["warmup_frames"]):
        _encode_one(s)
    cell.sync()
    return s


def _plant_control():
    """The host encoder's in-loop deblocking filter made the identity."""
    from openh264_tpu_torch.encoder import encoder
    encoder.deblock_frame = lambda y, u, v, *_a, **_k: (y, u, v)


def _encode_one(s):
    """Encodes the session's next frame."""
    s.out.append(s.enc.EncodeFrame(*s.pool[len(s.out) % len(s.pool)]))


def window(s, seconds: float, trace: bool) -> dict:
    rec = {"side": "encode"}
    t0 = time.perf_counter()
    n0 = len(s.out)
    if trace:
        tr = s.cell.mix["trace"]
        _, rec["trace"], launches = profiling.capture(
            lambda: [_encode_one(s) for _ in range(tr["profile_frames"])],
            "encode_window")
        # the frames coded (not skipped by rate control) in the block
        rec["profiled_frames"] = sum(1 for au in s.out[n0:] if au)
        rec["diagnostics"] = {"deblock_launches": launches}
    while time.perf_counter() - t0 < seconds:
        _encode_one(s)
    rec["frames_in"] = len(s.out) - n0
    rec["window_s"] = time.perf_counter() - t0
    return rec


def close(s):
    """After the window: where the run from the last IDR holds fewer than
    `chain_pictures` frames, the encoder codes the pool's next frames
    until it holds that many, so that the check reaches P pictures; then
    the encoder's reconstruction of its last picture (its reference
    picture) is kept and the program's state goes."""
    g, _ = compare.last_run(s.out)
    while len(s.out) < g + s.cell.limits["chain_pictures"]:
        _encode_one(s)
    st = s.enc._enc.export_state()
    s.recon = tuple(st["dpb"][-1][p] for p in "yuv")
    s.enc = None


def check(s, rec):
    return compare.encode_check(s, rec)
