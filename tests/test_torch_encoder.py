"""Port parity: the host encoder H264Encoder against the JAX package's.

Both encoders get the same frames (numpy, from a seed) and settings; the
port runs with device="cpu". Every frame's Annex-B bytes must be equal,
and so must the DPB's planes after each frame. This file covers the
one-slice paths: IPPP with an IDR interval, I4x4 in host C, scene-change
detection, LTR marking / feedback / recovery, and carrying the state of
a JAX encoder over into the port. The slice modes and the screen / AQ
paths have files of their own (test_torch_encoder_slices.py,
test_torch_encoder_screen_aq.py).
"""

import numpy as np
import pytest
import torch

from openh264_tpu.encoder.encoder import EncoderConfig as JCfg
from openh264_tpu.encoder.encoder import H264Encoder as JEnc
from openh264_tpu_torch.encoder.config import EncoderConfig as TCfg
from openh264_tpu_torch.encoder.encoder import H264Encoder as TEnc

W, H = 96, 64


def _frames(n, seed=0, scroll=0):
    """Textured content drifting 1 px a frame down and right, with
    camera noise; with scroll, screen content scrolling `scroll` rows a
    frame whose rows repeat exactly."""
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (4 * H, W + 16))
    yy, xx = np.mgrid[0:4 * H, 0:W + 16]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for i in range(n):
        if scroll:
            y = tex[H + scroll * i:2 * H + scroll * i, :W]
        else:
            y = tex[H + i:2 * H + i, i:i + W] + rng.integers(-2, 3, (H, W))
        u = (cx * 3 + cy + 2 * i) % 256
        v = (200 - cx - 2 * cy + i) % 256
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


def _same_dpb(je, te):
    assert len(je.dpb) == len(te.dpb)
    for a, b in zip(je.dpb, te.dpb):
        assert (a.frame_num, a.coding_idx, a.temporal_id, a.is_ltr,
                a.ltr_idx) == (b.frame_num, b.coding_idx, b.temporal_id,
                               b.is_ltr, b.ltr_idx)
        for p, q in zip(a.planes, b.planes):
            np.testing.assert_array_equal(np.asarray(p), q.numpy())
        for x, y in ((a.skip_map, b.skip_map), (a.skip_sad, b.skip_sad)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _run_pair(kw, frames, calls=None):
    """Encodes `frames` with both encoders; calls[i] runs on both before
    frame i. Returns the port's per-frame bytes."""
    je = JEnc(JCfg(width=W, height=H, **kw))
    te = TEnc(TCfg(width=W, height=H, **kw), device="cpu")
    out = []
    for i, f in enumerate(frames):
        if calls and i in calls:
            calls[i](je)
            calls[i](te)
        a = je.encode_frame(*f)
        b = te.encode_frame(*f)
        assert a == b, f"frame {i}"
        _same_dpb(je, te)
        out.append(b)
    return out


def test_constqp_ippp_idr_interval():
    """IPPP at constant QP with an IDR every 3 frames; intra-in-P on."""
    bs = _run_pair(dict(qp=28, idr_interval=3), _frames(5))
    idr = [b[4] & 0x1f == 7 for b in bs]          # SPS first: an IDR
    assert idr == [True, False, False, True, False]


def test_i4x4_host_c():
    """enable_i4x4: the IDR's I16x16-vs-I4x4 decision runs in host C;
    the textured MBs pick I4x4, a flat corner I16x16."""
    from openh264_tpu_torch.encoder.cbind import enc_intra_frame_native
    f = _frames(3, seed=1)
    for y, _u, _v in f:
        y[:32, :32] = 120
    _run_pair(dict(qp=26, enable_i4x4=True), f)
    out = enc_intra_frame_native(*f[0], 26, 25, 4)
    assert (out["kind"] == 0).any() and (out["kind"] == 1).any()


def test_scene_change_detect_every_frame_idr():
    """Pins a fault of the reference (ROADMAP.md C): the encoder tests
    the truth of detect_scene_change's (idc, result) tuple, which always
    holds, so every frame after the first is an IDR, even on content
    that barely moves."""
    bs = _run_pair(dict(qp=28, enable_scene_change_detect=True),
                   _frames(3, seed=2))
    assert all(b[4] & 0x1f == 7 for b in bs)


def test_ltr_feedback_and_recovery():
    """LTR marked every 2 frames, a marking acknowledged by feedback,
    then a recovery request re-anchors a P frame on the acked LTR."""
    calls = {3: lambda e: e.ltr_marking_feedback(
                 {"uiFeedbackType": 1, "iLTRFrameNum": 2}),
             4: lambda e: e.ltr_recovery_request(),
             6: lambda e: e.ltr_marking_feedback(4)}
    _run_pair(dict(qp=28, enable_ltr=True, ltr_mark_period=2, ltr_ref_num=2),
              _frames(7, seed=3), calls)


def test_ltr_recovery_without_ltr_forces_idr():
    """With LTR off, a recovery request forces the next frame to IDR."""
    bs = _run_pair(dict(qp=30), _frames(3, seed=4),
                   {2: lambda e: e.ltr_recovery_request()})
    assert bs[2][4] & 0x1f == 7


def test_cabac_with_i4x4_matches_jax():
    """CABAC, which the port once refused with NotImplementedError, now
    encodes byte-identically with the JAX encoder: with enable_i4x4 set,
    the IDR still takes the I16 wavefront (host C I4x4 is CAVLC-only),
    and the profile rises to Main (tests/test_torch_cabac.py covers the
    other CABAC paths)."""
    bs = _run_pair(dict(qp=29, entropy_cabac=True, enable_i4x4=True),
                   _frames(3, seed=6))
    assert bs[0][5] == 77 and bs[0][4] & 0x1f == 7


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError):
        TEnc(TCfg(width=W, height=H))


def _jax_state(e) -> dict:
    """The port's export_state dict, read from a JAX H264Encoder's
    attributes."""
    def arr(a, dtype):
        return None if a is None else np.asarray(a, dtype).copy()
    r = e.rc.st
    return {
        "frame_num": e.frame_num, "idr_pic_id": e.idr_pic_id,
        "coding_idx": e.coding_idx, "frame_count": e.frame_count,
        "qp": e.qp, "num_ref_frames": e.cfg.num_ref_frames,
        "force_idr": e._force_idr,
        "ltr_capacity_added": e._ltr_capacity_added,
        "ltr_next_idx": e._ltr_next_idx,
        "ltr_acked": sorted(e._ltr_acked),
        "ltr_pending": dict(e._ltr_pending),
        "need_ltr_recovery": e._need_ltr_recovery,
        "prev_input": arr(getattr(e, "_prev_input", None), np.uint8),
        "scroll_prev": arr(getattr(e, "_scroll_prev", None), np.uint8),
        "dpb": [{"frame_num": d.frame_num, "coding_idx": d.coding_idx,
                 "temporal_id": d.temporal_id,
                 "y": arr(d.planes[0], np.uint8),
                 "u": arr(d.planes[1], np.uint8),
                 "v": arr(d.planes[2], np.uint8),
                 "skip_map": arr(d.skip_map, bool),
                 "skip_sad": arr(d.skip_sad, np.int32),
                 "is_ltr": d.is_ltr, "ltr_idx": d.ltr_idx}
                for d in e.dpb],
        "rc": {"qp": r.qp, "buffer_fullness": r.buffer_fullness,
               "model_x": r.model_x, "frames": r.frames,
               "window": list(e.rc._win)},
    }


def test_state_carried_from_jax():
    """3 frames in the JAX encoder, its state carried into the port, then
    3 more frames in both write the same bytes (LTR and RC on); the
    port's own export_state round-trips too."""
    kw = dict(qp=28, rc_mode=1, target_bitrate=300_000, enable_ltr=True,
              ltr_mark_period=2)
    f = _frames(6, seed=5)
    je = JEnc(JCfg(width=W, height=H, **kw))
    for x in f[:3]:
        je.encode_frame(*x)
    je.ltr_marking_feedback(2)
    te = TEnc.from_state(TCfg(width=W, height=H, **kw), _jax_state(je),
                         device="cpu")
    _same_dpb(je, te)
    for i, x in enumerate(f[3:]):
        if i == 1:
            je.ltr_recovery_request()
            te.ltr_recovery_request()
        assert je.encode_frame(*x) == te.encode_frame(*x)
        _same_dpb(je, te)
    st = te.export_state()
    te2 = TEnc.from_state(TCfg(width=W, height=H, **kw), st, device="cpu")
    _same_dpb(te, te2)
    assert te2.export_state().keys() == st.keys()
    assert te2.encode_frame(*f[0]) == te.encode_frame(*f[0])
