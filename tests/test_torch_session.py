"""Port parity: the PyTorch DeviceSessionEncoder against the JAX one.

The Annex-B streams must be byte-identical on the same synthetic frames
in every config; the port's stream must decode (with the JAX package's
decoder) to the port's own reference planes; and a port session started
from the JAX session's exported state must continue byte-identically.
"""

import numpy as np
import pytest

from openh264_tpu.decoder import H264Decoder
from openh264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from openh264_tpu.encoder.session_device import \
    DeviceSessionEncoder as JaxSession
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.session_device import DeviceSessionEncoder

W, H = 96, 80


def _frames(n, seed):
    """Moving content: a textured gradient drifting 1-2 px a frame, a
    static block (skips), a noisy patch (intra-in-P) and camera noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    tex = np.random.default_rng(seed + 100).integers(0, 256, (H, W))
    out = []
    for i in range(n):
        y = (xx * 2 + yy + 40 * np.sin((xx - 2 * i) / 7.0 + yy / 11.0)
             + np.roll(tex, i, axis=1) // 4)
        y[:16, 64:] = rng.integers(0, 256, (16, 32))     # unpredictable
        y = y + rng.integers(-2, 3, y.shape)
        y[48:, :32] = 90 + yy[48:, :32] // 4            # static
        cy, cx = np.mgrid[0:H // 2, 0:W // 2]
        u = 128 + 40 * np.sin((cx - i) / 5.0) + rng.integers(-1, 2, cx.shape)
        v = 100 + (cx + cy + i) % 64
        u[24:, :16] = 120
        v[24:, :16] = 90
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


def _pair(**kw):
    cfg_kw = dict(width=W, height=H, **kw)
    return JaxConfig(**cfg_kw), EncoderConfig(**cfg_kw)


def _decode_matches_dpb(bs, sess, n_frames):
    frames = H264Decoder().decode_annexb(bs)
    assert len(frames) == n_frames
    last = sess.dpb[-1].planes
    assert np.array_equal(frames[-1].y, last[0].numpy())
    assert np.array_equal(frames[-1].u, last[1].numpy())
    assert np.array_equal(frames[-1].v, last[2].numpy())


CONFIGS = {
    "constqp": dict(qp=28),
    "rc": dict(qp=32, rc_mode=1, target_bitrate=300_000,
               max_frame_rate=12.0),
    "slices4_tid2": dict(qp=30, num_slices=4, temporal_layers=2),
    "slices3_tid3_idc2_rc2": dict(qp=30, num_slices=3, temporal_layers=3,
                                  deblock_idc=2, rc_mode=2,
                                  target_bitrate=400_000,
                                  max_frame_rate=15.0),
    "tid4_idr5_idc1": dict(qp=26, temporal_layers=4, idr_interval=5,
                           deblock_idc=1),
    "rc_frame_skip": dict(qp=30, rc_mode=1, target_bitrate=30_000,
                          max_frame_rate=30.0),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_matches_jax(name):
    n = 9
    fr = _frames(n, seed=len(name))
    jcfg, tcfg = _pair(**CONFIGS[name])
    jsess = JaxSession(jcfg)
    want = jsess.encode_stream(iter(fr))
    tsess = DeviceSessionEncoder(tcfg, device="cpu")
    got = tsess.encode_stream(iter(fr))
    assert [len(g) for g in got] == [len(w) for w in want]
    assert got == want
    assert tcfg.num_ref_frames == jcfg.num_ref_frames
    if name == "rc_frame_skip":
        assert b"" in got[1:], "expected a rate-control frame skip"
    bs = b"".join(got)
    if name == "constqp":
        _decode_matches_dpb(bs, tsess, n)
    else:
        assert len(H264Decoder().decode_annexb(bs)) == \
            sum(1 for g in got if g)


def test_overflow_repack_matches_jax():
    """A tiny body buffer forces the on-device repack; the bytes equal
    the JAX session's and the large-buffer encode's."""
    rng = np.random.default_rng(11)
    fr = [(rng.integers(0, 256, (H, W), np.uint8),
           rng.integers(0, 256, (H // 2, W // 2), np.uint8),
           rng.integers(0, 256, (H // 2, W // 2), np.uint8))
          for _ in range(2)]
    jcfg, tcfg = _pair(qp=18)
    jsess = JaxSession(jcfg, max_body_bytes=1 << 10)
    want = [jsess.encode_frame(*f) for f in fr]
    tiny = DeviceSessionEncoder(tcfg, max_body_bytes=1 << 10, device="cpu")
    got = [tiny.encode_frame(*f) for f in fr]
    assert got == want
    big = DeviceSessionEncoder(_pair(qp=18)[1], device="cpu")
    assert [big.encode_frame(*f) for f in fr] == got
    _decode_matches_dpb(b"".join(got), tiny, 2)


def _jax_state(sess) -> dict:
    """The JAX session's state in the port's export_state layout."""
    st = {"frame_num": sess.frame_num, "idr_pic_id": sess.idr_pic_id,
          "frame_count": sess.frame_count, "coding_idx": sess.coding_idx,
          "qp": sess.qp, "dpb": []}
    for e in sess.dpb:
        st["dpb"].append({
            "frame_num": e.frame_num, "coding_idx": e.coding_idx,
            "temporal_id": e.temporal_id,
            **{k: np.asarray(p) for k, p in zip("yuv", e.planes)},
            "skip_sad": np.asarray(e.skip_sad, np.int32),
            "skip_map": np.asarray(e.skip_map, bool)})
    st["rc"] = None
    if sess.rc is not None:
        r = sess.rc.st
        st["rc"] = {"qp": r.qp, "buffer_fullness": r.buffer_fullness,
                    "model_x": r.model_x, "frames": r.frames,
                    "window": list(sess.rc._win)}
    return st


@pytest.mark.parametrize("kw", [dict(qp=28, temporal_layers=3),
                                dict(qp=32, rc_mode=1,
                                     target_bitrate=300_000,
                                     max_frame_rate=12.0)])
def test_state_carry_over(kw):
    """A port session built from the JAX session's state continues the
    stream byte-identically; the port's own export round-trips."""
    fr = _frames(8, seed=5)
    jcfg, tcfg = _pair(**kw)
    jsess = JaxSession(jcfg)
    jsess.encode_stream(iter(fr[:5]))
    state = _jax_state(jsess)
    want = jsess.encode_stream(iter(fr[5:]))
    tsess = DeviceSessionEncoder.from_state(tcfg, state, device="cpu")
    got = tsess.encode_stream(iter(fr[5:]))
    assert got == want
    # export -> from_state -> export is the identity
    again = DeviceSessionEncoder.from_state(tcfg, tsess.export_state(),
                                            device="cpu").export_state()
    ref = tsess.export_state()
    for k in ("frame_num", "idr_pic_id", "frame_count", "coding_idx", "qp",
              "rc"):
        assert again[k] == ref[k]
    for a, b in zip(again["dpb"], ref["dpb"]):
        for k in a:
            assert np.array_equal(a[k], b[k])



def test_stream_input_error_reaches_caller():
    """An error raised by the frame iterator (read on the upload thread)
    is raised by encode_stream, and the upload thread ends."""
    import threading

    fr = _frames(2, seed=1)

    def frames():
        yield fr[0]
        raise OSError("input ended early")

    before = threading.active_count()
    sess = DeviceSessionEncoder(EncoderConfig(width=W, height=H),
                                device="cpu")
    with pytest.raises(OSError, match="input ended early"):
        sess.encode_stream(frames())
    assert threading.active_count() == before
