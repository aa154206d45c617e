"""Port parity of the decoder's error concealment, its state carried
across decoders, the decoder API and the h264dec console: the port's
openh264_tpu_torch decoder on the CPU against the JAX package's, byte
for byte (tolerance 0), on CAVLC streams of the port's host encoder at
96x64.

A slice cut short in a P picture and in the IDR is concealed in each of
the 8 ERROR_CON_IDC modes; the concealed picture is not output, and the
P pictures that follow, which predict from it, must equal the JAX
decoder's too (a stale reference would show there).
"""

import functools

import numpy as np
import pytest

from openh264_tpu.api import WelsCreateDecoder as JaxCreateDecoder
from openh264_tpu.cli import h264dec as jax_h264dec
from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu_torch.api import (DECODER_OPTION, DECODING_STATE,
                                    WelsCreateDecoder)
from openh264_tpu_torch.bitstream import (NAL_IDR, NAL_SLICE,
                                          make_annexb_nal, split_annexb)
from openh264_tpu_torch.cli import h264dec
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.decoder import write_yuv
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder

from test_torch_decoder import _refused_stream

W, H = 96, 64


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (4 * H, W + 16))
    yy, xx = np.mgrid[0:4 * H, 0:W + 16]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    out = []
    for i in range(n):
        y = tex[H + 2 * i:2 * H + 2 * i, i:i + W] + rng.integers(-2, 3,
                                                                 (H, W))
        u = (cx * 3 + cy + 2 * i) % 200 + tall[:H // 2, :W // 2] // 16
        v = (200 - cx - 2 * cy + i) % 200 + tall[H:H + H // 2, :W // 2] // 16
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


@functools.lru_cache(maxsize=None)
def _per_frame(name):
    """The Annex-B bytes of each frame (the first with SPS and PPS)."""
    kw = {"slices3": dict(qp=28, num_slices=3),
          "ltr": dict(qp=28, enable_ltr=True, ltr_mark_period=2)}[name]
    enc = H264Encoder(EncoderConfig(width=W, height=H, **kw), device="cpu")
    out = []
    for i, f in enumerate(_frames(6, seed=7)):
        if name == "ltr" and i == 4:
            enc.ltr_recovery_request()
        out.append(enc.encode_frame(*f))
    return tuple(out)


def _truncated(frame, slice_idx):
    """The slices3 stream with slice `slice_idx` of picture `frame` cut
    to half its bytes."""
    out, pic, k = [], -1, 0
    for nal in split_annexb(b"".join(_per_frame("slices3"))):
        rbsp = nal.rbsp
        if nal.nal_unit_type in (NAL_SLICE, NAL_IDR):
            if rbsp[0] & 0x80:            # first_mb_in_slice == 0: ue '1'
                pic, k = pic + 1, 0
            if (pic, k) == (frame, slice_idx):
                rbsp = rbsp[:len(rbsp) // 2]
            k += 1
        out.append(make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type, rbsp))
    return b"".join(out)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.poc, g.frame_num) == (w.poc, w.frame_num)
        for c in "yuv":
            np.testing.assert_array_equal(getattr(g, c), getattr(w, c))


@pytest.mark.parametrize("ec_mode", range(8))
@pytest.mark.parametrize("site", [(2, 1), (0, 2)], ids=["p", "idr"])
def test_concealment_matches_jax(ec_mode, site):
    bs = _truncated(*site)
    if ec_mode == 0:                    # ERROR_CON_DISABLE: the error
        with pytest.raises(Exception) as got:
            H264Decoder(device="cpu", ec_mode=0).decode_annexb(bs)
        with pytest.raises(Exception) as want:
            JaxDecoder(ec_mode=0).decode_annexb(bs)
        assert got.type is want.type
        return
    got = H264Decoder(device="cpu", ec_mode=ec_mode).decode_annexb(bs)
    assert len(got) == 5                # the concealed picture is not out
    _equal(got, JaxDecoder(ec_mode=ec_mode).decode_annexb(bs))


def _plain(obj):
    """Whether obj holds only numpy arrays and plain values."""
    if isinstance(obj, dict):
        return all(_plain(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_plain(v) for v in obj)
    return obj is None or isinstance(obj, (np.ndarray, bytes, str, int,
                                           float, bool, np.integer))


@pytest.mark.parametrize("name,split", [("slices3", 2), ("ltr", 5)])
def test_state_split_at_a_p_frame(name, split):
    """export_state / from_state between two P pictures continues as an
    uninterrupted decode (the LTR stream carries a long-term reference
    and its recovery across the split)."""
    fr = _per_frame(name)
    want = H264Decoder(device="cpu").decode_annexb(b"".join(fr))
    a = H264Decoder(device="cpu")
    got = a.decode_annexb(b"".join(fr[:split]))
    state = a.export_state()
    assert _plain(state)
    b = H264Decoder.from_state(state, device="cpu")
    got += b.decode_annexb(b"".join(fr[split:]))
    _equal(got, want)


def test_state_split_mid_nal_in_feed_mode():
    """A split inside a NAL, with bytes buffered and slices pending."""
    bs = b"".join(_per_frame("slices3"))
    want = H264Decoder(device="cpu").decode_annexb(bs)
    cut = len(bs) // 2 + 3
    a = H264Decoder(device="cpu")
    got = a.feed_annexb(bs[:cut])
    state = a.export_state()
    assert state["in_buf"] and state["pending"]
    b = H264Decoder.from_state(state, device="cpu")
    got += b.feed_annexb(bs[cut:]) + b.flush()
    _equal(got, want)


def test_api_matches_jax():
    """CWelsDecoder fed in chunks, then flushed: the frames and the
    statistics of the JAX API."""
    bs = b"".join(_per_frame("ltr"))
    res = []
    for dec in (WelsCreateDecoder(device="cpu"), JaxCreateDecoder()):
        assert dec.DecodeFrameNoDelay(b"\x00")[0] == \
            DECODING_STATE.dsInitialOptExpected
        assert dec.Initialize() == 0
        assert dec.SetOption(DECODER_OPTION.ERROR_CON_IDC, 2) == 0
        frames = []
        for k in range(0, len(bs), 500):
            state, out = dec.DecodeFrameNoDelay(bs[k:k + 500])
            assert state == DECODING_STATE.dsErrorFree
            frames += out
        state, out = dec.FlushFrame()
        frames += out
        st = dec.GetOption(DECODER_OPTION.GET_STATISTICS)
        res.append((frames, st.uiDecodedFrameCount, st.uiWidth, st.uiHeight,
                    dec.GetOption(DECODER_OPTION.PROFILE),
                    dec.GetOption(DECODER_OPTION.LEVEL)))
    _equal(res[0][0], res[1][0])
    assert res[0][1:] == res[1][1:] == (6, W, H, 66, 31)
    assert len(res[0][0]) == 6


def test_api_lets_not_implemented_through():
    """A CABAC stream with an SP slice appended raises out of the API's
    decode calls; it is not reported as a bitstream error."""
    bs = _refused_stream("cabac_sp_slice")
    dec = WelsCreateDecoder(device="cpu")
    dec.Initialize()
    with pytest.raises(NotImplementedError):
        dec.DecodeFrameNoDelay(bs)
        dec.FlushFrame()


def test_console_matches_jax(tmp_path, capsys):
    """h264dec in.264 out.yuv writes the JAX console's file, which is the
    decoder's frames in order."""
    src = tmp_path / "in.264"
    src.write_bytes(b"".join(_per_frame("slices3")))
    ours, theirs, direct = (tmp_path / n for n in ("a.yuv", "b.yuv",
                                                     "c.yuv"))
    assert h264dec.main([str(src), str(ours)], device="cpu") == 0
    printed = capsys.readouterr().out
    assert "Frames:\t\t6" in printed and f"Width:\t\t{W}" in printed
    assert jax_h264dec.main([str(src), str(theirs)]) == 0
    write_yuv(H264Decoder(device="cpu").decode_annexb(src.read_bytes()),
              direct)
    assert ours.read_bytes() == theirs.read_bytes() == direct.read_bytes()
    assert len(ours.read_bytes()) == 6 * W * H * 3 // 2


def test_entry_points_default_to_cuda():
    """Without a GPU the decoder, the API and the console raise at their
    default device; nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError):
        H264Decoder()
    with pytest.raises(RuntimeError):
        WelsCreateDecoder()
    with pytest.raises(RuntimeError):
        h264dec.main(["/nonexistent.264"])
