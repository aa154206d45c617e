"""Port parity: the decoder, openh264_tpu_torch.decoder.H264Decoder on
the CPU, against the JAX package's H264Decoder on both of its recon paths
(the numpy batch and use_jax_recon=True), frame for frame and byte for
byte (tolerance 0).

The streams are CAVLC from the port's host encoder at 96x64 and 128x96,
made once per module, in the configurations a Constrained Baseline
sender writes: constant QP, I4x4, intra MBs in P pictures, 4 slices with
2 temporal layers, size-limited slices, LTR with a recovery request
(MMCO and ref-list modification), deblocking_filter_idc 2 with several
slices, a chroma QP offset, screen content with the scroll candidate;
and one whose slice headers carry non-zero alpha/beta offsets, per
slice. Then: chunked input equals the whole stream, empty and garbage
input give no frames; the streams the decoder refused before it took B
slices and the 8x8 transform (a bare B slice appended, CAVLC or CABAC;
a PPS rewritten to the 8x8 transform, with or without scaling lists)
decode as the JAX decoder decodes them; and a stream with an SP slice,
which the decoder does not take, raises NotImplementedError instead of
being concealed.
"""

import numpy as np
import pytest

from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu_torch.bitstream import (NAL_PPS, NAL_SPS, make_annexb_nal,
                                          split_annexb)
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder

from test_torch_streams import (STREAMS, _b_slice, _frames, _headers,
                                _stream, _write_pps)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.poc, g.frame_num, g.is_idr) == (w.poc, w.frame_num,
                                                  w.is_idr)
        for c in "yuv":
            np.testing.assert_array_equal(getattr(g, c), getattr(w, c))


@pytest.mark.parametrize("name", list(STREAMS))
def test_decoder_matches_jax(name):
    bs = _stream(name)
    kw, n, (w, h), _scroll, _calls = STREAMS[name]
    got = H264Decoder(device="cpu").decode_annexb(bs)
    assert len(got) == n
    assert all(f.y.shape == (h, w) and f.u.shape == (h // 2, w // 2)
               for f in got)
    _equal(got, JaxDecoder().decode_annexb(bs))
    _equal(got, JaxDecoder(use_jax_recon=True).decode_annexb(bs))
    # the stream exercises what its name says
    hdrs = _headers(bs)
    per_pic = np.bincount(np.cumsum([s.first_mb_in_slice == 0
                                     for s in hdrs]))
    if name in ("slices4_2tid", "sizelimited", "idc2_slices3", "offsets"):
        assert per_pic.max() > 1
    if name == "slices4_2tid":
        assert any(s.nal.nal_ref_idc == 0 for s in hdrs)
    if name == "ltr_recovery":
        assert any(s.mmco_ops or s.long_term_reference_flag for s in hdrs)
        assert any(s.ref_pic_list_modification[0] for s in hdrs)
    if name == "idc2_slices3":
        assert all(s.disable_deblocking_filter_idc == 2 for s in hdrs)
    if name == "chroma_offset":
        assert hdrs[0].pps.chroma_qp_index_offset == 4
    if name == "offsets":
        assert len({(s.slice_alpha_c0_offset, s.slice_beta_offset)
                    for s in hdrs}) == 3


@pytest.mark.parametrize("name", ["constqp", "sizelimited"])
def test_feed_chunks_equals_whole_stream(name):
    """Odd-sized chunks through feed_annexb, then flush(), give the frames
    of decode_annexb."""
    bs = _stream(name)
    want = H264Decoder(device="cpu").decode_annexb(bs)
    dec = H264Decoder(device="cpu")
    got, pos, sizes = [], 0, [1, 7, 133, 4097, 13]
    k = 0
    while pos < len(bs):
        got += dec.feed_annexb(bs[pos:pos + sizes[k % len(sizes)]])
        pos += sizes[k % len(sizes)]
        k += 1
    got += dec.flush()
    _equal(got, want)


def test_empty_and_garbage_give_no_frames():
    rng = np.random.default_rng(3)
    garbage = rng.integers(1, 256, 5000).astype(np.uint8).tobytes()
    for data in (b"", garbage, b"\x00\x00\x00\x01", b"\x00\x00\x01\x09"):
        assert H264Decoder(device="cpu").decode_annexb(data) == []
        assert JaxDecoder().decode_annexb(data) == []
        dec = H264Decoder(device="cpu")
        assert dec.feed_annexb(data) + dec.flush() == []


def _refused_stream(kind):
    """The constqp stream, or CABAC from the port's encoder, with a B
    slice appended (b_slice, cabac_b_slice) or an SP slice (sp_slice,
    cabac_sp_slice); or the constqp stream with its PPS rewritten to the
    8x8 transform, alone or with scaling lists."""
    if kind.startswith("cabac"):
        enc = H264Encoder(EncoderConfig(width=96, height=64, qp=28,
                                        entropy_cabac=True), device="cpu")
        bs = b"".join(enc.encode_frame(*f) for f in _frames(2, 96, 64))
    else:
        bs = _stream("constqp")
    nals = split_annexb(bs)
    sps = parse_sps(next(n for n in nals if n.nal_unit_type == NAL_SPS).rbsp)
    pps = parse_pps(next(n for n in nals if n.nal_unit_type == NAL_PPS).rbsp,
                    {sps.sps_id: sps})
    if kind.endswith("_slice"):
        return bs + _b_slice(sps, pps, 4, sp=kind.endswith("sp_slice"))
    change = {"transform8": dict(transform8=True),
              "transform8_scaling": dict(transform8=True, scaling=True)}[kind]
    return b"".join(
        make_annexb_nal(n.nal_ref_idc, n.nal_unit_type,
                        _write_pps(pps, **change)
                        if n.nal_unit_type == NAL_PPS else n.rbsp)
        for n in nals)


@pytest.mark.parametrize("kind", ["b_slice", "cabac_b_slice", "transform8",
                                  "transform8_scaling"])
def test_formerly_refused_streams_match_jax(kind):
    """The streams the decoder refused while it took neither B slices nor
    the 8x8 transform now decode as the JAX decoder decodes them, in
    every error-concealment mode: the bare B slice (one mb_skip_run of
    0, then no more data) and the 4x4-coded slices read under an 8x8
    PPS are concealed alike."""
    bs = _refused_stream(kind)
    for ec in (0, 2, 6):
        if ec == 0 and kind.startswith("transform8"):
            # nothing conceals the broken slices: both decoders raise
            for dec in (H264Decoder(device="cpu", ec_mode=0),
                        JaxDecoder(ec_mode=0)):
                with pytest.raises((ValueError, EOFError)):
                    dec.decode_annexb(bs)
            continue
        _equal(H264Decoder(device="cpu", ec_mode=ec).decode_annexb(bs),
               JaxDecoder(ec_mode=ec).decode_annexb(bs))
    dec = H264Decoder(device="cpu")
    _equal(dec.feed_annexb(bs) + dec.flush(), JaxDecoder().decode_annexb(bs))


@pytest.mark.parametrize("kind", ["sp_slice"])
def test_out_of_scope_streams_raise(kind):
    """NotImplementedError comes out of decode_annexb and of feed_annexb /
    flush, in every error-concealment mode: an SP slice is refused, not
    concealed, and no frame of it comes back."""
    bs = _refused_stream(kind)
    for ec in (0, 2, 6):
        with pytest.raises(NotImplementedError):
            H264Decoder(device="cpu", ec_mode=ec).decode_annexb(bs)
    dec = H264Decoder(device="cpu")
    with pytest.raises(NotImplementedError):
        dec.feed_annexb(bs)
        dec.flush()
