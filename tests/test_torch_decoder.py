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
input give no frames, and the streams the decoder does not take (CABAC,
B slices, the 8x8 transform, FMO, scaling lists) raise
NotImplementedError instead of being concealed.
"""

import functools

import numpy as np
import pytest

from openh264_tpu.decoder import H264Decoder as JaxDecoder
from openh264_tpu_torch.bitstream import (BitReader, BitWriter, NAL_IDR,
                                          NAL_PPS, NAL_SLICE, NAL_SPS,
                                          make_annexb_nal, split_annexb)
from openh264_tpu_torch.decoder import H264Decoder
from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
from openh264_tpu_torch.decoder.slicehdr import parse_slice_header
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder


def _frames(n, w, h, seed=0, scroll=0):
    """Textured content drifting a pixel a frame with camera noise and a
    patch of fresh noise each frame (intra MBs in P pictures); with
    `scroll`, screen content whose rows move up `scroll` a frame."""
    rng = np.random.default_rng(seed)
    tall = rng.integers(0, 256, (4 * h, w + 16))
    yy, xx = np.mgrid[0:4 * h, 0:w + 16]
    tex = (tall // 3 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 7.0)
           + 80).clip(0, 255)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    out = []
    for i in range(n):
        if scroll:
            y = tex[h + scroll * i:2 * h + scroll * i, :w].copy()
        else:
            y = tex[h + i:2 * h + i, i:i + w] + rng.integers(-2, 3, (h, w))
            y[:16, w - 32:] = rng.integers(0, 256, (16, 32))
        u = (cx * 3 + cy + 2 * i) % 200 + tall[:h // 2, :w // 2] // 16
        v = (200 - cx - 2 * cy + i) % 200 + tall[h:h + h // 2, :w // 2] // 16
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out


# name: (encoder settings, frames, (width, height), scroll, frame -> call)
STREAMS = {
    "constqp": (dict(qp=28), 4, (96, 64), 0, {}),
    "i4x4": (dict(qp=26, enable_i4x4=True), 3, (96, 64), 0, {}),
    "intra_in_p": (dict(qp=24), 3, (128, 96), 0, {}),
    "slices4_2tid": (dict(qp=28, num_slices=4, temporal_layers=2), 5,
                     (128, 96), 0, {}),
    "sizelimited": (dict(qp=26, slice_size_constraint=200), 3, (96, 64), 0,
                    {}),
    "ltr_recovery": (dict(qp=28, enable_ltr=True, ltr_mark_period=2), 6,
                     (96, 64), 0, {4: "ltr_recovery_request"}),
    "idc2_slices3": (dict(qp=32, num_slices=3, deblock_idc=2), 3, (96, 64),
                     0, {}),
    "chroma_offset": (dict(qp=32, chroma_qp_offset=4), 3, (96, 64), 0, {}),
    "screen_scroll": (dict(qp=28, usage_type=1), 4, (96, 64), 8, {}),
    # slices of 3 per picture, rewritten below with alpha/beta offsets
    "offsets": (dict(qp=34, num_slices=3), 3, (96, 64), 0, {}),
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    kw, n, (w, h), scroll, calls = STREAMS[name]
    enc = H264Encoder(EncoderConfig(width=w, height=h, **kw), device="cpu")
    out = []
    for i, f in enumerate(_frames(n, w, h, seed=len(name), scroll=scroll)):
        if i in calls:
            getattr(enc, calls[i])()
        out.append(enc.encode_frame(*f))
    bs = b"".join(out)
    return _with_offsets(bs) if name == "offsets" else bs


def _headers(bs):
    """The slice headers of a stream, parsed by the port."""
    sps, pps, out = {}, {}, []
    for nal in split_annexb(bs):
        if nal.nal_unit_type == NAL_SPS:
            s = parse_sps(nal.rbsp)
            sps[s.sps_id] = s
        elif nal.nal_unit_type == NAL_PPS:
            p = parse_pps(nal.rbsp, sps)
            pps[p.pps_id] = p
        elif nal.nal_unit_type in (NAL_SLICE, NAL_IDR):
            out.append(parse_slice_header(BitReader(nal.rbsp), nal, sps,
                                          pps))
    return out


def _bits(rbsp):
    """The RBSP's bits up to and without its stop bit."""
    b = np.unpackbits(np.frombuffer(rbsp, np.uint8))
    return b[:np.flatnonzero(b)[-1]]


def _rbsp(bits):
    w = BitWriter()
    for x in bits:
        w.u(1, int(x))
    w.rbsp_trailing_bits()
    return w.get_bytes()


def _with_offsets(bs):
    """Each slice's slice_alpha_c0_offset_div2 / slice_beta_offset_div2,
    the header's last two fields (se(0) from the encoder), rewritten to
    values that differ per slice; the slice data follows unchanged."""
    div2 = [(2, -1), (-3, 3), (6, -6)]
    out, k = [], 0
    for nal, sh in zip(*_nals_and_headers(bs)):
        if sh is None:
            out.append(make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type,
                                       nal.rbsp))
            continue
        bits = _bits(nal.rbsp)
        pos = sh.header_bits
        assert sh.disable_deblocking_filter_idc != 1 and \
            list(bits[pos - 2:pos]) == [1, 1]
        a, b = div2[k % 3]
        k += 1
        w = BitWriter()
        w.se(a)
        w.se(b)
        n_mid = w.nbits
        mid = np.unpackbits(np.frombuffer(_pad(w), np.uint8))[:n_mid]
        out.append(make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type,
                                   _rbsp(np.concatenate(
                                       [bits[:pos - 2], mid, bits[pos:]]))))
    return b"".join(out)


def _pad(w):
    while not w.byte_aligned():
        w.u(1, 0)
    return w.get_bytes()


def _nals_and_headers(bs):
    nals = split_annexb(bs)
    hdrs = iter(_headers(bs))
    return nals, [next(hdrs) if n.nal_unit_type in (NAL_SLICE, NAL_IDR)
                  else None for n in nals]


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


def _write_pps(p, **changes):
    """A PPS RBSP with the fields of the parsed PPS `p`, and `changes`:
    transform8, groups (slice groups, map type 0), scaling (a scaling
    matrix with no list sent, so the default lists)."""
    w = BitWriter()
    w.ue(p.pps_id)
    w.ue(p.sps_id)
    w.flag(p.entropy_coding_mode)
    w.flag(p.pic_order_present)
    groups = changes.get("groups", 1)
    w.ue(groups - 1)
    if groups > 1:
        w.ue(0)                          # slice_group_map_type 0
        for _ in range(groups):
            w.ue(3)                      # run_length_minus1
    w.ue(p.num_ref_idx_l0_active - 1)
    w.ue(p.num_ref_idx_l1_active - 1)
    w.flag(p.weighted_pred)
    w.u(2, p.weighted_bipred_idc)
    w.se(p.pic_init_qp - 26)
    w.se(p.pic_init_qs - 26)
    w.se(p.chroma_qp_index_offset)
    w.flag(p.deblocking_filter_control_present)
    w.flag(p.constrained_intra_pred)
    w.flag(p.redundant_pic_cnt_present)
    if changes.get("transform8") or changes.get("scaling"):
        w.flag(changes.get("transform8", False))
        w.flag(changes.get("scaling", False))
        if changes.get("scaling"):
            for _ in range(6 + 2 * changes.get("transform8", False)):
                w.flag(False)            # list not sent
        w.se(p.second_chroma_qp_index_offset)
    w.rbsp_trailing_bits()
    return w.get_bytes()


def _b_slice(sps, pps, frame_num):
    """A non-reference B slice NAL (header, then a few data bits)."""
    w = BitWriter()
    w.ue(0)                              # first_mb_in_slice
    w.ue(6)                              # slice_type B (all same type)
    w.ue(pps.pps_id)
    w.u(sps.log2_max_frame_num, frame_num % (1 << sps.log2_max_frame_num))
    assert sps.pic_order_cnt_type in (0, 2)
    if sps.pic_order_cnt_type == 0:
        w.u(sps.log2_max_pic_order_cnt_lsb, 1)
    w.flag(True)                         # direct_spatial_mv_pred
    w.flag(False)                        # num_ref_idx_active_override
    w.flag(False)                        # ref_pic_list_modification l0
    w.flag(False)                        # ... l1
    w.se(0)                              # slice_qp_delta
    if pps.deblocking_filter_control_present:
        w.ue(0)
        w.se(0)
        w.se(0)
    w.ue(0)                              # mb_skip_run
    w.rbsp_trailing_bits()
    return make_annexb_nal(0, NAL_SLICE, w.get_bytes())


def _refused_stream(kind):
    """A stream the decoder does not take: CABAC from the port's encoder,
    or the constqp stream with its PPS rewritten (the 8x8 transform, FMO,
    scaling lists) or a B slice appended."""
    if kind == "cabac":
        enc = H264Encoder(EncoderConfig(width=96, height=64, qp=28,
                                        entropy_cabac=True), device="cpu")
        return b"".join(enc.encode_frame(*f) for f in _frames(2, 96, 64))
    bs = _stream("constqp")
    nals = split_annexb(bs)
    sps = parse_sps(next(n for n in nals if n.nal_unit_type == NAL_SPS).rbsp)
    pps = parse_pps(next(n for n in nals if n.nal_unit_type == NAL_PPS).rbsp,
                    {sps.sps_id: sps})
    if kind == "b_slice":
        return bs + _b_slice(sps, pps, 4)
    change = {"transform8": dict(transform8=True), "fmo": dict(groups=2),
              "scaling_lists": dict(scaling=True)}[kind]
    return b"".join(
        make_annexb_nal(n.nal_ref_idc, n.nal_unit_type,
                        _write_pps(pps, **change)
                        if n.nal_unit_type == NAL_PPS else n.rbsp)
        for n in nals)


@pytest.mark.parametrize("kind", ["cabac", "b_slice", "transform8", "fmo",
                                  "scaling_lists"])
def test_out_of_scope_streams_raise(kind):
    """NotImplementedError comes out of decode_annexb and of feed_annexb /
    flush, in every error-concealment mode: such a slice is refused, not
    concealed, and no frame of it comes back."""
    bs = _refused_stream(kind)
    for ec in (0, 2, 6):
        with pytest.raises(NotImplementedError):
            H264Decoder(device="cpu", ec_mode=ec).decode_annexb(bs)
    dec = H264Decoder(device="cpu")
    with pytest.raises(NotImplementedError):
        dec.feed_annexb(bs)
        dec.flush()
