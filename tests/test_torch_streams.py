"""Annex-B streams for the port's decoder tests, made and rewritten with
the port's own code (this file imports nothing of JAX, so the card's
tests in test_torch_cuda.py use it too): CAVLC streams from the port's
host encoder in the configurations a Constrained Baseline sender writes,
the stream with per-slice alpha/beta offsets rewritten into its slice
headers, PPS rewrites (the 8x8 transform, slice groups, scaling lists,
default or sent), and a B slice to append. The tests here check the
rewrites themselves: each changes what it says and nothing else.
"""

import functools

import numpy as np
import pytest

from openh264_tpu_torch.bitstream import (BitReader, BitWriter, NAL_IDR,
                                          NAL_PPS, NAL_SLICE, NAL_SPS,
                                          make_annexb_nal, split_annexb)
from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
from openh264_tpu_torch.decoder.slicehdr import parse_slice_header
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.encoder import H264Encoder
from openh264_tpu_torch.tables import ZIGZAG_4x4


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




def _write_pps(p, **changes):
    """A PPS RBSP with the fields of the parsed PPS `p`, and `changes`:
    transform8, groups (slice groups, map type 0), scaling (a scaling
    matrix; with no scaling_lists sent, the default lists), scaling_lists
    (the six 4x4 lists to send, each 16 values in zigzag order)."""
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
            sent = changes.get("scaling_lists") or ()
            for i in range(6 + 2 * changes.get("transform8", False)):
                w.flag(i < len(sent))    # list sent
                last = 8
                for v in (sent[i] if i < len(sent) else ()):
                    w.se((v - last + 128) % 256 - 128)   # delta_scale
                    last = v
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
    if pps.entropy_coding_mode:
        w.ue(0)                          # cabac_init_idc
    w.se(0)                              # slice_qp_delta
    if pps.deblocking_filter_control_present:
        w.ue(0)
        w.se(0)
        w.se(0)
    w.ue(0)                              # mb_skip_run
    w.rbsp_trailing_bits()
    return make_annexb_nal(0, NAL_SLICE, w.get_bytes())


def with_pps(bs, **changes):
    """`bs` with each PPS rewritten by _write_pps(pps, **changes)."""
    nals = split_annexb(bs)
    sps = parse_sps(next(n for n in nals if n.nal_unit_type == NAL_SPS).rbsp)
    out = []
    for n in nals:
        rbsp = n.rbsp
        if n.nal_unit_type == NAL_PPS:
            rbsp = _write_pps(parse_pps(rbsp, {sps.sps_id: sps}), **changes)
        out.append(make_annexb_nal(n.nal_ref_idc, n.nal_unit_type, rbsp))
    return b"".join(out)


def scaling_lists(seed):
    """Six 4x4 scaling lists to send, values 4..64 in zigzag order."""
    rng = np.random.default_rng(seed)
    return tuple(tuple(int(x) for x in rng.integers(4, 65, 16))
                 for _ in range(6))


@pytest.mark.parametrize("changes", [
    {}, dict(transform8=True), dict(groups=2), dict(scaling=True),
    dict(scaling=True, scaling_lists=scaling_lists(1)),
    dict(transform8=True, scaling=True)])
def test_write_pps_round_trip(changes):
    """The rewritten PPS parses to the original's fields and the changes:
    a scaling matrix with no list sent gives the default lists, sent
    lists come back in raster order."""
    bs = _stream("chroma_offset")
    nals = split_annexb(bs)
    sps = parse_sps(nals[0].rbsp)
    p = parse_pps(nals[1].rbsp, {0: sps})
    q = parse_pps(_write_pps(p, **changes), {0: sps})
    for f in ("pps_id", "entropy_coding_mode", "num_ref_idx_l0_active",
              "pic_init_qp", "chroma_qp_index_offset",
              "second_chroma_qp_index_offset", "constrained_intra_pred"):
        assert getattr(q, f) == getattr(p, f), f
    assert q.chroma_qp_index_offset == 4
    assert q.transform_8x8_mode == changes.get("transform8", False)
    assert q.num_slice_groups == changes.get("groups", 1)
    assert q.pic_scaling_matrix_present == changes.get("scaling", False)
    if changes.get("scaling"):
        from openh264_tpu_torch.tables import DEFAULT_SCALING_4x4
        sent = changes.get("scaling_lists")
        for i in range(6):
            want = (np.asarray(sent[i]) if sent else
                    DEFAULT_SCALING_4x4[i // 3][ZIGZAG_4x4])
            np.testing.assert_array_equal(
                q.scaling_lists_4x4[i][ZIGZAG_4x4], want)


def test_with_offsets_changes_only_the_offsets():
    """Each slice of the offsets stream carries its own alpha/beta offsets;
    the rest of its header and its data bits are the encoder's."""
    bs = _stream("offsets")
    kw, n, (w, h), scroll, calls = STREAMS["offsets"]
    enc = H264Encoder(EncoderConfig(width=w, height=h, **kw), device="cpu")
    orig = b"".join(enc.encode_frame(*f) for f in
                    _frames(n, w, h, seed=len("offsets")))
    new, old = _headers(bs), _headers(orig)
    assert len(new) == len(old) == 9
    assert [(s.slice_alpha_c0_offset, s.slice_beta_offset)
            for s in new[:3]] == [(4, -2), (-6, 6), (12, -12)]
    for a, b, na, nb in zip(new, old, *(
            [x for x in split_annexb(s) if x.nal_unit_type in
             (NAL_SLICE, NAL_IDR)] for s in (bs, orig))):
        assert (a.first_mb_in_slice, a.slice_type, a.qp) == \
            (b.first_mb_in_slice, b.slice_type, b.qp)
        np.testing.assert_array_equal(_bits(na.rbsp)[a.header_bits:],
                                      _bits(nb.rbsp)[b.header_bits:])
