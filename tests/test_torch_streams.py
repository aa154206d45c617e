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
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from openh264_tpu_torch.bitstream import (BitReader, BitWriter, NAL_IDR,
                                          NAL_PPS, NAL_SLICE, NAL_SPS, NalUnit,
                                          make_annexb_nal, split_annexb)
from openh264_tpu_torch.decoder.cabac import (CTX_B_SKIP, CTX_CBP, CTX_CIPR,
                                              CTX_DELTA_QP, CTX_LAST,
                                              CTX_LAST_8x8, CTX_MAP,
                                              CTX_MAP_8x8, CTX_MB_TYPE_B,
                                              CTX_MB_TYPE_B_INTRA,
                                              CTX_MB_TYPE_I, CTX_REF_NO,
                                              CTX_SKIP, STATE_TRANS,
                                              CabacContexts, CabacEngine)
from openh264_tpu_torch.decoder.params import parse_pps, parse_sps
from openh264_tpu_torch.decoder.slicehdr import I_SLICE, parse_slice_header
from openh264_tpu_torch.encoder.cabac_enc import CabacEncoder
from openh264_tpu_torch.encoder.config import EncoderConfig
from openh264_tpu_torch.encoder.cavlc_enc import write_residual_block
from openh264_tpu_torch.encoder.encoder import H264Encoder
from openh264_tpu_torch.tables import ZIGZAG_4x4
from openh264_tpu_torch.tables.cavlc import CBP_INTER_INV, CBP_INTRA_INV


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


# PPS fields that _write_pps takes from `changes` where given
_PPS_OVERRIDES = ("pps_id", "entropy_coding_mode", "num_ref_idx_l0_active",
                  "num_ref_idx_l1_active", "weighted_bipred_idc",
                  "chroma_qp_index_offset", "second_chroma_qp_index_offset")


def _write_pps(p, **changes):
    """A PPS RBSP with the fields of the parsed PPS `p`, and `changes`:
    any field of _PPS_OVERRIDES, transform8, groups (slice groups, map
    type 0), scaling (a scaling matrix; with no scaling_lists sent, the
    default lists), scaling_lists (the six 4x4 lists to send, each 16
    values in zigzag order), scaling_lists8 (the two 8x8 lists to send,
    64 values in zigzag order; with transform8)."""
    p = SimpleNamespace(**{**vars(p), **{k: v for k, v in changes.items()
                                         if k in _PPS_OVERRIDES}})
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
            sent = list(changes.get("scaling_lists") or ())
            sent += [None] * (6 - len(sent))
            sent += list(changes.get("scaling_lists8") or ())
            for i in range(6 + 2 * changes.get("transform8", False)):
                lst = sent[i] if i < len(sent) else None
                w.flag(lst is not None)  # list sent
                last = 8
                for v in (lst if lst is not None else ()):
                    w.se((v - last + 128) % 256 - 128)   # delta_scale
                    last = v
        w.se(p.second_chroma_qp_index_offset)
    w.rbsp_trailing_bits()
    return w.get_bytes()


def _b_slice(sps, pps, frame_num, sp=False):
    """A non-reference B slice NAL (header, then a few data bits); with
    `sp`, an SP slice instead."""
    w = BitWriter()
    w.ue(0)                              # first_mb_in_slice
    w.ue(8 if sp else 6)                 # slice_type SP / B (all same type)
    w.ue(pps.pps_id)
    w.u(sps.log2_max_frame_num, frame_num % (1 << sps.log2_max_frame_num))
    assert sps.pic_order_cnt_type in (0, 2)
    if sps.pic_order_cnt_type == 0:
        w.u(sps.log2_max_pic_order_cnt_lsb, 1)
    if not sp:
        w.flag(True)                     # direct_spatial_mv_pred
    w.flag(False)                        # num_ref_idx_active_override
    w.flag(False)                        # ref_pic_list_modification l0
    if not sp:
        w.flag(False)                    # ... l1
    if pps.entropy_coding_mode:
        w.ue(0)                          # cabac_init_idc
    w.se(0)                              # slice_qp_delta
    if sp:
        w.flag(False)                    # sp_for_switch_flag
        w.se(0)                          # slice_qs_delta
    if pps.deblocking_filter_control_present:
        w.ue(0)
        w.se(0)
        w.se(0)
    w.ue(0)                              # mb_skip_run
    w.rbsp_trailing_bits()
    return make_annexb_nal(0, NAL_SLICE, w.get_bytes())


# ---------------------------------------------------------------------------
# B pictures and the 8x8 transform, written here
# ---------------------------------------------------------------------------
def write_sps(s, log2_poc_lsb=8, num_ref_frames=3, direct_8x8=True):
    """A High-profile (100) SPS RBSP with the fields of the parsed SPS `s`
    (its VUI dropped), POC type 0, `num_ref_frames` and
    direct_8x8_inference `direct_8x8`: under it, decode order may differ
    from output order."""
    assert s.frame_mbs_only
    w = BitWriter()
    w.u(8, 100)                          # profile_idc: High
    w.u(8, 0)                            # constraint flags
    w.u(8, s.level_idc)
    w.ue(s.sps_id)
    w.ue(1)                              # chroma_format_idc 4:2:0
    w.ue(0)                              # bit_depth_luma_minus8
    w.ue(0)                              # bit_depth_chroma_minus8
    w.flag(False)                        # qpprime_y_zero_transform_bypass
    w.flag(False)                        # seq_scaling_matrix_present
    w.ue(s.log2_max_frame_num - 4)
    w.ue(0)                              # pic_order_cnt_type
    w.ue(log2_poc_lsb - 4)
    w.ue(num_ref_frames)
    w.flag(False)                        # gaps_in_frame_num_allowed
    w.ue(s.mb_width - 1)
    w.ue(s.mb_height - 1)
    w.flag(True)                         # frame_mbs_only
    w.flag(direct_8x8)                   # direct_8x8_inference
    crop = (s.crop_left, s.crop_right, s.crop_top, s.crop_bottom)
    w.flag(any(crop))
    for c in crop if any(crop) else ():
        w.ue(c)
    w.flag(False)                        # vui_parameters_present
    w.rbsp_trailing_bits()
    return w.get_bytes()


def with_poc_lsb(nal, sh, lsb, log2_poc_lsb=8):
    """The slice NAL `nal` (header `sh`, parsed under a POC type 2 SPS)
    with pic_order_cnt_lsb `lsb` inserted after its frame_num (and
    idr_pic_id), as a POC type 0 SPS reads it; CABAC slice data moves
    with its alignment bits to the next byte."""
    br = BitReader(nal.rbsp)
    br.ue()
    br.ue()
    br.ue()
    br.u(sh.sps.log2_max_frame_num)
    if sh.is_idr:
        br.ue()
    pos, hb = br.pos, sh.header_bits
    ins = np.array([(lsb >> (log2_poc_lsb - 1 - k)) & 1
                    for k in range(log2_poc_lsb)], np.uint8)
    if not sh.pps.entropy_coding_mode:
        bits = _bits(nal.rbsp)
        rbsp = _rbsp(np.concatenate([bits[:pos], ins, bits[pos:]]))
    else:
        allb = np.unpackbits(np.frombuffer(nal.rbsp, np.uint8))
        head = np.concatenate([allb[:pos], ins, allb[pos:hb]])
        pad = np.ones(-len(head) % 8, np.uint8)    # cabac_alignment_one_bit
        rbsp = np.packbits(np.concatenate(
            [head, pad, allb[-(-hb // 8) * 8:]])).tobytes()
    return make_annexb_nal(nal.nal_ref_idc, nal.nal_unit_type, rbsp)


def write_slice_header_b(w, sps, pps, frame_num, poc_lsb, slice_type=6,
                         spatial=True, n_active=None, mod_l1=None,
                         weights=None, qp=28, nal_ref_idc=0, first_mb=0):
    """The header of a non-IDR slice under a POC type 0 SPS: B (6, or 1),
    P (5) or I (7), from MB `first_mb`. n_active: (l0, l1) written as the
    override; mod_l1: abs_diff_pic_num_minus1 of one L1 modification;
    weights: (luma_denom, chroma_denom, {(lx, ref): (lw, lo, (cw, co),
    (cw, co))}) for weighted_bipred_idc 1; the slice QP `qp`; a reference
    slice (nal_ref_idc > 0) keeps the sliding window."""
    t = slice_type % 5
    w.ue(first_mb)                       # first_mb_in_slice
    w.ue(slice_type)
    w.ue(pps.pps_id)
    w.u(sps.log2_max_frame_num, frame_num % (1 << sps.log2_max_frame_num))
    w.u(sps.log2_max_pic_order_cnt_lsb,
        poc_lsb % (1 << sps.log2_max_pic_order_cnt_lsb))
    if t == 1:
        w.flag(spatial)                  # direct_spatial_mv_pred
    if t in (0, 1):
        w.flag(n_active is not None)     # num_ref_idx_active_override
        if n_active is not None:
            w.ue(n_active[0] - 1)
            if t == 1:
                w.ue(n_active[1] - 1)
        w.flag(False)                    # ref_pic_list_modification l0
    if t == 1:
        w.flag(mod_l1 is not None)       # ref_pic_list_modification l1
        if mod_l1 is not None:
            w.ue(0)                      # modification_of_pic_nums_idc 0
            w.ue(mod_l1)
            w.ue(3)
    if t == 1 and pps.weighted_bipred_idc == 1:
        ld, cd, table = weights
        w.ue(ld)
        w.ue(cd)
        n0, n1 = n_active or (pps.num_ref_idx_l0_active,
                              pps.num_ref_idx_l1_active)
        for lx, n in ((0, n0), (1, n1)):
            for r in range(n):
                lw, lo, *cwo = table.get((lx, r), (None, None))
                w.flag(lw is not None)   # luma_weight_flag
                if lw is not None:
                    w.se(lw)
                    w.se(lo)
                w.flag(bool(cwo))        # chroma_weight_flag
                for cw, co in cwo:
                    w.se(cw)
                    w.se(co)
    if nal_ref_idc:
        w.flag(False)                    # adaptive_ref_pic_marking_mode
    if pps.entropy_coding_mode and t != 2:
        w.ue(0)                          # cabac_init_idc
    w.se(qp - pps.pic_init_qp)           # slice_qp_delta
    if pps.deblocking_filter_control_present:
        w.ue(0)
        w.se(0)
        w.se(0)


# two-partition B mb_type 4..21 as (16x8?, mode of part 0, of part 1);
# modes 0 L0, 1 L1, 2 BI (Table 7-14)
B_TWOPART = [(t % 2 == 0, m) for t, m in enumerate(
    m for m in [(0, 0), (1, 1), (0, 1), (1, 0), (0, 2), (1, 2), (2, 0),
                (2, 1), (2, 2)] for _ in range(2))]
# B sub_mb_type 0..12 as (mode, partitions; -1 = direct) (Table 7-18)
B_SUB = [(-1, 4), (0, 1), (1, 1), (2, 1), (0, 2), (0, 2), (1, 2), (1, 2),
         (2, 2), (2, 2), (0, 4), (1, 4), (2, 4)]
# the MB kinds CavlcBWriter writes
B_KINDS = ("skip", "direct", "l0", "l1", "bi", "16x8", "8x16", "8x8",
           "i8x8", "i4x4")


class CavlcBWriter:
    """Writes the CAVLC data of one B slice (the whole picture, raster
    order): B_Skip runs, B_Direct_16x16, B_L0/L1/Bi_16x16, B_16x8 and
    B_8x16 (at least one BI partition each), B_8x8 with direct and other
    sub-MBs, and I_NxN MBs (I8x8 under a transform_8x8_mode PPS), with
    random modes (or one chroma_mode), vectors, refs, cbp and
    coefficients. It keeps the
    decoder's total-coefficient grids, from which each residual block
    takes its nC; the residual blocks go through the port's
    encoder/cavlc_enc.py."""

    def __init__(self, mb_w, mb_h, pps, n_active, qp, rng,
                 chroma_mode=None):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.chroma_mode = chroma_mode   # of every intra MB; None: random
        self.t8 = bool(pps.transform_8x8_mode)
        self.n_active = n_active
        self.qp = qp
        self.rng = rng
        self.nzc_l = np.zeros((4 * mb_h, 4 * mb_w), np.int32)
        self.nzc_c = np.zeros((2, 2 * mb_h, 2 * mb_w), np.int32)

    def write(self, w, kinds):
        """Writes the MBs of `kinds` (one per MB, from B_KINDS)."""
        run = 0
        for idx, kind in enumerate(kinds):
            if kind == "skip":
                run += 1
                continue
            w.ue(run)                    # mb_skip_run
            run = 0
            self._mb(w, idx, kind)
        if run:
            w.ue(run)
        w.rbsp_trailing_bits()

    # -- syntax ---------------------------------------------------------
    def _ref(self, w, lx):
        n = self.n_active[lx]
        r = int(self.rng.integers(0, n))
        if n == 2:
            w.u(1, 1 - r)                # te(v) with range 1
        elif n > 2:
            w.ue(r)

    def _mvd(self, w):
        for _ in range(2):
            w.se(int(self.rng.integers(-9, 10)))

    def _mb(self, w, idx, kind):
        rng = self.rng
        if kind in ("i8x8", "i4x4"):
            w.ue(23)                     # I_NxN in a B slice
            t8 = kind == "i8x8"
            if self.t8:
                w.flag(t8)
            for _ in range(4 if t8 else 16):
                if rng.random() < 0.4:
                    w.flag(True)         # prev_intra_pred_mode_flag
                else:
                    w.flag(False)
                    w.u(3, int(rng.integers(0, 8)))
            w.ue(int(rng.integers(0, 4)) if self.chroma_mode is None
                 else self.chroma_mode)  # intra_chroma_pred_mode
            cbp = int(rng.integers(0, 48))
            w.ue(int(CBP_INTRA_INV[cbp]))
            self._residual(w, idx, cbp, t8)
            return
        t8_allowed = True
        if kind == "direct":
            w.ue(0)
        elif kind in ("l0", "l1", "bi"):
            mode = ("l0", "l1", "bi").index(kind)
            w.ue(1 + mode)
            lists = [lx for lx in (0, 1) if mode in (lx, 2)]
            for lx in lists:
                self._ref(w, lx)
            for lx in lists:
                self._mvd(w)
        elif kind in ("16x8", "8x16"):
            # a two-partition type with a BI partition
            t = 2 * int(rng.integers(4, 9)) + (kind == "8x16")
            modes = B_TWOPART[t][1]
            w.ue(4 + t)
            for lx in (0, 1):
                for m in modes:
                    if m in (lx, 2):
                        self._ref(w, lx)
            for lx in (0, 1):
                for m in modes:
                    if m in (lx, 2):
                        self._mvd(w)
        else:                            # 8x8: a direct sub-MB and others
            subs = [0] + [int(x) for x in rng.integers(0, 13, 3)]
            if rng.random() < 0.5:
                subs = [0] + [int(x) for x in rng.integers(1, 4, 3)]
            rng.shuffle(subs)
            w.ue(22)
            for t in subs:
                w.ue(t)
            for lx in (0, 1):
                for t in subs:
                    if B_SUB[t][0] in (lx, 2):
                        self._ref(w, lx)
            for lx in (0, 1):
                for t in subs:
                    if B_SUB[t][0] in (lx, 2):
                        for _ in range(B_SUB[t][1]):
                            self._mvd(w)
            t8_allowed = all(t <= 3 for t in subs)
        cbp = int(rng.integers(0, 48)) if rng.random() < 0.75 else 0
        w.ue(int(CBP_INTER_INV[cbp]))
        t8 = False
        if (cbp & 15) and self.t8 and t8_allowed:
            t8 = bool(rng.random() < 0.6)
            w.flag(t8)                   # transform_size_8x8_flag
        if cbp:
            self._residual(w, idx, cbp, t8)
        else:
            self._zero_nzc(idx)

    # -- residual --------------------------------------------------------
    def _levels(self, n):
        rng = self.rng
        lv = np.zeros(n, np.int32)
        k = int(rng.integers(0, min(n, 6) + 1))
        pos = rng.choice(min(n, 12), k, replace=False)
        lv[pos] = rng.choice([-3, -2, -1, 1, 1, 2, 3, 9, -17], k)
        return lv

    @staticmethod
    def _nc(grid, x, y):
        na = int(grid[y, x - 1]) if x > 0 else -1
        nb = int(grid[y - 1, x]) if y > 0 else -1
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        return max(na, nb, 0)

    def _zero_nzc(self, idx):
        mbx, mby = idx % self.mb_w, idx // self.mb_w
        self.nzc_l[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
        self.nzc_c[:, 2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0

    def _residual(self, w, idx, cbp, t8):
        mbx, mby = idx % self.mb_w, idx // self.mb_w
        if cbp:
            dqp = int(self.rng.integers(-2, 3))
            if not 20 <= self.qp + dqp <= 36:
                dqp = 0
            self.qp += dqp
            w.se(dqp)                    # mb_qp_delta
        for blk8 in range(4):
            gx0 = 4 * mbx + 2 * (blk8 % 2)
            gy0 = 4 * mby + 2 * (blk8 // 2)
            if not cbp & (1 << blk8):
                self.nzc_l[gy0:gy0 + 2, gx0:gx0 + 2] = 0
                continue
            # 8x8: four 4x4 CAVLC blocks interleaved in the 8x8 scan
            lv8 = self._levels(64) if t8 else None
            for sub in range(4):         # the z-scan order of the quadrant
                gx, gy = gx0 + sub % 2, gy0 + sub // 2
                lv = lv8[sub::4] if t8 else self._levels(16)
                self.nzc_l[gy, gx] = write_residual_block(
                    w, lv, self._nc(self.nzc_l, gx, gy), 16)
        if cbp & 0x30:
            for _ in range(2):
                write_residual_block(w, self._levels(4), -1, 4)
        if cbp & 0x20:
            for comp in range(2):
                for k in range(4):
                    cx, cy = 2 * mbx + k % 2, 2 * mby + k // 2
                    self.nzc_c[comp, cy, cx] = write_residual_block(
                        w, self._levels(15), self._nc(self.nzc_c[comp], cx,
                                                      cy), 15)
        else:
            self.nzc_c[:, 2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = 0


def scaling_changes(seed):
    """_write_pps changes that send seeded 4x4 and 8x8 scaling lists."""
    rng = np.random.default_rng(seed + 50)
    return dict(scaling=True, scaling_lists=scaling_lists(seed),
                scaling_lists8=tuple(
                    tuple(int(x) for x in rng.integers(4, 65, 64))
                    for _ in range(2)))


def b_kinds(mb_w, mb_h, rng):
    """A random MB plan with every kind of B_KINDS, skip runs included.
    The intra MBs lie off the picture's top row and left column: their
    random modes then never predict from a missing neighbour."""
    n_mb = mb_w * mb_h
    inner = [i for i in range(n_mb) if i % mb_w and i >= mb_w]
    kinds = [None] * n_mb
    for i, k in zip(rng.permutation(inner)[:2], ("i8x8", "i4x4")):
        kinds[int(i)] = k
    rest = [i for i in range(n_mb) if kinds[i] is None]
    need = [k for k in B_KINDS if k[0] != "i"] + ["skip"]
    extra = rng.choice(B_KINDS, len(rest) - len(need))
    for i, k in zip(rng.permutation(rest), need + list(extra)):
        kinds[int(i)] = str(k) if (k[0] != "i" or i in inner) else "bi"
    return kinds


def b_stream(idc=0, scaling=False, w=96, h=64, seed=0, n_pairs=2,
             plans=None, chroma_mode=None):
    """IDR and P pictures from the port's CAVLC H264Encoder (qp 28) under
    a rewritten High-profile SPS of POC type 0, the encoder's PPS 0, and
    after each P a non-reference B picture under a second PPS (pps_id 1:
    transform_8x8_mode, weighted_bipred_idc `idc`, with `scaling` sent
    4x4 and 8x8 scaling lists) written by CavlcBWriter. The B pictures
    come between their references in output order (POCs 0, 8, 16, ...
    for the I/P pictures, 2, 14, 18, 30, ... for the Bs, so that implicit
    weights are not 32/32). The B after the 1st, 3rd, ... P uses spatial
    direct, two refs per list and an L1 modification; the B after the
    2nd, 4th, ... P temporal direct and one ref per list. Returns
    (Annex-B bytes, the B pictures' MB plans in decode order). plans: the
    B pictures' MB plans instead of b_kinds'; chroma_mode:
    CavlcBWriter's."""
    enc = H264Encoder(EncoderConfig(width=w, height=h, qp=28), device="cpu")
    frames = _frames(1 + n_pairs, w, h, seed=seed)
    enc_bs = b"".join(enc.encode_frame(*f) for f in frames)
    nals, hdrs = _nals_and_headers(enc_bs)
    sps0 = parse_sps(nals[0].rbsp)
    pps0 = parse_pps(nals[1].rbsp, {sps0.sps_id: sps0})
    sps_rbsp = write_sps(sps0)
    sps = parse_sps(sps_rbsp)
    changes = dict(pps_id=1, transform8=True, weighted_bipred_idc=idc,
                   num_ref_idx_l0_active=1, num_ref_idx_l1_active=1)
    if scaling:
        changes.update(scaling_changes(seed))
    pps1_rbsp = _write_pps(pps0, **changes)
    pps1 = parse_pps(pps1_rbsp, {sps.sps_id: sps})
    out = [make_annexb_nal(3, NAL_SPS, sps_rbsp), make_annexb_nal(
        3, NAL_PPS, nals[1].rbsp), make_annexb_nal(3, NAL_PPS, pps1_rbsp)]
    rng = np.random.default_rng(seed)
    used = []
    pics = [(n, sh) for n, sh in zip(nals, hdrs) if sh is not None]
    for k, (nal, sh) in enumerate(pics):
        out.append(with_poc_lsb(nal, sh, 8 * k))
        if k == 0:
            continue
        spatial = k % 2 == 1
        n_active = (2, 2) if spatial else (1, 1)
        weights = None
        if idc == 1:
            weights = (5, 3, {(lx, r): (
                int(rng.integers(20, 45)), int(rng.integers(-8, 9)),
                *([(int(rng.integers(4, 13)), int(rng.integers(-6, 7)))
                   for _ in range(2)] if rng.random() < 0.7 else []))
                for lx in (0, 1) for r in range(n_active[0])})
        bw = BitWriter()
        write_slice_header_b(bw, sps, pps1, sh.frame_num + 1,
                             8 * k - 6 if spatial else 8 * k - 2,
                             spatial=spatial, n_active=n_active,
                             mod_l1=1 if spatial else None, weights=weights)
        plan = plans[k - 1] if plans else b_kinds(sps.mb_width,
                                                  sps.mb_height, rng)
        CavlcBWriter(sps.mb_width, sps.mb_height, pps1, n_active, 28, rng,
                     chroma_mode).write(bw, plan)
        out.append(make_annexb_nal(0, NAL_SLICE, bw.get_bytes()))
        used.append(plan)
    return b"".join(out), used


# ---------------------------------------------------------------------------
# CABAC slices of seeded random bins
# ---------------------------------------------------------------------------
class BinChooser(CabacEngine):
    """A CABAC decoding engine that reads no bits: it chooses each bin
    from a seeded generator, keeps the contexts as decoding that bin
    would, and records it. Run in place of the engine of the port's CABAC
    parser, it makes the parser walk a slice of random syntax with its
    own context selection; encoding the recorded bins with the port's
    CabacEncoder then gives slice data that any decoder parses to those
    same bins. Every bin is random (1 with probability 0.5) except:
    intra_chroma_pred_mode and the I16x16 prediction mode are DC, so no
    intra MB predicts from a missing neighbour (the per-MB Python intra
    recon of a picture with I8x8 MBs cannot take that, reference fault
    C7 in ROADMAP.md); the IPCM escape is never taken; ref_idx and
    mb_qp_delta lean to small values, mb_skip_flag to 0, a B mb_type
    away from B_Direct_16x16 and B_X_16x16 (so that B_8x8 and the intra
    types, 1/16 of the rest each, come often), coded_block_pattern and
    significant_coeff_flag to 0 (short residual blocks); and
    end_of_slice_flag is 1 exactly at MB `end_mb`."""

    __slots__ = ("rng", "bins", "end_mb", "_pair")
    # contexts whose bin is fixed: chroma DC; I-slice I16x16 mode DC (2)
    _FIXED = {**{CTX_CIPR + i: 0 for i in range(4)},
              CTX_MB_TYPE_I + 6: 1, CTX_MB_TYPE_I + 7: 0}
    # contexts of the two I16x16 mode bins of P and B slices: 1 then 0
    _PAIRS = (CTX_SKIP + 9, CTX_MB_TYPE_B_INTRA + 3)
    _P_ONE = {CTX_REF_NO + 4: 0.25, CTX_REF_NO + 5: 0.25,
              **{CTX_DELTA_QP + i: 0.15 for i in range(4)},
              **{CTX_SKIP + i: 0.3 for i in range(3)},
              **{CTX_B_SKIP + i: 0.3 for i in range(3)},
              **{CTX_MB_TYPE_B + i: 0.8 for i in range(4)},
              **{CTX_CBP + i: 0.4 for i in range(12)},
              **{CTX_MAP + i: 0.25 for i in range(CTX_LAST - CTX_MAP)},
              **{CTX_MAP_8x8 + i: 0.25
                 for i in range(CTX_LAST_8x8 - CTX_MAP_8x8)}}

    def __init__(self, rng, end_mb):
        self.rng, self.end_mb = rng, end_mb
        self.bins, self._pair = [], False
        self.data, self.nbits, self.pos = b"", 0, 0
        self.range, self.offset = 510, 0

    def choose(self, idx):
        """The bin of a decision at context `idx`."""
        if idx in self._FIXED:
            return self._FIXED[idx]
        if idx in self._PAIRS:
            self._pair = not self._pair
            return 1 if self._pair else 0
        return int(self.rng.random() < self._P_ONE.get(idx, 0.5))

    def decision(self, ctx, idx):
        bit = self.choose(idx)
        state = ctx.state[idx]
        if bit != ctx.mps[idx]:
            if state == 0:
                ctx.mps[idx] ^= 1
            ctx.state[idx] = STATE_TRANS[state, 0]
        else:
            ctx.state[idx] = STATE_TRANS[state, 1]
        self.bins.append((0, idx, bit))
        return bit

    def choose_bypass(self):
        """The bin of a bypass decision."""
        return int(self.rng.random() < 0.5)

    def bypass(self):
        bit = self.choose_bypass()
        self.bins.append((1, 0, bit))
        return bit

    def terminate(self):
        caller = sys._getframe(1)
        bit = int(caller.f_code.co_name == "decode_slice_mbs_cabac" and
                  caller.f_locals["mb_idx"] >= self.end_mb)
        self.bins.append((2, 0, bit))
        return bit

    def encode(self, sh):
        """The recorded bins as CABAC slice data of the slice `sh`."""
        enc = CabacEncoder()
        ctx = CabacContexts(sh.slice_type == I_SLICE, sh.cabac_init_idc,
                            int(np.clip(sh.qp, 0, 51)))
        for kind, idx, bit in self.bins:
            if kind == 0:
                enc.decision(ctx, idx, bit)
            elif kind == 1:
                enc.bypass(bit)
            else:
                enc.terminate(bit)
        return enc


def steer_picture(dec, headers, seed, chooser=None):
    """The CABAC slice NALs of one picture of seeded random bins (see
    BinChooser). dec: the port's H264Decoder on the CPU that has decoded
    the stream so far; headers: per slice (nal_ref_idc, nal_unit_type,
    BitWriter holding the slice header, the MB one past the slice's
    last). The Python parser (decode_slice_mbs_cabac, in the host C's
    place) walks each slice under BinChooser (or the subclass `chooser`)
    with its residual bins in Python (residual_levels_plain), and `dec`
    decodes the picture those bins make, so that it can steer the next
    one."""
    import openh264_tpu_torch.decoder.slice_dec_cabac as sdc
    import openh264_tpu_torch.decoder.cbind as cbind
    rng = np.random.default_rng(seed)
    ends = [end for *_x, end in headers]
    choosers, pending = [], []
    for ref_idc, typ, w, _end in headers:
        head = np.packbits(w.bit_array()).tobytes()
        nal = NalUnit(ref_idc, typ, head + b"\xff" * 4, None)
        br = BitReader(nal.rbsp)
        pending.append((nal, parse_slice_header(br, nal, dec.sps_map,
                                                dec.pps_map), br))

    def engine(_rbsp, _bitpos):
        choosers.append((chooser or BinChooser)(rng, ends[len(choosers)]))
        return choosers[-1]

    def plain_levels(self, prop):
        return sdc.residual_levels_plain(self.eng, self.bctx, prop)
    saved = (sdc.CabacEngine, sdc.CabacSliceDecoder.residual_levels,
             cbind.parse_cabac_slice_native)
    sdc.CabacEngine = engine
    sdc.CabacSliceDecoder.residual_levels = plain_levels
    cbind.parse_cabac_slice_native = sdc.decode_slice_mbs_cabac
    try:
        dec._decode_picture(pending)
    finally:
        (sdc.CabacEngine, sdc.CabacSliceDecoder.residual_levels,
         cbind.parse_cabac_slice_native) = saved
    out = []
    for (ref_idc, typ, w, _end), (_n, sh, _br), ch in zip(headers, pending,
                                                          choosers):
        w.byte_align(1)                  # cabac_alignment_one_bit
        ch.encode(sh).write_to(w)
        out.append(make_annexb_nal(ref_idc, typ, w.get_bytes()))
    return out


def cabac_prefix(enc_bs, idc, scaling, seed, direct_8x8=True):
    """The parameter sets and pictures of a CABAC stream from the port's
    encoder (`enc_bs`) under a High-profile SPS of POC type 0 (POCs 0, 8,
    16, ...), the encoder's PPS 0, and a second PPS (pps_id 1: CABAC,
    transform_8x8_mode, weighted_bipred_idc `idc`, two refs per list,
    with `scaling` sent 4x4 and 8x8 scaling lists), the SPS's
    direct_8x8_inference `direct_8x8`. Returns (the bytes, the SPS, PPS 1,
    the number of pictures)."""
    nals, hdrs = _nals_and_headers(enc_bs)
    sps0 = parse_sps(next(n for n in nals if n.nal_unit_type == NAL_SPS).rbsp)
    pps0 = parse_pps(next(n for n in nals if n.nal_unit_type == NAL_PPS).rbsp,
                     {sps0.sps_id: sps0})
    sps_rbsp = write_sps(sps0, direct_8x8=direct_8x8)
    sps = parse_sps(sps_rbsp)
    changes = dict(pps_id=1, transform8=True, weighted_bipred_idc=idc,
                   entropy_coding_mode=True, num_ref_idx_l0_active=2,
                   num_ref_idx_l1_active=2)
    if scaling:
        changes.update(scaling_changes(seed))
    pps1_rbsp = _write_pps(pps0, **changes)
    out = [make_annexb_nal(3, NAL_SPS, sps_rbsp),
           make_annexb_nal(3, NAL_PPS, _write_pps(pps0)),
           make_annexb_nal(3, NAL_PPS, pps1_rbsp)]
    k = -1
    for nal, sh in zip(nals, hdrs):
        if sh is None:
            continue
        k += sh.first_mb_in_slice == 0
        out.append(with_poc_lsb(nal, sh, 8 * k))
    return (b"".join(out), sps, parse_pps(pps1_rbsp, {sps.sps_id: sps}),
            k + 1)


# the steered pictures after the prefix: (slice type, nal_ref_idc, POC
# step from the last reference's POC, direct_spatial_mv_pred)
STEERED = (("P", 2, 8, None), ("I", 2, 8, None), ("B", 0, -4, True),
           ("B", 0, -12, False))


def steered_cabac_stream(enc_bs, idc=2, scaling=False, seed=0,
                         rows_per_slice=None, pictures=STEERED,
                         direct_8x8=True, chooser=None):
    """A CABAC stream of B pictures and the 8x8 transform: cabac_prefix
    of the port encoder's stream `enc_bs`, then `pictures` under PPS 1,
    each of seeded random bins (steer_picture) in slices of
    `rows_per_slice` MB rows (one slice when None): a P and an I
    reference picture, and two non-reference B pictures between earlier
    references in output order, the first with spatial direct and an L1
    modification, the second with temporal direct. Each picture's bins
    are steered by the port's own parser; the tests hold the port's
    decode of the result against the JAX decoder's. direct_8x8: the
    SPS's direct_8x8_inference; chooser: a BinChooser subclass that
    steers every picture."""
    from openh264_tpu_torch.decoder import H264Decoder
    assert idc != 1, "the steered B slices carry no pred_weight_table"
    prefix, sps, pps1, n_pics = cabac_prefix(enc_bs, idc, scaling, seed,
                                             direct_8x8)
    dec = H264Decoder(device="cpu")
    dec.decode_annexb(prefix)
    n_mb = sps.mb_width * sps.mb_height
    rows = rows_per_slice or sps.mb_height
    out = [prefix]
    frame_num = n_pics
    last_ref_poc = 8 * (n_pics - 1)
    for i, (kind, ref_idc, dpoc, spatial) in enumerate(pictures):
        stype = {"P": 5, "I": 7, "B": 6}[kind]
        poc = last_ref_poc + dpoc
        headers = []
        for first in range(0, n_mb, rows * sps.mb_width):
            w = BitWriter()
            write_slice_header_b(
                w, sps, pps1, frame_num, poc, slice_type=stype,
                spatial=spatial, mod_l1=1 if spatial else None,
                weights=None, qp=28 + 2 * (i % 2), nal_ref_idc=ref_idc,
                first_mb=first)
            headers.append((ref_idc, NAL_SLICE, w,
                            min(first + rows * sps.mb_width, n_mb)))
        out += steer_picture(dec, headers, seed * 100 + i, chooser)
        if ref_idc:
            frame_num += 1
            last_ref_poc = poc
    return b"".join(out)


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
