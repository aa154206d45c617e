"""SPS / PPS parsing (H.264 §7.3.2.1 / §7.3.2.2).

Behavior parity: reference codec/decoder/core/src/au_parser.cpp:911
ParseSps, :1326 ParsePps, :1491 ParseVui, :1703 ParseScalingList.

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/decoder/params.py; only its imports changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bits import BitReader
from .tables_core import (DEFAULT_SCALING_4x4, DEFAULT_SCALING_8x8, ZIGZAG_4x4,
                      ZIGZAG_8x8)

PROFILE_HIGH_SET = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


@dataclass
class SPS:
    profile_idc: int = 66
    constraint_flags: int = 0
    level_idc: int = 30
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: bool = False
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass: bool = False
    seq_scaling_matrix_present: bool = False
    # scaling lists in raster order: [6][16] 4x4 and [2..6][64] 8x8
    scaling_lists_4x4: np.ndarray | None = None
    scaling_lists_8x8: np.ndarray | None = None
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 4
    delta_pic_order_always_zero: bool = False
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: tuple = ()
    max_num_ref_frames: int = 1
    gaps_in_frame_num_allowed: bool = False
    mb_width: int = 0   # pic_width_in_mbs
    mb_height: int = 0  # pic_height_in_map_units (frame MBs when frame_mbs_only)
    frame_mbs_only: bool = True
    mb_adaptive_frame_field: bool = False
    direct_8x8_inference: bool = True
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    vui: dict = field(default_factory=dict)
    is_subset_sps: bool = False

    @property
    def width(self) -> int:
        return self.mb_width * 16 - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        return self.mb_height * 16 - 2 * (self.crop_top + self.crop_bottom)


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    entropy_coding_mode: bool = False  # False=CAVLC, True=CABAC
    pic_order_present: bool = False
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    slice_group_map: dict = field(default_factory=dict)
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    weighted_pred: bool = False
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present: bool = False
    constrained_intra_pred: bool = False
    redundant_pic_cnt_present: bool = False
    transform_8x8_mode: bool = False
    pic_scaling_matrix_present: bool = False
    scaling_lists_4x4: np.ndarray | None = None
    scaling_lists_8x8: np.ndarray | None = None
    second_chroma_qp_index_offset: int = 0


def parse_scaling_list(br: BitReader, size: int, list_idx: int,
                       fallback: np.ndarray, default: np.ndarray):
    """§7.3.2.1.1: returns raster-order scaling list (int32[size]) or the
    fallback if not present. default is the spec default matrix for this
    list (used when delta yields useDefault)."""
    zz = ZIGZAG_4x4 if size == 16 else ZIGZAG_8x8
    present = br.flag()
    if not present:
        return fallback.copy(), False
    last_scale, next_scale = 8, 8
    out = np.zeros(size, dtype=np.int32)
    use_default = False
    for j in range(size):
        if next_scale != 0:
            delta = br.se()
            next_scale = (last_scale + delta + 256) % 256
            if j == 0 and next_scale == 0:
                use_default = True
        v = last_scale if next_scale == 0 else next_scale
        out[zz[j]] = v
        last_scale = v
    if use_default:
        return default.copy(), True
    return out, True


def _parse_all_scaling_lists(br: BitReader, sps: SPS | None, n8x8: int):
    """Shared by SPS (fall-back rule A) and PPS (rule B with SPS lists)."""
    l4 = np.zeros((6, 16), dtype=np.int32)
    l8 = np.zeros((max(2, n8x8), 64), dtype=np.int32)
    for i in range(6):
        if i == 0 or i == 3:
            fb = DEFAULT_SCALING_4x4[0 if i < 3 else 1]
        else:
            fb = l4[i - 1]
        default = DEFAULT_SCALING_4x4[0 if i < 3 else 1]
        l4[i], _ = parse_scaling_list(br, 16, i, fb, default)
    for i in range(n8x8):
        if i < 2:
            fb = DEFAULT_SCALING_8x8[i]
        else:
            fb = l8[i - 2]
        default = DEFAULT_SCALING_8x8[i % 2]
        l8[i], _ = parse_scaling_list(br, 64, 6 + i, fb, default)
    return l4, l8


def parse_sps(rbsp: bytes, is_subset: bool = False) -> SPS:
    br = BitReader(rbsp)
    sps = SPS()
    sps.raw = bytes(rbsp)  # for content-change detection (repeated SPS ≠ new sequence)
    sps.is_subset_sps = is_subset
    sps.profile_idc = br.u(8)
    sps.constraint_flags = br.u(8)
    sps.level_idc = br.u(8)
    sps.sps_id = br.ue()
    if sps.profile_idc in PROFILE_HIGH_SET:
        sps.chroma_format_idc = br.ue()
        if sps.chroma_format_idc == 3:
            sps.separate_colour_plane_flag = br.flag()
        sps.bit_depth_luma = 8 + br.ue()
        sps.bit_depth_chroma = 8 + br.ue()
        sps.qpprime_y_zero_transform_bypass = br.flag()
        sps.seq_scaling_matrix_present = br.flag()
        if sps.seq_scaling_matrix_present:
            n8 = 6 if sps.chroma_format_idc == 3 else 2
            sps.scaling_lists_4x4, sps.scaling_lists_8x8 = \
                _parse_all_scaling_lists(br, None, n8)
    sps.log2_max_frame_num = 4 + br.ue()
    sps.pic_order_cnt_type = br.ue()
    if sps.pic_order_cnt_type == 0:
        sps.log2_max_pic_order_cnt_lsb = 4 + br.ue()
    elif sps.pic_order_cnt_type == 1:
        sps.delta_pic_order_always_zero = br.flag()
        sps.offset_for_non_ref_pic = br.se()
        sps.offset_for_top_to_bottom_field = br.se()
        n = br.ue()
        sps.offset_for_ref_frame = tuple(br.se() for _ in range(n))
    sps.max_num_ref_frames = br.ue()
    sps.gaps_in_frame_num_allowed = br.flag()
    sps.mb_width = br.ue() + 1
    sps.mb_height = br.ue() + 1
    sps.frame_mbs_only = br.flag()
    if not sps.frame_mbs_only:
        sps.mb_adaptive_frame_field = br.flag()
    sps.direct_8x8_inference = br.flag()
    if br.flag():  # frame_cropping_flag
        sps.crop_left = br.ue()
        sps.crop_right = br.ue()
        sps.crop_top = br.ue()
        sps.crop_bottom = br.ue()
    if br.flag():  # vui_parameters_present_flag
        sps.vui = parse_vui(br)
    if is_subset and sps.profile_idc in (83, 86):
        # seq_parameter_set_svc_extension (§G.7.3.2.1.4; parity:
        # au_parser.cpp:722 DecodeSpsSvcExt)
        svc = {}
        svc["inter_layer_deblocking_ctrl"] = br.flag()
        svc["extended_spatial_scalability"] = br.u(2)
        svc["chroma_phase_x_plus1_flag"] = br.u(1)
        svc["chroma_phase_y_plus1"] = br.u(2)
        if svc["extended_spatial_scalability"] == 1:
            svc["seq_ref_layer_chroma_phase_x_plus1_flag"] = br.u(1)
            svc["seq_ref_layer_chroma_phase_y_plus1"] = br.u(2)
            svc["scaled_ref_layer_offsets"] = tuple(br.se() for _ in range(4))
        svc["seq_tcoeff_level_pred"] = br.flag()
        if svc["seq_tcoeff_level_pred"]:
            svc["adaptive_tcoeff_level_pred"] = br.flag()
        svc["slice_header_restriction"] = br.flag()
        sps.svc_ext = svc
    return sps


def parse_vui(br: BitReader) -> dict:
    vui: dict = {}
    if br.flag():  # aspect_ratio_info_present
        idc = br.u(8)
        vui["aspect_ratio_idc"] = idc
        if idc == 255:  # Extended_SAR
            vui["sar_width"] = br.u(16)
            vui["sar_height"] = br.u(16)
    if br.flag():  # overscan_info_present
        vui["overscan_appropriate"] = br.flag()
    if br.flag():  # video_signal_type_present
        vui["video_format"] = br.u(3)
        vui["video_full_range"] = br.flag()
        if br.flag():  # colour_description_present
            vui["colour_primaries"] = br.u(8)
            vui["transfer_characteristics"] = br.u(8)
            vui["matrix_coefficients"] = br.u(8)
    if br.flag():  # chroma_loc_info_present
        vui["chroma_sample_loc_type_top"] = br.ue()
        vui["chroma_sample_loc_type_bottom"] = br.ue()
    if br.flag():  # timing_info_present
        vui["num_units_in_tick"] = br.u(32)
        vui["time_scale"] = br.u(32)
        vui["fixed_frame_rate"] = br.flag()
    for key in ("nal_hrd", "vcl_hrd"):
        if br.flag():
            hrd = {}
            cnt = br.ue() + 1
            hrd["bit_rate_scale"] = br.u(4)
            hrd["cpb_size_scale"] = br.u(4)
            rates = []
            for _ in range(cnt):
                rates.append((br.ue(), br.ue(), br.flag()))
            hrd["cpb"] = rates
            hrd["initial_cpb_removal_delay_length"] = br.u(5) + 1
            hrd["cpb_removal_delay_length"] = br.u(5) + 1
            hrd["dpb_output_delay_length"] = br.u(5) + 1
            hrd["time_offset_length"] = br.u(5)
            vui[key] = hrd
    if "nal_hrd" in vui or "vcl_hrd" in vui:
        vui["low_delay_hrd"] = br.flag()
    vui["pic_struct_present"] = br.flag()
    if br.flag():  # bitstream_restriction
        vui["motion_vectors_over_pic_boundaries"] = br.flag()
        vui["max_bytes_per_pic_denom"] = br.ue()
        vui["max_bits_per_mb_denom"] = br.ue()
        vui["log2_max_mv_length_horizontal"] = br.ue()
        vui["log2_max_mv_length_vertical"] = br.ue()
        vui["max_num_reorder_frames"] = br.ue()
        vui["max_dec_frame_buffering"] = br.ue()
    return vui


def parse_pps(rbsp: bytes, sps_map: dict[int, SPS]) -> PPS:
    br = BitReader(rbsp)
    pps = PPS()
    pps.pps_id = br.ue()
    pps.sps_id = br.ue()
    pps.entropy_coding_mode = br.flag()
    pps.pic_order_present = br.flag()
    pps.num_slice_groups = br.ue() + 1
    if pps.num_slice_groups > 1:
        m = {}
        t = br.ue()
        pps.slice_group_map_type = t
        if t == 0:
            m["run_length"] = [br.ue() + 1 for _ in range(pps.num_slice_groups)]
        elif t == 2:
            tl, brc = [], []
            for _ in range(pps.num_slice_groups - 1):
                tl.append(br.ue())
                brc.append(br.ue())
            m["top_left"], m["bottom_right"] = tl, brc
        elif t in (3, 4, 5):
            m["change_direction"] = br.flag()
            m["change_rate"] = br.ue() + 1
        elif t == 6:
            n = br.ue() + 1
            bits = max(1, (pps.num_slice_groups - 1).bit_length())
            m["explicit"] = [br.u(bits) for _ in range(n)]
        pps.slice_group_map = m
    pps.num_ref_idx_l0_active = br.ue() + 1
    pps.num_ref_idx_l1_active = br.ue() + 1
    pps.weighted_pred = br.flag()
    pps.weighted_bipred_idc = br.u(2)
    pps.pic_init_qp = 26 + br.se()
    pps.pic_init_qs = 26 + br.se()
    pps.chroma_qp_index_offset = br.se()
    pps.deblocking_filter_control_present = br.flag()
    pps.constrained_intra_pred = br.flag()
    pps.redundant_pic_cnt_present = br.flag()
    if br.more_rbsp_data():
        pps.transform_8x8_mode = br.flag()
        pps.pic_scaling_matrix_present = br.flag()
        if pps.pic_scaling_matrix_present:
            sps = sps_map.get(pps.sps_id)
            chroma3 = sps is not None and sps.chroma_format_idc == 3
            n8 = (6 if chroma3 else 2) if pps.transform_8x8_mode else 0
            # PPS fallback rule B: when SPS provided lists, list 0/3 fall
            # back to the SPS lists instead of defaults.
            l4 = np.zeros((6, 16), dtype=np.int32)
            l8 = np.zeros((max(2, n8), 64), dtype=np.int32)
            sps_l4 = sps.scaling_lists_4x4 if (sps and sps.seq_scaling_matrix_present) else None
            sps_l8 = sps.scaling_lists_8x8 if (sps and sps.seq_scaling_matrix_present) else None
            for i in range(6):
                if i == 0 or i == 3:
                    fb = (sps_l4[i] if sps_l4 is not None
                          else DEFAULT_SCALING_4x4[0 if i < 3 else 1])
                else:
                    fb = l4[i - 1]
                default = DEFAULT_SCALING_4x4[0 if i < 3 else 1]
                l4[i], _ = parse_scaling_list(br, 16, i, fb, default)
            for i in range(n8):
                if i < 2:
                    fb = sps_l8[i] if sps_l8 is not None else DEFAULT_SCALING_8x8[i]
                else:
                    fb = l8[i - 2]
                default = DEFAULT_SCALING_8x8[i % 2]
                l8[i], _ = parse_scaling_list(br, 64, 6 + i, fb, default)
            pps.scaling_lists_4x4, pps.scaling_lists_8x8 = l4, l8
        pps.second_chroma_qp_index_offset = br.se()
    else:
        pps.second_chroma_qp_index_offset = pps.chroma_qp_index_offset
    return pps
