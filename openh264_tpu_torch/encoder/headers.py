"""Parameter-set and slice-header bitstream writers (H.264 §7.3).

Copied from openh264_tpu/encoder/headers.py.

Parity anchors: encoder au_set.cpp WelsWriteSpsSyntax:264 /
WelsWritePpsSyntax:406; slice headers svc_encode_slice.cpp
WelsSliceHeaderWrite.
"""

from __future__ import annotations

from ..bitstream import BitWriter, make_annexb_nal, NAL_SPS, NAL_PPS


def write_sps(cfg) -> bytes:
    """Constrained Baseline SPS for the current config. Returns RBSP."""
    w = BitWriter()
    w.u(8, cfg.profile_idc)          # 66 baseline
    w.flag(cfg.profile_idc == 66)    # constraint_set0 (baseline conform)
    w.flag(True)                     # constraint_set1 (main-compatible CAVLC)
    w.flag(False)                    # constraint_set2
    w.flag(False)                    # constraint_set3
    w.u(4, 0)                        # reserved_zero_4bits + ...
    w.u(8, cfg.level_idc)
    w.ue(getattr(cfg, 'sps_id', 0))  # sps_id
    w.ue(cfg.log2_max_frame_num - 4)
    w.ue(2)                          # pic_order_cnt_type = 2 (IPPP, no B yet)
    w.ue(cfg.num_ref_frames)
    w.flag(False)                    # gaps_in_frame_num_value_allowed
    w.ue(cfg.mb_width - 1)
    w.ue(cfg.mb_height - 1)
    w.flag(True)                     # frame_mbs_only
    w.flag(True)                     # direct_8x8_inference
    crop_r = cfg.mb_width * 16 - cfg.width
    crop_b = cfg.mb_height * 16 - cfg.height
    if crop_r or crop_b:
        w.flag(True)
        w.ue(0)
        w.ue(crop_r // 2)
        w.ue(0)
        w.ue(crop_b // 2)
    else:
        w.flag(False)
    if getattr(cfg, 'enable_vui', False):
        w.flag(True)                 # vui_parameters_present
        _write_vui(w, cfg)
    else:
        w.flag(False)                # vui_parameters_present
    w.rbsp_trailing_bits()
    return w.get_bytes()


def _write_vui(w: BitWriter, cfg) -> None:
    """VUI parameters (spec E.1.1; parity: au_set.cpp:197
    WelsWriteVUI): timing info from the configured frame rate plus the
    bitstream-restriction block the reference emits."""
    w.flag(False)                    # aspect_ratio_info_present
    w.flag(False)                    # overscan_info_present
    w.flag(False)                    # video_signal_type_present
    w.flag(False)                    # chroma_loc_info_present
    w.flag(True)                     # timing_info_present
    w.u(32, 1)                       # num_units_in_tick
    w.u(32, max(2, int(round(2 * cfg.max_frame_rate))))  # time_scale
    w.flag(False)                    # fixed_frame_rate_flag
    w.flag(False)                    # nal_hrd_parameters_present
    w.flag(False)                    # vcl_hrd_parameters_present
    w.flag(False)                    # pic_struct_present
    w.flag(True)                     # bitstream_restriction
    w.flag(True)                     # motion_vectors_over_pic_boundaries
    w.ue(0)                          # max_bytes_per_pic_denom
    w.ue(0)                          # max_bits_per_mb_denom
    w.ue(16)                         # log2_max_mv_length_horizontal
    w.ue(16)                         # log2_max_mv_length_vertical
    w.ue(0)                          # max_num_reorder_frames (IPPP)
    w.ue(cfg.num_ref_frames)         # max_dec_frame_buffering


def write_pps(cfg) -> bytes:
    w = BitWriter()
    w.ue(getattr(cfg, 'pps_id', 0))  # pps_id
    w.ue(getattr(cfg, 'sps_id', 0))  # sps_id
    w.flag(cfg.entropy_cabac)        # entropy_coding_mode
    w.flag(False)                    # pic_order_present
    w.ue(0)                          # num_slice_groups - 1
    w.ue(0)                          # num_ref_idx_l0_active - 1
    w.ue(0)                          # num_ref_idx_l1_active - 1
    w.flag(False)                    # weighted_pred
    w.u(2, 0)                        # weighted_bipred_idc
    w.se(cfg.pic_init_qp - 26)
    w.se(0)                          # pic_init_qs
    w.se(cfg.chroma_qp_offset)
    w.flag(True)                     # deblocking_filter_control_present
    w.flag(False)                    # constrained_intra_pred
    w.flag(False)                    # redundant_pic_cnt_present
    w.rbsp_trailing_bits()
    return w.get_bytes()


def write_slice_header(w: BitWriter, cfg, slice_type: int, frame_num: int,
                       first_mb: int, qp: int, idr: bool, idr_pic_id: int,
                       disable_deblock: int, is_ref: bool = True,
                       reorder_abs_diff: int | None = None,
                       reorder_long_term: int | None = None,
                       long_term_ref_flag: bool = False,
                       mmco_ops=None) -> None:
    """slice_type: 2=I, 0=P (all-slices-same convention uses +5).

    reorder_abs_diff: when set, emits a single short-term
    ref_pic_list_modification (idc 0, abs_diff_pic_num_minus1 = value)
    so the slice references a specific DPB picture — used by temporal
    layers to pin each layer to its dyadic reference (the reference
    builds the same effect via its ref-list strategy,
    ref_list_mgr_svc.cpp WelsBuildRefList).
    reorder_long_term: idc-2 modification pinning the LTR with this
    long_term_pic_num first in L0 (LTR recovery,
    ref_list_mgr_svc.cpp WelsBuildRefListLosslessScreenRefSelection).
    long_term_ref_flag: IDR long_term_reference_flag (marks the IDR as
    LTR index 0).
    mmco_ops: list of (op, arg) memory_management_control_operations
    for adaptive marking (§7.3.3.3; op 0 terminator appended here).
    """
    w.ue(first_mb)
    w.ue(slice_type + 5)             # e.g. 7 = I (all slices), 5 = P
    w.ue(getattr(cfg, 'pps_id', 0))  # pps_id
    w.u(cfg.log2_max_frame_num, frame_num)
    if idr:
        w.ue(idr_pic_id)
    # poc type 2: nothing
    if slice_type == 0:              # P
        w.flag(False)                # num_ref_idx_active_override
        if reorder_abs_diff is None and reorder_long_term is None:
            w.flag(False)            # ref_pic_list_modification_flag_l0
        else:
            w.flag(True)
            if reorder_long_term is not None:
                w.ue(2)              # modification_of_pic_nums_idc = 2
                w.ue(reorder_long_term)  # long_term_pic_num
            else:
                w.ue(0)              # modification_of_pic_nums_idc = 0
                w.ue(reorder_abs_diff)   # abs_diff_pic_num_minus1
            w.ue(3)                  # end of modification loop
    # dec_ref_pic_marking (only present on reference pictures)
    if idr:
        w.flag(False)                # no_output_of_prior_pics
        w.flag(long_term_ref_flag)   # long_term_reference_flag
    elif is_ref:
        if mmco_ops:
            w.flag(True)             # adaptive_ref_pic_marking_mode
            for op, arg in mmco_ops:
                w.ue(op)
                if op in (1, 2, 3, 4, 6):
                    w.ue(arg)
                if op == 3:          # op 3 carries two arguments
                    raise NotImplementedError("MMCO 3 needs 2 args")
            w.ue(0)                  # end of MMCO loop
        else:
            w.flag(False)            # adaptive_ref_pic_marking_mode
    if cfg.entropy_cabac and slice_type != 2:
        w.ue(0)                      # cabac_init_idc
    w.se(qp - cfg.pic_init_qp)       # slice_qp_delta
    # deblocking control (pps.deblocking_filter_control_present = 1)
    w.ue(disable_deblock)
    if disable_deblock != 1:
        w.se(0)                      # alpha offset / 2
        w.se(0)                      # beta offset / 2
