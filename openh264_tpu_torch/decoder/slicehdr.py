"""Slice header parsing (H.264 §7.3.3).

Behavior parity: reference codec/decoder/core/src/decoder_core.cpp:874
ParseSliceHeaderSyntaxs (incl. ref-list-modification and MMCO syntax).

Copied from openh264_tpu/decoder/slicehdr.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream import BitReader, NalUnit
from .params import PPS, SPS

# slice types (slice_type % 5)
P_SLICE, B_SLICE, I_SLICE, SP_SLICE, SI_SLICE = 0, 1, 2, 3, 4


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = I_SLICE  # already mod 5
    all_slices_same_type: bool = False  # slice_type was in 5..9
    pps_id: int = 0
    colour_plane_id: int = 0
    frame_num: int = 0
    field_pic_flag: bool = False
    bottom_field_flag: bool = False
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: tuple = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred: bool = False
    num_ref_idx_active_override: bool = False
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    ref_pic_list_modification: tuple = ((), ())  # per list: ((op, val), ...)
    # pred weight table
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    weights: dict = field(default_factory=dict)  # (list, refidx) -> dict
    # dec_ref_pic_marking
    no_output_of_prior_pics: bool = False
    long_term_reference_flag: bool = False
    adaptive_ref_pic_marking: bool = False
    mmco_ops: tuple = ()  # ((op, a, b), ...)
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset: int = 0
    slice_beta_offset: int = 0
    slice_group_change_cycle: int = 0
    # context attached during parse
    sps: SPS = None
    pps: PPS = None
    nal: NalUnit = None
    header_bits: int = 0  # bit position after header (for slice data start)

    @property
    def is_idr(self) -> bool:
        if self.nal is None:
            return False
        if self.nal.nal_unit_type == 5:
            return True
        # NAL 20 (SVC slice ext) carries idr_flag in the 3-byte ext header
        return self.nal.nal_unit_type == 20 and self.nal.svc_ext is not None \
            and bool(self.nal.svc_ext["idr_flag"])

    @property
    def qp(self) -> int:
        return self.pps.pic_init_qp + self.slice_qp_delta


def parse_slice_header(br: BitReader, nal: NalUnit,
                       sps_map: dict[int, SPS], pps_map: dict[int, PPS],
                       subset_sps_map: dict[int, SPS] | None = None) -> SliceHeader:
    sh = SliceHeader()
    sh.nal = nal
    ext = nal.nal_unit_type == 20 and nal.svc_ext is not None
    idr = nal.nal_unit_type == 5 or (ext and bool(nal.svc_ext["idr_flag"]))
    sh.first_mb_in_slice = br.ue()
    st = br.ue()
    if st > 9:
        raise ValueError(f"invalid slice_type {st}")
    sh.all_slices_same_type = st >= 5
    sh.slice_type = st % 5
    sh.pps_id = br.ue()
    if sh.pps_id not in pps_map:
        raise KeyError(f"pps {sh.pps_id} not received")
    sh.pps = pps_map[sh.pps_id]
    use_subset = nal.nal_unit_type == 20 and subset_sps_map
    smap = subset_sps_map if use_subset else sps_map
    if sh.pps.sps_id not in smap:
        # SVC slices may still refer to the base SPS map
        smap = sps_map
    sh.sps = smap[sh.pps.sps_id]
    sps, pps = sh.sps, sh.pps
    if sps.separate_colour_plane_flag:
        sh.colour_plane_id = br.u(2)
    sh.frame_num = br.u(sps.log2_max_frame_num)
    if not sps.frame_mbs_only:
        sh.field_pic_flag = br.flag()
        if sh.field_pic_flag:
            sh.bottom_field_flag = br.flag()
    if idr:
        sh.idr_pic_id = br.ue()
    if sps.pic_order_cnt_type == 0:
        sh.pic_order_cnt_lsb = br.u(sps.log2_max_pic_order_cnt_lsb)
        if pps.pic_order_present and not sh.field_pic_flag:
            sh.delta_pic_order_cnt_bottom = br.se()
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero:
        d0 = br.se()
        d1 = br.se() if (pps.pic_order_present and not sh.field_pic_flag) else 0
        sh.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present:
        sh.redundant_pic_cnt = br.ue()
    if sh.slice_type == B_SLICE:
        sh.direct_spatial_mv_pred = br.flag()
    sh.num_ref_idx_l0_active = pps.num_ref_idx_l0_active
    sh.num_ref_idx_l1_active = pps.num_ref_idx_l1_active
    if sh.slice_type in (P_SLICE, SP_SLICE, B_SLICE):
        sh.num_ref_idx_active_override = br.flag()
        if sh.num_ref_idx_active_override:
            sh.num_ref_idx_l0_active = br.ue() + 1
            if sh.slice_type == B_SLICE:
                sh.num_ref_idx_l1_active = br.ue() + 1
    # ref_pic_list_modification (§7.3.3.1)
    mods = [[], []]
    nlists = 0
    if sh.slice_type not in (I_SLICE, SI_SLICE):
        nlists = 2 if sh.slice_type == B_SLICE else 1
    for lx in range(nlists):
        if br.flag():  # ref_pic_list_modification_flag_lX
            while True:
                op = br.ue()
                if op == 3:
                    break
                val = br.ue()
                mods[lx].append((op, val))
                if len(mods[lx]) > 32:
                    raise ValueError("runaway ref list modification")
    sh.ref_pic_list_modification = (tuple(mods[0]), tuple(mods[1]))
    # pred_weight_table (§7.3.3.2)
    if (pps.weighted_pred and sh.slice_type in (P_SLICE, SP_SLICE)) or \
       (pps.weighted_bipred_idc == 1 and sh.slice_type == B_SLICE):
        sh.luma_log2_weight_denom = br.ue()
        sh.chroma_log2_weight_denom = br.ue()
        for lx in range(2 if sh.slice_type == B_SLICE else 1):
            n = sh.num_ref_idx_l0_active if lx == 0 else sh.num_ref_idx_l1_active
            for ri in range(n):
                w = {"luma_weight": 1 << sh.luma_log2_weight_denom,
                     "luma_offset": 0,
                     "chroma_weight": [1 << sh.chroma_log2_weight_denom] * 2,
                     "chroma_offset": [0, 0]}
                if br.flag():  # luma_weight_lX_flag
                    w["luma_weight"] = br.se()
                    w["luma_offset"] = br.se()
                if br.flag():  # chroma_weight_lX_flag
                    cw, co = [0, 0], [0, 0]
                    for j in range(2):
                        cw[j] = br.se()
                        co[j] = br.se()
                    w["chroma_weight"], w["chroma_offset"] = cw, co
                sh.weights[(lx, ri)] = w
    # dec_ref_pic_marking (§7.3.3.3)
    if nal.nal_ref_idc != 0:
        if idr:
            sh.no_output_of_prior_pics = br.flag()
            sh.long_term_reference_flag = br.flag()
        else:
            sh.adaptive_ref_pic_marking = br.flag()
            if sh.adaptive_ref_pic_marking:
                ops = []
                while True:
                    op = br.ue()
                    if op == 0:
                        break
                    a = b = 0
                    if op in (1, 3):
                        a = br.ue()  # difference_of_pic_nums_minus1
                    if op == 2:
                        a = br.ue()  # long_term_pic_num
                    if op in (3, 6):
                        b = br.ue()  # long_term_frame_idx
                    if op == 4:
                        a = br.ue()  # max_long_term_frame_idx_plus1
                    ops.append((op, a, b))
                    if len(ops) > 64:
                        raise ValueError("runaway MMCO")
                sh.mmco_ops = tuple(ops)
        if ext and not _svc_ext_field(sh.sps, "slice_header_restriction", False):
            store_flag = br.flag()  # store_ref_base_pic_flag
            # G.7.3.3.4: dec_ref_base_pic_marking() follows when
            # (use_ref_base_pic_flag || store_ref_base_pic_flag) && !idr
            # (parity: decoder_core.cpp:1188-1192). We support neither.
            if (store_flag or nal.svc_ext["use_ref_base_pic_flag"]) and not idr:
                raise ValueError("ref_base_pic marking unsupported")
    if pps.entropy_coding_mode and sh.slice_type not in (I_SLICE, SI_SLICE):
        sh.cabac_init_idc = br.ue()
    sh.slice_qp_delta = br.se()
    if pps.deblocking_filter_control_present:
        sh.disable_deblocking_filter_idc = br.ue()
        if sh.disable_deblocking_filter_idc != 1:
            sh.slice_alpha_c0_offset = br.se() * 2
            sh.slice_beta_offset = br.se() * 2
    if pps.num_slice_groups > 1 and pps.slice_group_map_type in (3, 4, 5):
        pic_size_map_units = sps.mb_width * sps.mb_height
        rate = pps.slice_group_map["change_rate"]
        import math
        bits = max(1, math.ceil(math.log2(pic_size_map_units / rate + 1)))
        sh.slice_group_change_cycle = br.u(bits)
    if ext:
        # slice_header_in_scalable_extension tail (H.264 §G.7.3.3.4;
        # parity: decoder_core.cpp:1264-1380). Single-layer decode only
        # supports no_inter_layer_pred base-quality slices.
        if not nal.svc_ext["no_inter_layer_pred_flag"]:
            if nal.svc_ext["quality_id"] == 0:
                raise ValueError("inter-layer prediction unsupported")
            raise ValueError("MGS (quality_id>0) unsupported")
        if not _svc_ext_field(sh.sps, "slice_header_restriction", False):
            scan_start, scan_end = br.u(4), br.u(4)
            if scan_start != 0 or scan_end != 15:
                raise ValueError("partial scan_idx range unsupported")
    sh.header_bits = br.pos
    return sh


def _svc_ext_field(sps, name: str, default):
    svc = getattr(sps, "svc_ext", None)
    return svc.get(name, default) if svc else default
