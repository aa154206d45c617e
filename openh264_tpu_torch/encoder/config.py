"""Encoder configuration.

Copied from openh264_tpu/encoder/encoder.py (EncoderConfig), field for
field, so a config means the same thing to both packages.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EncoderConfig:
    width: int = 0
    height: int = 0
    qp: int = 26
    idr_interval: int = 0        # 0 = only first frame is IDR
    profile_idc: int = 66
    level_idc: int = 31
    log2_max_frame_num: int = 8
    num_ref_frames: int = 1
    entropy_cabac: bool = False
    pic_init_qp: int = 26
    chroma_qp_offset: int = 0
    search_range: int = 8
    enable_intra_in_p: bool = True
    # EUsageType: 0 camera, 1 screen content (codec_app_def.h:286).
    usage_type: int = 0
    # per-MB I16x16-vs-I4x4 mode decision on I frames (host path only)
    enable_i4x4: bool = False
    # write VUI parameters into the SPS (timing + bitstream
    # restriction; au_set.cpp:197 WelsWriteVUI)
    enable_vui: bool = False
    num_slices: int = 1  # SM_FIXEDSLCNUM analog: N slices/frame
    # SM_SIZELIMITED analog (codec_app_def.h:342), host path only
    slice_size_constraint: int = 0
    enable_adaptive_quant: bool = False   # VAA-driven per-MB delta QP
    enable_scene_change_detect: bool = False  # SCD -> IDR decision
    enable_gom_rc: bool = False           # per-MB-row (GOM) QP offsets
    use_jax: bool = True
    # rate control (codec_app_def.h RC_MODES; -1 = off / constant QP)
    rc_mode: int = -1
    target_bitrate: int = 5_000_000   # bits/s
    max_bitrate: int = 0              # iMaxBitrate 1s-window cap (0 = off)
    max_frame_rate: float = 30.0
    max_qp: int = 51
    min_qp: int = 0
    enable_frame_skip: bool = True
    # in-loop filter (0 on, 1 off, 2 on-except-slice-boundaries)
    deblock_idc: int = 0
    # dyadic temporal scalability (1..4 layers, param_svc.h:498)
    temporal_layers: int = 1
    # long-term reference (SLTRConfig, codec_app_def.h:556), host path only
    enable_ltr: bool = False
    ltr_ref_num: int = 1
    ltr_mark_period: int = 30
    # parameter-set ids (simulcast layers use distinct ids)
    sps_id: int = 0
    pps_id: int = 0
    # keep the user's cfg.qp as the RC starting point instead of the
    # bpp-derived RcInitialQp pick
    rc_honor_init_qp: bool = False

    @property
    def mb_width(self):
        return (self.width + 15) // 16

    @property
    def mb_height(self):
        return (self.height + 15) // 16
