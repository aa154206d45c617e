"""ISVCEncoder-equivalent session object.

Port of openh264_tpu/api/encoder_api.py (CWelsH264SVCEncoder,
WelsCreateSVCEncoder), byte-identical with it. Mirrors
CWelsH264SVCEncoder (codec/encoder/plus/src/welsEncoderExt.cpp):
InitializeExt :210, EncodeFrame :375, EncodeParameterSets (codec_api.h
:316), ForceIntraFrame (codec_api.h:323), SetOption/GetOption :688 and
the statistics upkeep (UpdateStatistics :581). The engine is the port's
encoder.H264Encoder on `device` (default "cuda"; without a GPU the
default raises when the encoder is initialised). This layer translates
parameters, re-configures, and keeps the statistics.
"""

from __future__ import annotations

import time

from .options import ENCODER_OPTION
from .params import SEncParamBase, SEncParamExt, SEncoderStatistics
from ..device import resolve_device
from ..encoder.encoder import EncoderConfig, H264Encoder
from ..utils import trace
from ..utils.psnr import calc_psnr

cmResultSuccess = 0
cmInitParaError = 2


class CWelsH264SVCEncoder:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.param: SEncParamExt | None = None
        self._enc: H264Encoder | None = None
        self._stats = SEncoderStatistics()
        self._force_idr = False
        self._t_total = 0.0
        self._qp_sum = 0
        self._psnr_sum = [0.0, 0.0, 0.0]
        self._psnr_n = 0
        self._stats_log_interval = 0.0
        self._last_stats_log = 0.0

    # ------------------------------------------------------------------
    def Initialize(self, p: SEncParamBase) -> int:
        ext = SEncParamExt(**{k: getattr(p, k) for k in
                              ("iUsageType", "iPicWidth", "iPicHeight",
                               "iTargetBitrate", "iRCMode", "fMaxFrameRate")})
        return self.InitializeExt(ext)

    def InitializeExt(self, p: SEncParamExt) -> int:
        if p.iPicWidth <= 0 or p.iPicHeight <= 0:
            return cmInitParaError
        if not (0 <= p.iInitialQp <= 51):
            return cmInitParaError
        self.param = p
        qp = p.sSpatialLayers[0].iDLayerQp if p.sSpatialLayers \
            else p.iInitialQp
        cfg = EncoderConfig(
            width=p.iPicWidth, height=p.iPicHeight, qp=qp,
            idr_interval=p.uiIntraPeriod,
            entropy_cabac=bool(p.iEntropyCodingModeFlag),
            num_ref_frames=max(1, p.iNumRefFrame),
            usage_type=1 if int(getattr(p, "iUsageType", 0)) == 1 else 0,
            rc_mode=p.iRCMode,
            target_bitrate=p.iTargetBitrate,
            max_bitrate=max(0, int(getattr(p, "iMaxBitrate", 0) or 0)),
            max_frame_rate=p.fMaxFrameRate,
            max_qp=p.iMaxQp, min_qp=p.iMinQp,
            enable_frame_skip=p.bEnableFrameSkip,
            deblock_idc=p.iLoopFilterDisableIdc,
            temporal_layers=max(1, p.iTemporalLayerNum),
            num_slices=self._slice_count(p),
            enable_ltr=bool(getattr(p, "bEnableLongTermReference", False)),
            ltr_ref_num=max(1, int(getattr(p, "iLTRRefNum", 1) or 1)),
            # I4x4 is always in the intra MD toolbox (CAVLC single-slice
            # host path) and the SPS carries VUI
            enable_i4x4=(not p.iEntropyCodingModeFlag
                         and self._slice_count(p) == 1),
            enable_vui=True,
            slice_size_constraint=self._slice_size_constraint(p),
        )
        try:
            self._enc = H264Encoder(cfg, device=self.device)
        except ValueError:
            return cmInitParaError
        self._stats = SEncoderStatistics(uiWidth=p.iPicWidth,
                                         uiHeight=p.iPicHeight)
        return cmResultSuccess

    @staticmethod
    def _slice_size_constraint(p) -> int:
        """Bytes per slice when uiSliceMode is 4, which the reference
        API takes for SM_SIZELIMITED_SLICE (ROADMAP.md, queue C)."""
        if not p.sSpatialLayers:
            return 0
        sl = getattr(p.sSpatialLayers[0], "sSliceArgument", None)
        if sl is None or sl.uiSliceMode != 4:
            return 0
        return max(0, int(getattr(sl, "uiSliceSizeConstraint", 0)))

    @staticmethod
    def _slice_count(p) -> int:
        """SliceModeEnum -> slices per frame: modes 0 and 4 give one
        slice, any other mode uiSliceNum."""
        if not p.sSpatialLayers:
            return 1
        sl = p.sSpatialLayers[0]
        mode = getattr(sl, "sSliceArgument", None)
        if mode is None:
            return 1
        if mode.uiSliceMode in (0, 4):
            return 1
        return max(1, int(mode.uiSliceNum))

    def Uninitialize(self) -> int:
        self._enc = None
        return cmResultSuccess

    # ------------------------------------------------------------------
    def EncodeFrame(self, y, u, v) -> bytes:
        """Encode one YUV420 frame (host uint8 planes); returns Annex-B
        bytes (empty when rate control skips the frame, mirroring
        videoFrameTypeSkip). Its span, api.encode_frame (utils/trace.py),
        carries the encoder's input index as its frame id and the attrs
        idr and skipped."""
        if self._enc is None:
            raise RuntimeError("EncodeFrame before InitializeExt")
        with trace.span("api.encode_frame",
                        frame=self._enc.frame_count) as sp:
            bs = self._encode_frame(y, u, v)
            # an IDR restarts the coding index
            sp.set(idr=bool(bs) and self._enc.coding_idx == 1,
                   skipped=not bs)
        return bs

    def _encode_frame(self, y, u, v) -> bytes:
        t0 = time.perf_counter()
        if self._force_idr:
            self._enc.force_idr()
            self._force_idr = False
        bs = self._enc.encode_frame(y, u, v)
        dt = time.perf_counter() - t0
        st = self._stats
        st.uiInputFrameCount += 1
        if not bs:
            st.uiSkippedFrameCount += 1
        self._t_total += dt
        st.fAverageFrameSpeedInMs = 1000.0 * self._t_total / \
            st.uiInputFrameCount
        st.fAverageFrameRate = st.uiInputFrameCount / self._t_total
        st.fLatestFrameRate = 1.0 / dt if dt > 0 else 0.0
        st.iTotalEncodedBytes += len(bs)
        self._qp_sum += self._enc.qp
        st.uiAverageFrameQP = self._qp_sum / st.uiInputFrameCount
        if bs and self._enc.dpb and \
                self._enc.dpb[-1].coding_idx == self._enc.coding_idx - 1:
            # per-frame PSNR of the encoder's reconstruction against the
            # input (encoder_ext.cpp:3918-3940; WelsCalcPsnr, utils.cpp:43)
            for i, (src, rec) in enumerate(zip((y, u, v),
                                               self._enc.dpb[-1].planes)):
                with trace.span("api.psnr_fetch"):
                    rec = rec[:src.shape[0], :src.shape[1]].cpu().numpy()
                self._psnr_sum[i] += calc_psnr(src, rec)
            self._psnr_n += 1
            st.fAveragePsnrY = self._psnr_sum[0] / self._psnr_n
            st.fAveragePsnrU = self._psnr_sum[1] / self._psnr_n
            st.fAveragePsnrV = self._psnr_sum[2] / self._psnr_n
        # periodic statistics trace (STATISTICS_LOG_INTERVAL)
        iv = self._stats_log_interval
        if iv > 0 and (time.monotonic() - self._last_stats_log) >= iv:
            self._last_stats_log = time.monotonic()
            from ..utils import wels_log, WELS_LOG_INFO
            wels_log(WELS_LOG_INFO,
                     f"EncoderStatistics: frames={st.uiInputFrameCount} "
                     f"skipped={st.uiSkippedFrameCount} "
                     f"avgQP={st.uiAverageFrameQP:.1f} "
                     f"fps={st.fAverageFrameRate:.2f} "
                     f"psnrY={st.fAveragePsnrY:.2f}")
        return bs

    def EncodeParameterSets(self) -> bytes:
        """codec_api.h:316: SPS+PPS Annex-B bytes."""
        if self._enc is None:
            raise RuntimeError("EncodeParameterSets before InitializeExt")
        return self._enc.headers_annexb()

    def ForceIntraFrame(self, bIDR: bool = True) -> int:
        if bIDR:
            self._force_idr = True
            self._stats.uiIDRReqNum += 1
        return cmResultSuccess

    # ------------------------------------------------------------------
    def SetOption(self, eOptionId: int, value) -> int:
        """Implemented options take effect at once; unsupported ids
        return cmInitParaError."""
        e = self._enc
        if eOptionId == ENCODER_OPTION.SVC_ENCODE_PARAM_EXT:
            return self.InitializeExt(value)
        if eOptionId == ENCODER_OPTION.SVC_ENCODE_PARAM_BASE:
            return self.Initialize(value)
        if e is None:
            return cmInitParaError
        if eOptionId == ENCODER_OPTION.IDR_INTERVAL:
            e.cfg.idr_interval = int(value)
        elif eOptionId == ENCODER_OPTION.FRAME_RATE:
            e.cfg.max_frame_rate = float(value)
            self.param.fMaxFrameRate = float(value)
            e.reconfigure_rc()
        elif eOptionId == ENCODER_OPTION.BITRATE:
            e.cfg.target_bitrate = int(value)
            self.param.iTargetBitrate = int(value)
            e.reconfigure_rc()
        elif eOptionId == ENCODER_OPTION.RC_MODE:
            e.cfg.rc_mode = int(value)
            e.reconfigure_rc()
        elif eOptionId == ENCODER_OPTION.MAX_BITRATE:
            e.cfg.max_bitrate = int(value)
            e.reconfigure_rc()
        elif eOptionId == ENCODER_OPTION.RC_FRAME_SKIP:
            e.cfg.enable_frame_skip = bool(value)
        elif eOptionId == ENCODER_OPTION.NUMBER_REF:
            # takes effect on the sliding window from the next frame on
            e.cfg.num_ref_frames = max(1, min(16, int(value)))
        elif eOptionId == ENCODER_OPTION.LTR:
            # SLTRConfig{bEnableLongTermReference, iLTRRefNum}
            # (codec_app_def.h:556); plain ints enable with 1 LTR slot
            if hasattr(value, "bEnableLongTermReference"):
                e.cfg.enable_ltr = bool(value.bEnableLongTermReference)
                e.cfg.ltr_ref_num = max(1, int(value.iLTRRefNum))
            else:
                e.cfg.enable_ltr = bool(value)
            e.setup_ltr()
        elif eOptionId == ENCODER_OPTION.LTR_MARKING_PERIOD:
            e.cfg.ltr_mark_period = int(value)
        elif eOptionId == ENCODER_OPTION.LTR_RECOVERY_REQUEST:
            # SLTRRecoverRequest (codec_app_def.h:239)
            e.ltr_recovery_request(value)
        elif eOptionId == ENCODER_OPTION.LTR_MARKING_FEEDBACK:
            # SLTRMarkingFeedback (codec_app_def.h:250)
            e.ltr_marking_feedback(value)
        elif eOptionId == ENCODER_OPTION.TRACE_LEVEL:
            from ..utils.trace import set_trace_level
            set_trace_level(int(value))
        elif eOptionId == ENCODER_OPTION.TRACE_CALLBACK:
            from ..utils.trace import set_trace_callback
            set_trace_callback(value)
        elif eOptionId == ENCODER_OPTION.DATAFORMAT:
            if int(value) != 23:      # videoFormatI420
                return cmInitParaError
        elif eOptionId == ENCODER_OPTION.STATISTICS_LOG_INTERVAL:
            self._stats_log_interval = max(0, int(value)) / 1000.0
        elif eOptionId == ENCODER_OPTION.COMPLEXITY:
            # LOW/MEDIUM/HIGH -> ME search range ladder
            e.cfg.search_range = {0: 4, 1: 8, 2: 16}.get(int(value), 8)
        else:
            # padding, SSEI, prefix NAL, parameter-set strategies, dump
            # files, lossless link...: not implemented
            return cmInitParaError
        return cmResultSuccess

    def GetOption(self, eOptionId: int):
        e = self._enc
        if eOptionId == ENCODER_OPTION.GET_STATISTICS:
            return self._stats
        if eOptionId == ENCODER_OPTION.SVC_ENCODE_PARAM_EXT:
            return self.param
        if eOptionId == ENCODER_OPTION.IDR_INTERVAL:
            return e.cfg.idr_interval if e else 0
        if eOptionId == ENCODER_OPTION.NUMBER_REF:
            return e.cfg.num_ref_frames if e else 0
        if eOptionId == ENCODER_OPTION.COMPLEXITY and e:
            return {4: 0, 8: 1, 16: 2}.get(e.cfg.search_range, 1)
        return None


def WelsCreateSVCEncoder(device="cuda") -> CWelsH264SVCEncoder:
    """Factory (codec_api.h:508 WelsCreateSVCEncoder)."""
    return CWelsH264SVCEncoder(device=device)
