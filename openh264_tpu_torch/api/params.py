"""Parameter & statistics structs of the public API.

Dataclass mirrors of the reference's codec_app_def.h structures, keeping
the original field names so code written against the reference SDK maps
1:1 (SEncParamBase :525-535, SEncParamExt :540-598, SSpatialLayerConfig
:455-488, SSliceArgument :337-358, SDecodingParam :611-621,
SEncoderStatistics :745-770, SDecoderStatistics :775-809).

Copied from openh264_tpu/api/params.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# EUsageType (codec_app_def.h:297-303)
CAMERA_VIDEO_REAL_TIME = 0
SCREEN_CONTENT_REAL_TIME = 1

# RC_MODES (codec_app_def.h:268-275)
RC_QUALITY_MODE = 0
RC_BITRATE_MODE = 1
RC_BUFFERBASED_MODE = 2
RC_TIMESTAMP_MODE = 3
RC_OFF_MODE = -1
RC_MODES = (RC_OFF_MODE, RC_QUALITY_MODE, RC_BITRATE_MODE,
            RC_BUFFERBASED_MODE, RC_TIMESTAMP_MODE)

# SliceModeEnum (codec_app_def.h:337-343)
SM_SINGLE_SLICE = 0
SM_FIXEDSLCNUM_SLICE = 1
SM_RASTER_SLICE = 2
SM_SIZELIMITED_SLICE = 3

# VIDEO_BITSTREAM_TYPE (codec_app_def.h:443-447)
VIDEO_BITSTREAM_AVC = 0
VIDEO_BITSTREAM_SVC = 1

# EProfileIdc / ELevelIdc subset
PRO_BASELINE = 66
PRO_MAIN = 77
PRO_HIGH = 100


@dataclass
class SSliceArgument:
    """codec_app_def.h:345-358."""
    uiSliceMode: int = SM_SINGLE_SLICE
    uiSliceNum: int = 1
    uiSliceMbNum: list[int] = field(default_factory=list)
    uiSliceSizeConstraint: int = 1500


@dataclass
class SSpatialLayerConfig:
    """codec_app_def.h:455-488 (VUI color description omitted for now)."""
    iVideoWidth: int = 0
    iVideoHeight: int = 0
    fFrameRate: float = 30.0
    iSpatialBitrate: int = 0
    iMaxSpatialBitrate: int = 0
    uiProfileIdc: int = PRO_BASELINE
    uiLevelIdc: int = 0
    iDLayerQp: int = 26
    sSliceArgument: SSliceArgument = field(default_factory=SSliceArgument)


@dataclass
class SEncParamBase:
    """codec_app_def.h:525-535."""
    iUsageType: int = CAMERA_VIDEO_REAL_TIME
    iPicWidth: int = 0
    iPicHeight: int = 0
    iTargetBitrate: int = 5000000
    iRCMode: int = RC_QUALITY_MODE
    fMaxFrameRate: float = 30.0


@dataclass
class SEncParamExt(SEncParamBase):
    """codec_app_def.h:540-598 (fields the TPU engine consumes; the rest
    accepted-and-recorded for API parity)."""
    iTemporalLayerNum: int = 1
    iSpatialLayerNum: int = 1
    sSpatialLayers: list[SSpatialLayerConfig] = field(default_factory=list)
    iComplexityMode: int = 0
    uiIntraPeriod: int = 0
    iNumRefFrame: int = 1
    eSpsPpsIdStrategy: int = 0
    bPrefixNalAddingCtrl: bool = False
    bEnableSSEI: bool = False
    bSimulcastAVC: bool = False
    iPaddingFlag: int = 0
    iEntropyCodingModeFlag: int = 0
    bEnableFrameSkip: bool = True
    iMaxBitrate: int = 0
    iMaxQp: int = 51
    iMinQp: int = 0
    uiMaxNalSize: int = 0
    bEnableLongTermReference: bool = False
    iLTRRefNum: int = 0
    iLtrMarkPeriod: int = 30
    iMultipleThreadIdc: int = 1
    bUseLoadBalancing: bool = True
    iLoopFilterDisableIdc: int = 0
    iLoopFilterAlphaC0Offset: int = 0
    iLoopFilterBetaOffset: int = 0
    bEnableDenoise: bool = False
    bEnableBackgroundDetection: bool = True
    bEnableAdaptiveQuant: bool = True
    bEnableFrameCroppingFlag: bool = True
    bEnableSceneChangeDetect: bool = True
    bIsLosslessLink: bool = False
    bFixRCOverShoot: bool = False
    iIdrBitrateRatio: int = 400
    # convenience extension (maps to sSpatialLayers[0].iDLayerQp)
    iInitialQp: int = 26


@dataclass
class SDecodingParam:
    """codec_app_def.h:611-621."""
    pFileNameRestructed: str | None = None
    uiCpuLoad: int = 0
    uiTargetDqLayer: int = 255
    eEcActiveIdc: int = 2            # ERROR_CON_SLICE_COPY
    bParseOnly: bool = False
    sVideoProperty_eVideoBsType: int = VIDEO_BITSTREAM_AVC


@dataclass
class SEncoderStatistics:
    """codec_app_def.h:745-770."""
    uiWidth: int = 0
    uiHeight: int = 0
    fAverageFrameSpeedInMs: float = 0.0
    fAverageFrameRate: float = 0.0
    fLatestFrameRate: float = 0.0
    uiBitRate: int = 0
    uiAverageFrameQP: float = 0.0
    uiInputFrameCount: int = 0
    uiSkippedFrameCount: int = 0
    uiResolutionChangeTimes: int = 0
    uiIDRReqNum: int = 0
    uiIDRSentNum: int = 0
    uiLTRSentNum: int = 0
    iTotalEncodedBytes: int = 0
    iStatisticsTs: int = 0
    # per-sequence average PSNR of the reconstructed frames vs input
    # (codec_app_def.h:595-597 frame PSNR / utils.cpp:43 WelsCalcPsnr)
    fAveragePsnrY: float = 0.0
    fAveragePsnrU: float = 0.0
    fAveragePsnrV: float = 0.0


@dataclass
class SDecoderStatistics:
    """codec_app_def.h:775-809."""
    uiWidth: int = 0
    uiHeight: int = 0
    fAverageFrameSpeedInMs: float = 0.0
    fActualAverageFrameSpeedInMs: float = 0.0
    uiDecodedFrameCount: int = 0
    uiResolutionChangeTimes: int = 0
    uiIDRCorrectNum: int = 0
    uiAvgEcRatio: int = 0
    uiAvgEcPropRatio: int = 0
    uiEcIDRNum: int = 0
    uiEcFrameNum: int = 0
    uiIDRLostNum: int = 0
    uiFreezingIDRNum: int = 0
    uiFreezingNonIDRNum: int = 0
    iAvgLumaQp: int = 0
    uiProfile: int = 0
    uiLevel: int = 0
