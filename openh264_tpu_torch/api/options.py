"""Option-id enums of the public API (codec_app_def.h:106-205).

Copied from openh264_tpu/api/options.py.
"""

from __future__ import annotations

import enum


class ENCODER_OPTION(enum.IntEnum):
    """codec_app_def.h:106-146."""
    DATAFORMAT = 0
    IDR_INTERVAL = 1
    SVC_ENCODE_PARAM_BASE = 2
    SVC_ENCODE_PARAM_EXT = 3
    FRAME_RATE = 4
    BITRATE = 5
    MAX_BITRATE = 6
    INTER_SPATIAL_PRED = 7
    RC_MODE = 8
    RC_FRAME_SKIP = 9
    PADDING_PADDING = 10
    PROFILE = 11
    LEVEL = 12
    NUMBER_REF = 13
    DELIVERY_STATUS = 14
    LTR_RECOVERY_REQUEST = 15
    LTR_MARKING_FEEDBACK = 16
    LTR_MARKING_PERIOD = 17
    LTR = 18
    COMPLEXITY = 19
    ENABLE_SSEI = 20
    ENABLE_PREFIX_NAL_ADDING = 21
    SPS_PPS_ID_STRATEGY = 22
    CURRENT_PATH = 23
    DUMP_FILE = 24
    TRACE_LEVEL = 25
    TRACE_CALLBACK = 26
    TRACE_CALLBACK_CONTEXT = 27
    GET_STATISTICS = 28
    STATISTICS_LOG_INTERVAL = 29
    IS_LOSSLESS_LINK = 30
    BITS_VARY_PERCENTAGE = 31


class DECODER_OPTION(enum.IntEnum):
    """codec_app_def.h:150-172."""
    END_OF_STREAM = 1
    VCL_NAL = 2
    TEMPORAL_ID = 3
    FRAME_NUM = 4
    IDR_PIC_ID = 5
    LTR_MARKING_FLAG = 6
    LTR_MARKED_FRAME_NUM = 7
    ERROR_CON_IDC = 8
    TRACE_LEVEL = 9
    TRACE_CALLBACK = 10
    TRACE_CALLBACK_CONTEXT = 11
    GET_STATISTICS = 12
    GET_SAR_INFO = 13
    PROFILE = 14
    LEVEL = 15
    STATISTICS_LOG_INTERVAL = 16
    IS_REF_PIC = 17
    NUM_OF_FRAMES_REMAINING_IN_BUFFER = 18
    NUM_OF_THREADS = 19


class DECODING_STATE(enum.IntFlag):
    """codec_app_def.h:208-235 (subset)."""
    dsErrorFree = 0x00
    dsFramePending = 0x01
    dsRefLost = 0x02
    dsBitstreamError = 0x04
    dsDepLayerLost = 0x08
    dsNoParamSets = 0x10
    dsDataErrorConcealed = 0x20
    dsRefListNullPtrs = 0x40
    dsInvalidArgument = 0x1000
    dsInitialOptExpected = 0x2000
    dsOutOfMemory = 0x4000


# ERROR_CON_IDC (codec_app_def.h:177-186)
ERROR_CON_DISABLE = 0
ERROR_CON_FRAME_COPY = 1
ERROR_CON_SLICE_COPY = 2
ERROR_CON_FRAME_COPY_CROSS_IDR = 3
ERROR_CON_SLICE_COPY_CROSS_IDR = 4
ERROR_CON_SLICE_COPY_CROSS_IDR_FREEZE_RES_CHANGE = 5
ERROR_CON_SLICE_MV_COPY_CROSS_IDR = 6
ERROR_CON_SLICE_MV_COPY_CROSS_IDR_FREEZE_RES_CHANGE = 7
