"""Public SDK surface mirroring the reference codec API (port of
openh264_tpu/api): CWelsH264SVCEncoder and CWelsDecoder with their
factories, the parameter and statistics structs (codec_app_def.h:525-621,
:745-809) and the option ids (codec_app_def.h:106-205)."""

from .params import (SEncParamBase, SEncParamExt, SSpatialLayerConfig,
                     SDecodingParam, SEncoderStatistics, SDecoderStatistics,
                     SSliceArgument,
                     CAMERA_VIDEO_REAL_TIME, SCREEN_CONTENT_REAL_TIME,
                     RC_QUALITY_MODE, RC_BITRATE_MODE, RC_BUFFERBASED_MODE,
                     RC_TIMESTAMP_MODE, RC_OFF_MODE, RC_MODES,
                     SM_SINGLE_SLICE, SM_FIXEDSLCNUM_SLICE, SM_RASTER_SLICE,
                     SM_SIZELIMITED_SLICE)
from .options import ENCODER_OPTION, DECODER_OPTION, DECODING_STATE
from .encoder_api import CWelsH264SVCEncoder, WelsCreateSVCEncoder
from .decoder_api import CWelsDecoder, WelsCreateDecoder

__all__ = [n for n in dir() if not n.startswith("_")]
