"""Public encoder SDK surface mirroring the reference codec API (port of
openh264_tpu/api, encoder side): CWelsH264SVCEncoder and its factory,
the parameter and statistics structs (codec_app_def.h:525-621,
:745-809) and the option ids (codec_app_def.h:106-172)."""

from .params import (SEncParamBase, SEncParamExt, SSpatialLayerConfig,
                     SEncoderStatistics, SSliceArgument,
                     CAMERA_VIDEO_REAL_TIME, SCREEN_CONTENT_REAL_TIME,
                     RC_QUALITY_MODE, RC_BITRATE_MODE, RC_BUFFERBASED_MODE,
                     RC_TIMESTAMP_MODE, RC_OFF_MODE, RC_MODES,
                     SM_SINGLE_SLICE, SM_FIXEDSLCNUM_SLICE, SM_RASTER_SLICE,
                     SM_SIZELIMITED_SLICE)
from .options import ENCODER_OPTION
from .encoder_api import CWelsH264SVCEncoder, WelsCreateSVCEncoder

__all__ = [n for n in dir() if not n.startswith("_")]
