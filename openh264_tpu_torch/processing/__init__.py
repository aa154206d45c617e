"""Video processing (VP) library of the port (port of
openh264_tpu/processing): the reference's stand-alone preprocessing
plugin (codec/processing, behind IWelsVP — interface/IWelsVP.h:122-136,
method registry WelsFrameWork.cpp) as batched tensor functions. Frames
are [H, W] uint8 tensors and block statistics [mbH, mbW, ...] tensors
on the caller's device; the per-MB maps that adaptive quant and the
complexity analysis make are host numpy, as in the JAX package.

- METHOD_DENOISE              -> denoise.denoise_frame
- METHOD_SCENE_CHANGE_DETECTION_VIDEO/_SCREEN ->
  scenechange.detect_scene_change
- METHOD_DOWNSAMPLE           -> downsample.{dyadic,general_bilinear}
- METHOD_VAA_STATISTICS       -> vaa.vaa_calc
- METHOD_BACKGROUND_DETECTION -> background.background_division
- METHOD_ADAPTIVE_QUANT       -> adaptivequant.adaptive_quant_map
- METHOD_COMPLEXITY_ANALYSIS(_SCREEN) ->
  complexity.{frame,gom}_complexity
- METHOD_IMAGE_ROTATE         -> rotate.rotate_image
- METHOD_SCROLL_DETECTION     -> scroll.detect_scroll
"""

from .vaa import vaa_calc
from .downsample import dyadic_downsample, general_bilinear_downsample
from .denoise import denoise_frame
from .scenechange import (detect_scene_change, SCENE_CHANGED_LARGE,
                          SCENE_CHANGED_MEDIUM, SIMILAR)
from .background import background_division
from .adaptivequant import adaptive_quant_map
from .complexity import frame_complexity, gom_complexity
from .rotate import rotate_image
from .scroll import detect_scroll
