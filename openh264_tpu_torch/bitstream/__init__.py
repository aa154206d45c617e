from .bits import BitWriter
from .nal import (
    NAL_SLICE,
    NAL_IDR,
    NAL_SPS,
    NAL_PPS,
    escape_rbsp,
    make_annexb_nal,
)
