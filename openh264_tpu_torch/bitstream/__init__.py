from .bits import BitReader, BitWriter
from .nal import (
    NAL_SLICE,
    NAL_IDR,
    NAL_SEI,
    NAL_SPS,
    NAL_PPS,
    NAL_SUBSET_SPS,
    NAL_SLICE_EXT,
    NalUnit,
    escape_rbsp,
    find_start_codes,
    make_annexb_nal,
    split_annexb,
    unescape_rbsp,
)
