"""Slice data parsing: per-MB syntax -> FrameSymbols tensors.

The serial entropy phase of the decoder, on the host. Port of
openh264_tpu/decoder/slice_dec.py's SliceDecodeContext and
decode_slice_data_cavlc, which route I and P CAVLC slices to the host C
parser (slice_dec.py:702-707, native/__init__.py:189-254); here that C
(csrc/parse_cavlc.c through native.parse_cavlc_slice_native) is the
only parser. The JAX module's per-MB Python parser, which also covers B
slices, the 8x8 transform and FMO, is not carried yet: those slices,
CABAC (decoder.py) and scaling lists are refused with
NotImplementedError, which the decoder lets through, and never
concealed.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from .dequant import DequantTables
from .framedata import FrameSymbols
from .slicehdr import I_SLICE, P_SLICE, SliceHeader

_LATER = "is decoded by the JAX package only; the port's decoder takes " \
    "CAVLC I/P slices"


class SliceDecodeContext:
    """Per-slice parse state over a FrameSymbols target."""

    def __init__(self, fs: FrameSymbols, sh: SliceHeader, slice_idx: int,
                 ref_list0=None, ref_list1=None, poc: int = 0,
                 fmo_next=None):
        self.fs = fs
        self.sh = sh
        self.slice_idx = slice_idx
        self.fmo_next = fmo_next
        self.mb_w = fs.mb_w
        self.mb_h = fs.mb_h
        self.qp = sh.qp  # running luma QP
        self.constrained_intra = sh.pps.constrained_intra_pred
        self.ref_list0 = ref_list0 or []
        self.ref_list1 = ref_list1 or []
        self.poc = poc
        self.dq = DequantTables(sh.sps, sh.pps)
        # global intra-4x4-mode grid for mode prediction: -1 unavail
        # (shared across the picture's slices via fs)
        if not hasattr(fs, "i4_grid"):
            fs.i4_grid = np.full((fs.mb_h * 4, fs.mb_w * 4), -1,
                                 dtype=np.int32)


def check_scope(sh: SliceHeader) -> None:
    """Raises NotImplementedError for a slice this decoder does not
    take: CABAC, B (and SP/SI) slices, the 8x8 transform, FMO, scaling
    lists."""
    pps, sps = sh.pps, sh.sps
    if pps.entropy_coding_mode:
        raise NotImplementedError(f"CABAC {_LATER}")
    if sh.slice_type not in (I_SLICE, P_SLICE):
        raise NotImplementedError(f"slice type {sh.slice_type} (B/SP/SI) "
                                  f"{_LATER}")
    if pps.transform_8x8_mode:
        raise NotImplementedError(f"the 8x8 transform {_LATER}")
    if pps.num_slice_groups > 1:
        raise NotImplementedError(f"FMO (slice groups) {_LATER}")
    if sps.seq_scaling_matrix_present or pps.pic_scaling_matrix_present:
        raise NotImplementedError(f"scaling lists {_LATER}")


def decode_slice_data_cavlc(br: BitReader, ctx: SliceDecodeContext) -> int:
    """Parse all MBs of a slice. Returns index one past the last MB."""
    from ..native import parse_cavlc_slice_native
    check_scope(ctx.sh)
    return parse_cavlc_slice_native(br, ctx)
