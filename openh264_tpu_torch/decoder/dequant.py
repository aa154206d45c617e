"""Dequantization tables of the decoder's slices.

Parity: decode_slice.cpp:1486 WelsCalcDeqCoeffScalingList and the
per-property scaling in parse_mb_syn_cavlc residual paths; flat 4x4:
level * DEQUANT_4x4[qp][pos].

Port of openh264_tpu/decoder/dequant.py's DequantTables, flat tables
only, with `eff4` from openh264_tpu/native/__init__.py::_dq_eff: the
host C parser (csrc/parse_cavlc.c) dequantises with that table. Scaling
lists (High profile) are parsed by params.py but refused by
slice_dec.check_scope; the JAX module's per-list products and its
per-coefficient methods, which served its per-MB Python parser, are not
carried.
"""

from __future__ import annotations

import numpy as np

from ..tables import DEQUANT_4x4


class DequantTables:
    def __init__(self, sps, pps):
        self.use = bool(sps.seq_scaling_matrix_present or
                        pps.pic_scaling_matrix_present)

    def eff4(self) -> np.ndarray:
        """The C parser's [6][52][16] int64 table: DEQUANT_4x4 << 4 for
        every property, so that (level*dq + 8) >> 4 equals the flat
        multiply exactly."""
        if self.use:
            raise NotImplementedError("scaling lists are decoded by the JAX "
                                      "package only")
        flat = DEQUANT_4x4.astype(np.int64) << 4
        return np.ascontiguousarray(
            np.broadcast_to(flat, (6, 52, 16)).copy(), np.int64)
