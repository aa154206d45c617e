"""Dequantization with optional scaling lists (High profile).

Parity: decode_slice.cpp:1486 WelsCalcDeqCoeffScalingList and the
per-property scaling in parse_mb_syn_cavlc/cabac residual paths:
- flat 4x4: level * DEQUANT_4x4[qp][pos]
- list 4x4: (level * sl4[prop][pos] * DEQUANT_4x4[qp][pos] + 8) >> 4
- flat 8x8: base = 16*V8; list 8x8: base = sl8[prop]*V8; then
  qp>=36 ? v<<(qp/6-6) : (v + (1<<(5-qp/6))) >> (6-qp/6)
Properties: 0..2 intra Y/Cb/Cr, 3..5 inter Y/Cb/Cr (4x4); 0 intra /
1 inter (8x8).

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/decoder/dequant.py; only its imports changed.
"""

from __future__ import annotations

import numpy as np

from .tables_core import DEQUANT_4x4, DEQUANT_8x8

_H2 = np.array([[1, 1], [1, -1]], dtype=np.int32)
_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], dtype=np.int32)


def wrap_i16(x: np.ndarray) -> np.ndarray:
    """Wrap int32 values to int16 two's-complement (models C int16_t store)."""
    return ((x.astype(np.int64) + 0x8000) % 0x10000 - 0x8000).astype(np.int32)


def hadamard2x2(x: np.ndarray) -> np.ndarray:
    """2x2 Hadamard (self-inverse up to scale) for chroma DC, no rounding."""
    return _H2 @ x.astype(np.int32) @ _H2.T


def luma_dc_dequant_ihadamard(dc: np.ndarray, qmul: int) -> np.ndarray:
    """I16x16 luma DC inverse: IHadamard then (v * qmul + 32)>>6, with
    qmul from DequantTables.luma_dc_qmul; the per-4x4-block DC values,
    stored int16 in the reference (decode_slice.cpp:246)."""
    t = _H4 @ dc.astype(np.int32) @ _H4.T
    return wrap_i16((t * qmul + 32) >> 6)


class DequantTables:
    def __init__(self, sps, pps):
        self.use = bool(sps.seq_scaling_matrix_present or
                        pps.pic_scaling_matrix_present)
        if not self.use:
            return
        if pps.pic_scaling_matrix_present:
            sl4, sl8 = pps.scaling_lists_4x4, pps.scaling_lists_8x8
        else:
            sl4, sl8 = sps.scaling_lists_4x4, sps.scaling_lists_8x8
        self.dq4 = np.zeros((6, 52, 16), dtype=np.int64)
        for p in range(6):
            for qp in range(52):
                self.dq4[p, qp] = sl4[p].astype(np.int64) * DEQUANT_4x4[qp]
        n8 = len(sl8) if sl8 is not None else 0
        self.dq8 = np.zeros((max(2, n8), 52, 64), dtype=np.int64)
        for p in range(n8):
            for qp in range(52):
                self.dq8[p, qp] = sl8[p].astype(np.int64) * DEQUANT_8x8[qp]

    def eff4(self) -> np.ndarray:
        """The C parser's [6][52][16] int64 table (property x QP x
        position): the per-property list products with scaling lists,
        else DEQUANT_4x4 << 4 for every property, so that
        (level*dq + 8) >> 4 equals the flat multiply exactly."""
        if self.use:
            return np.ascontiguousarray(self.dq4, np.int64)
        flat = DEQUANT_4x4.astype(np.int64) << 4
        return np.ascontiguousarray(
            np.broadcast_to(flat, (6, 52, 16)).copy(), np.int64)

    # ---- 4x4 AC ----
    def luma_ac(self, levels16, qp: int, intra: bool):
        if not self.use:
            return levels16 * DEQUANT_4x4[qp]
        prop = 0 if intra else 3
        return ((levels16.astype(np.int64) * self.dq4[prop, qp] + 8) >> 4).astype(np.int32)

    def chroma_ac(self, levels16, qp_c: int, intra: bool, comp: int):
        if not self.use:
            return levels16 * DEQUANT_4x4[qp_c]
        prop = (1 + comp) if intra else (4 + comp)
        return ((levels16.astype(np.int64) * self.dq4[prop, qp_c] + 8) >> 4).astype(np.int32)

    # ---- DC multipliers ----
    def luma_dc_qmul(self, qp: int) -> int:
        if not self.use:
            return int(DEQUANT_4x4[qp][0]) << 4
        return int(self.dq4[0, qp, 0])

    def chroma_dc(self, had2x2, qp_c: int, intra: bool, comp: int):
        """Input: 2x2 after inverse Hadamard; returns scaled int32."""
        if not self.use:
            return wrap_i16((had2x2 * int(DEQUANT_4x4[qp_c][0])) >> 1)
        prop = (1 + comp) if intra else (4 + comp)
        return wrap_i16((had2x2.astype(np.int64) * int(self.dq4[prop, qp_c, 0])) >> 5)

    # ---- 8x8 ----
    def luma8x8(self, levels64, qp: int, intra: bool):
        if not self.use:
            base = levels64.astype(np.int64) * (DEQUANT_8x8[qp].astype(np.int64) * 16)
        else:
            prop = 0 if intra else 1
            base = levels64.astype(np.int64) * self.dq8[prop, qp]
        if qp >= 36:
            return (base << (qp // 6 - 6)).astype(np.int32)
        return ((base + (1 << (5 - qp // 6))) >> (6 - qp // 6)).astype(np.int32)
