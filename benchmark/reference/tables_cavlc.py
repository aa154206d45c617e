"""CAVLC VLC code tables (ITU-T H.264 §9.2, Tables 9-4/9-5/9-7/9-8/9-9/9-10).

All values are constants prescribed by the standard (reference parity
anchor: codec/encoder/core/src/encoder_data_tables.cpp:84-314).

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/tables/cavlc.py; only its imports changed.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# coeff_token (Table 9-5): COEFF_TOKEN[nc_class][total_coeff][trailing_ones]
#  = (code value, code length); nc_class: 0: 0<=nC<2, 1: 2<=nC<4, 2: 4<=nC<8,
#  3: nC>=8 (6-bit FLC), 4: nC==-1 (chroma DC)
# --------------------------------------------------------------------------
_CT = np.zeros((5, 17, 4, 2), dtype=np.int32)


def _fill(cls, rows):
    for tc, row in enumerate(rows):
        for t1, (val, ln) in enumerate(row):
            _CT[cls, tc, t1] = (val, ln)


_fill(0, [
    [(1, 1)], [(5, 6), (1, 2)], [(7, 8), (4, 6), (1, 3)],
    [(7, 9), (6, 8), (5, 7), (3, 5)],
    [(7, 10), (6, 9), (5, 8), (3, 6)],
    [(7, 11), (6, 10), (5, 9), (4, 7)],
    [(15, 13), (6, 11), (5, 10), (4, 8)],
    [(11, 13), (14, 13), (5, 11), (4, 9)],
    [(8, 13), (10, 13), (13, 13), (4, 10)],
    [(15, 14), (14, 14), (9, 13), (4, 11)],
    [(11, 14), (10, 14), (13, 14), (12, 13)],
    [(15, 15), (14, 15), (9, 14), (12, 14)],
    [(11, 15), (10, 15), (13, 15), (8, 14)],
    [(15, 16), (1, 15), (9, 15), (12, 15)],
    [(11, 16), (14, 16), (13, 16), (8, 15)],
    [(7, 16), (10, 16), (9, 16), (12, 16)],
    [(4, 16), (6, 16), (5, 16), (8, 16)],
])
_fill(1, [
    [(3, 2)], [(11, 6), (2, 2)], [(7, 6), (7, 5), (3, 3)],
    [(7, 7), (10, 6), (9, 6), (5, 4)],
    [(7, 8), (6, 6), (5, 6), (4, 4)],
    [(4, 8), (6, 7), (5, 7), (6, 5)],
    [(7, 9), (6, 8), (5, 8), (8, 6)],
    [(15, 11), (6, 9), (5, 9), (4, 6)],
    [(11, 11), (14, 11), (13, 11), (4, 7)],
    [(15, 12), (10, 11), (9, 11), (4, 9)],
    [(11, 12), (14, 12), (13, 12), (12, 11)],
    [(8, 12), (10, 12), (9, 12), (8, 11)],
    [(15, 13), (14, 13), (13, 13), (12, 12)],
    [(11, 13), (10, 13), (9, 13), (12, 13)],
    [(7, 13), (11, 14), (6, 13), (8, 13)],
    [(9, 14), (8, 14), (10, 14), (1, 13)],
    [(7, 14), (6, 14), (5, 14), (4, 14)],
])
_fill(2, [
    [(15, 4)], [(15, 6), (14, 4)], [(11, 6), (15, 5), (13, 4)],
    [(8, 6), (12, 5), (14, 5), (12, 4)],
    [(15, 7), (10, 5), (11, 5), (11, 4)],
    [(11, 7), (8, 5), (9, 5), (10, 4)],
    [(9, 7), (14, 6), (13, 6), (9, 4)],
    [(8, 7), (10, 6), (9, 6), (8, 4)],
    [(15, 8), (14, 7), (13, 7), (13, 5)],
    [(11, 8), (14, 8), (10, 7), (12, 6)],
    [(15, 9), (10, 8), (13, 8), (12, 7)],
    [(11, 9), (14, 9), (9, 8), (12, 8)],
    [(8, 9), (10, 9), (13, 9), (8, 8)],
    [(13, 10), (7, 9), (9, 9), (12, 9)],
    [(9, 10), (12, 10), (11, 10), (10, 10)],
    [(5, 10), (8, 10), (7, 10), (6, 10)],
    [(1, 10), (4, 10), (3, 10), (2, 10)],
])
# nC >= 8: 6-bit FLC, code = 4*(TotalCoeff-1)+TrailingOnes except specials
_fill(3, [[(3, 6)], [(0, 6), (1, 6)], [(4, 6), (5, 6), (6, 6)]] +
      [[(4 * tc - 4 + t1, 6) for t1 in range(4)] for tc in range(3, 17)])
_fill(4, [
    [(1, 2)], [(7, 6), (1, 1)], [(4, 6), (6, 6), (1, 3)],
    [(3, 6), (3, 7), (2, 7), (5, 6)],
    [(2, 6), (3, 8), (2, 8), (0, 7)],
])

COEFF_TOKEN = _CT

# --------------------------------------------------------------------------
# total_zeros, 4x4 blocks (Table 9-7/9-8): TOTAL_ZEROS[total_coeff][zeros]
# --------------------------------------------------------------------------
TOTAL_ZEROS = np.zeros((16, 16, 2), dtype=np.int32)
_tz = [
    None,
    [(1, 1), (3, 3), (2, 3), (3, 4), (2, 4), (3, 5), (2, 5), (3, 6),
     (2, 6), (3, 7), (2, 7), (3, 8), (2, 8), (3, 9), (2, 9), (1, 9)],
    [(7, 3), (6, 3), (5, 3), (4, 3), (3, 3), (5, 4), (4, 4), (3, 4),
     (2, 4), (3, 5), (2, 5), (3, 6), (2, 6), (1, 6), (0, 6)],
    [(5, 4), (7, 3), (6, 3), (5, 3), (4, 4), (3, 4), (4, 3), (3, 3),
     (2, 4), (3, 5), (2, 5), (1, 6), (1, 5), (0, 6)],
    [(3, 5), (7, 3), (5, 4), (4, 4), (6, 3), (5, 3), (4, 3), (3, 4),
     (3, 3), (2, 4), (2, 5), (1, 5), (0, 5)],
    [(5, 4), (4, 4), (3, 4), (7, 3), (6, 3), (5, 3), (4, 3), (3, 3),
     (2, 4), (1, 5), (1, 4), (0, 5)],
    [(1, 6), (1, 5), (7, 3), (6, 3), (5, 3), (4, 3), (3, 3), (2, 3),
     (1, 4), (1, 3), (0, 6)],
    [(1, 6), (1, 5), (5, 3), (4, 3), (3, 3), (3, 2), (2, 3), (1, 4),
     (1, 3), (0, 6)],
    [(1, 6), (1, 4), (1, 5), (3, 3), (3, 2), (2, 2), (2, 3), (1, 3),
     (0, 6)],
    [(1, 6), (0, 6), (1, 4), (3, 2), (2, 2), (1, 3), (1, 2), (1, 5)],
    [(1, 5), (0, 5), (1, 3), (3, 2), (2, 2), (1, 2), (1, 4)],
    [(0, 4), (1, 4), (1, 3), (2, 3), (1, 1), (3, 3)],
    [(0, 4), (1, 4), (1, 2), (1, 1), (1, 3)],
    [(0, 3), (1, 3), (1, 1), (1, 2)],
    [(0, 2), (1, 2), (1, 1)],
    [(0, 1), (1, 1)],
]
for _tc in range(1, 16):
    for _z, (v, l) in enumerate(_tz[_tc]):
        TOTAL_ZEROS[_tc, _z] = (v, l)

# total_zeros for chroma DC 2x2 (Table 9-9a): [total_coeff][zeros]
TOTAL_ZEROS_CHROMA_DC = np.zeros((4, 4, 2), dtype=np.int32)
for _tc, rows in enumerate([None,
                            [(1, 1), (1, 2), (1, 3), (0, 3)],
                            [(1, 1), (1, 2), (0, 2)],
                            [(1, 1), (0, 1)]]):
    if rows:
        for _z, (v, l) in enumerate(rows):
            TOTAL_ZEROS_CHROMA_DC[_tc, _z] = (v, l)

# --------------------------------------------------------------------------
# run_before (Table 9-10): RUN_BEFORE[min(zeros_left,7)][run]
# --------------------------------------------------------------------------
RUN_BEFORE = np.zeros((8, 15, 2), dtype=np.int32)
_rb = [
    None,
    [(1, 1), (0, 1)],
    [(1, 1), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (0, 2)],
    [(3, 2), (2, 2), (1, 2), (1, 3), (0, 3)],
    [(3, 2), (2, 2), (3, 3), (2, 3), (1, 3), (0, 3)],
    [(3, 2), (0, 3), (1, 3), (3, 3), (2, 3), (5, 3), (4, 3)],
    [(7, 3), (6, 3), (5, 3), (4, 3), (3, 3), (2, 3), (1, 3), (1, 4),
     (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)],
]
for _zl in range(1, 8):
    for _r, (v, l) in enumerate(_rb[_zl]):
        RUN_BEFORE[_zl, _r] = (v, l)

# --------------------------------------------------------------------------
# coded_block_pattern ue(v) mapping (Table 9-4), 4:2:0
# codeNum -> cbp  (intra_4x4/intra_8x8 column and inter column)
# --------------------------------------------------------------------------
CBP_INTRA = np.array([
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41], dtype=np.int32)
CBP_INTER = np.array([
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41], dtype=np.int32)
# inverse: cbp -> codeNum (encoder side)
CBP_INTRA_INV = np.argsort(CBP_INTRA).astype(np.int32)
CBP_INTER_INV = np.argsort(CBP_INTER).astype(np.int32)
# monochrome (4:0:0) variants
CBP_INTRA_400 = np.array([15, 0, 7, 11, 13, 14, 3, 5, 10, 12, 1, 2, 4, 8, 6, 9],
                         dtype=np.int32)
CBP_INTER_400 = np.array([0, 1, 2, 4, 8, 3, 5, 10, 12, 15, 7, 11, 13, 14, 6, 9],
                         dtype=np.int32)

# cbp of I_16x16 mb types: index (mb_type-1)>>2  (luma 0/15 x chroma 0/1/2)
CBP_I16x16 = np.array([0, 16, 32, 15, 31, 47], dtype=np.int32)

# nC mapping used when picking the coeff_token class: nC value -> class
NC_TO_CLASS = np.array([0, 0, 1, 1, 2, 2, 2, 2] + [3] * 9 + [3], dtype=np.int32)


# --------------------------------------------------------------------------
# Decode LUT generation
# --------------------------------------------------------------------------
def _build_lut(entries, bits):
    """entries: list of (value, length, payload...); returns uint32 LUT of
    size 2^bits mapping bit-prefix -> packed (payload..., length) or 0 if
    invalid. Packing: (tc<<10 | t1<<5 | len) for coeff_token;
    generic: (sym<<5 | len)."""
    lut = np.zeros(1 << bits, dtype=np.uint32)
    for val, ln, packed in entries:
        base = val << (bits - ln)
        span = 1 << (bits - ln)
        assert (lut[base:base + span] == 0).all(), "VLC prefix collision"
        lut[base:base + span] = packed
    return lut


_MAX_CT_BITS = 16


def build_coeff_token_luts():
    """Per nc-class LUT over 16-bit prefix -> (tc<<10)|(t1<<7)|len, 0=invalid."""
    luts = []
    for cls in range(5):
        entries = []
        for tc in range(17):
            for t1 in range(4):
                val, ln = int(COEFF_TOKEN[cls, tc, t1, 0]), int(COEFF_TOKEN[cls, tc, t1, 1])
                if ln == 0:
                    continue  # unused (tc,t1) slot
                entries.append((val, ln, (tc << 10) | (t1 << 7) | ln))
        luts.append(_build_lut(entries, _MAX_CT_BITS))
    return luts


def build_simple_luts(table, bits):
    """For TOTAL_ZEROS / RUN_BEFORE style [ctx][sym] = (val, len) tables:
    returns [ctx] list of LUTs prefix -> (sym<<5)|len."""
    nctx = table.shape[0]
    luts = []
    for c in range(nctx):
        entries = []
        for sym in range(table.shape[1]):
            val, ln = int(table[c, sym, 0]), int(table[c, sym, 1])
            if ln == 0:
                continue
            entries.append((val, ln, (sym << 5) | ln))
        luts.append(_build_lut(entries, bits) if entries else np.zeros(1 << bits, np.uint32))
    return luts


COEFF_TOKEN_LUTS = build_coeff_token_luts()
TOTAL_ZEROS_LUTS = build_simple_luts(TOTAL_ZEROS, 9)
TOTAL_ZEROS_CDC_LUTS = build_simple_luts(TOTAL_ZEROS_CHROMA_DC, 3)
RUN_BEFORE_LUTS = build_simple_luts(RUN_BEFORE, 11)
