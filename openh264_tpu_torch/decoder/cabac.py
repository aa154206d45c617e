"""CABAC context tables and state (H.264 §9.3.1).

Copied from openh264_tpu/decoder/cabac.py, the encoder's share: the
ctxIdx offsets, the residual-category tables and CabacContexts (the
per-slice context initialisation from the m,n table). The context
layout is the spec's ctxIdx space 0..459, which the reference uses too
(decoder_context.h NEW_CTX_OFFSET_*). The arithmetic decoding engine
(CabacEngine) is not copied: the port has no decoder yet.
"""

from __future__ import annotations

import os

import numpy as np

_TBL = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + "/tables"
CTX_INIT_MN = np.load(os.path.join(_TBL, "cabac_init_mn.npy"))     # [460][4][2]
RANGE_LPS = np.load(os.path.join(_TBL, "cabac_range_lps.npy"))     # [64][4]
STATE_TRANS = np.load(os.path.join(_TBL, "cabac_state_trans.npy"))  # [64][2] (LPS, MPS)

N_CTX = 460

# ctx offsets (== spec ctxIdx bases)
CTX_MB_TYPE_I = 3
CTX_SKIP = 11       # P: 11-13; P mb_type prefix at 14-20
CTX_B_SKIP = 24
CTX_MB_TYPE_B = 27
CTX_MB_TYPE_B_INTRA = 32
CTX_SUBMB_TYPE = 21
CTX_B_SUBMB_TYPE = 36
CTX_MVD = 40        # x: 40-46, y: 47-53
CTX_REF_NO = 54
CTX_DELTA_QP = 60
CTX_CIPR = 64
CTX_IPR = 68
CTX_CBP = 73
CTX_CBF = 85
CTX_MAP = 105
CTX_LAST = 166
CTX_ONE = 227
CTX_ABS = 232
CTX_TS8 = 399
CTX_MAP_8x8 = 402
CTX_LAST_8x8 = 417
CTX_ONE_8x8 = 426
CTX_ABS_8x8 = 431

# residual "property" categories (same numbering idea as the reference)
I16_DC, I16_AC, LUMA_4x4, CHROMA_DC, CHROMA_AC, LUMA_8x8 = 1, 2, 3, 4, 5, 6
# per-category tables (index by property; LUMA_8x8 uses the 8x8 bases)
MAX_POS = {I16_DC: 15, I16_AC: 14, LUMA_4x4: 15, CHROMA_DC: 3, CHROMA_AC: 14,
           LUMA_8x8: 63}
MAX_C2 = {I16_DC: 4, I16_AC: 4, LUMA_4x4: 4, CHROMA_DC: 3, CHROMA_AC: 4,
          LUMA_8x8: 4}
OFF_CBF = {I16_DC: 0, I16_AC: 4, LUMA_4x4: 8, CHROMA_DC: 12, CHROMA_AC: 16}
OFF_MAP = {I16_DC: 0, I16_AC: 15, LUMA_4x4: 29, CHROMA_DC: 44, CHROMA_AC: 47,
           LUMA_8x8: 0}
OFF_ONE = {I16_DC: 0, I16_AC: 10, LUMA_4x4: 20, CHROMA_DC: 30, CHROMA_AC: 39,
           LUMA_8x8: 0}

# Table 9-43 maps for 8x8 significance (frame coding)
SIG8x8_CTX = np.array([
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12, 14],
    dtype=np.int32)
LAST8x8_CTX = np.array([0] + [1] * 15 + [2] * 16 + [3] * 8 + [4] * 8 +
                       [5] * 4 + [6] * 4 + [7] * 4 + [8] * 4, dtype=np.int32)
# mvd suffix bin -> relative ctx (bins 1..8 use +0,+1,+2,+3,+3,...)
MVD_BIN_CTX = [0, 1, 2, 3, 3, 3, 3, 3]


class CabacContexts:
    __slots__ = ("state", "mps")

    def __init__(self, slice_type_is_i: bool, cabac_init_idc: int, qp: int):
        model = 0 if slice_type_is_i else cabac_init_idc + 1
        m = CTX_INIT_MN[:, model, 0]
        n = CTX_INIT_MN[:, model, 1]
        pre = np.clip(((m * qp) >> 4) + n, 1, 126)
        self.mps = (pre > 63).astype(np.int32)
        self.state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)
