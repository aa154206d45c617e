"""CABAC entropy decoding (H.264 §9.3): contexts, tables and engine.

Copied from openh264_tpu/decoder/cabac.py: the ctxIdx offsets, the
residual-category tables, CabacContexts (the per-slice context
initialisation from the m,n table) and CabacEngine, the spec arithmetic
decoder (§9.3.3.2) bit for bit. The context layout is the spec's ctxIdx
space 0..459, which the reference uses too (decoder_context.h
NEW_CTX_OFFSET_*). The host encoder's writer (encoder/cabac_enc.py)
shares the contexts and tables; the decoder's per-MB slice parser
(slice_dec_cabac.py) runs the engine, with the residual bins in host C
(csrc/cabac_residual.c) over the same engine state, and the host C
parser of whole slices (csrc/parse_cabac.c) carries its own copy of
the engine and the context initialisation, from the same tables.
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


class CabacEngine:
    """Spec arithmetic decoding engine (§9.3.3.2) over an RBSP buffer."""

    __slots__ = ("data", "nbits", "pos", "range", "offset")

    def __init__(self, data: bytes, bitpos: int):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = bitpos
        # cabac_alignment_one_bit: align to byte boundary
        while self.pos & 7:
            self.pos += 1
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        data = self.data
        pos = self.pos
        for _ in range(n):
            if pos < self.nbits:
                v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            else:
                v <<= 1  # past-the-end bits read as 0 (trailing)
            pos += 1
        self.pos = pos
        return v

    def decision(self, ctx, idx: int) -> int:
        state = ctx.state[idx]
        lps = int(RANGE_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bit = 1 - ctx.mps[idx]
            self.offset -= self.range
            self.range = lps
            if state == 0:
                ctx.mps[idx] ^= 1
            ctx.state[idx] = STATE_TRANS[state, 0]
        else:
            bit = ctx.mps[idx]
            ctx.state[idx] = STATE_TRANS[state, 1]
        # renormalize
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return int(bit)

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            # Engine terminates. self.pos stays at the consumed-bit point;
            # any following data (PCM samples, rbsp trailing) starts at the
            # next byte boundary from here (parity:
            # RestoreCabacDecEngineToBS, cabac_decoder.cpp:94).
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return 0

    # composite decoders -------------------------------------------------
    def unary(self, ctx, idx0: int, idx_rest: int, max_sym: int = 2**30) -> int:
        if not self.decision(ctx, idx0):
            return 0
        v = 1
        while v < max_sym and self.decision(ctx, idx_rest):
            v += 1
        return v

    def exp_bypass(self, k: int) -> int:
        """Exp-Golomb suffix of order k, bypass bins."""
        v = 0
        while self.bypass():
            v += 1 << k
            k += 1
            if k > 16:
                raise ValueError("runaway exp-golomb in CABAC")
        for i in range(k - 1, -1, -1):
            v += self.bypass() << i
        return v

    def ueg_mv(self, ctx, base: int) -> int:
        """UEG3 suffix for |mvd|-1 after the first bin (caller decoded it)."""
        if not self.decision(ctx, base + MVD_BIN_CTX[0]):
            return 0
        v = 0
        cnt = 1
        while True:
            bit = self.decision(ctx, base + MVD_BIN_CTX[min(cnt, 7)])
            v += 1
            cnt += 1
            if bit == 0 or cnt == 8:
                break
        if bit != 0:
            v += self.exp_bypass(3) + 1
        return v

    def ueg_level(self, ctx, idx: int) -> int:
        """UEG0 for coeff_abs_level_minus1 - 1 (after the >1 bin)."""
        if not self.decision(ctx, idx):
            return 0
        v = 0
        cnt = 1
        while True:
            bit = self.decision(ctx, idx)
            v += 1
            cnt += 1
            if bit == 0 or cnt == 13:
                break
        if bit != 0:
            v += self.exp_bypass(0) + 1
        return v


class CabacContexts:
    __slots__ = ("state", "mps")

    def __init__(self, slice_type_is_i: bool, cabac_init_idc: int, qp: int):
        model = 0 if slice_type_is_i else cabac_init_idc + 1
        m = CTX_INIT_MN[:, model, 0]
        n = CTX_INIT_MN[:, model, 1]
        pre = np.clip(((m * qp) >> 4) + n, 1, 126)
        self.mps = (pre > 63).astype(np.int32)
        self.state = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int32)
