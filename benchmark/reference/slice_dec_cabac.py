"""CABAC slice-data parsing -> FrameSymbols arrays.

A frozen copy of the port's CABAC parser
(openh264_tpu_torch/decoder/slice_dec_cabac.py) for I and P slices,
with the 8x8 transform syntax, every bin in Python on CabacEngine: the
port's host C residual bins (csrc/cabac_residual.c) are replaced by
their Python twin, residual_levels_plain. B slices are left out, as in
slice_dec.py. Mirrors slice_dec.py's CAVLC path with CABAC entropy
(H.264 clause 9.3).
"""

from __future__ import annotations

import numpy as np

from .tables_core import CHROMA_QP_TABLE, ZIGZAG_4x4, ZIGZAG_8x8
from .tables_cavlc import CBP_I16x16
from .cabac import (CabacContexts, CabacEngine, CTX_B_SKIP, CTX_CBF, CTX_CBP,
                    CTX_CIPR, CTX_DELTA_QP, CTX_IPR, CTX_MAP, CTX_MAP_8x8,
                    CTX_LAST, CTX_LAST_8x8, CTX_MVD, CTX_MB_TYPE_I,
                    CTX_ONE, CTX_ONE_8x8, CTX_ABS, CTX_ABS_8x8, CTX_REF_NO,
                    CTX_SKIP, CTX_SUBMB_TYPE, CTX_TS8, I16_DC, I16_AC,
                    LUMA_4x4, LUMA_8x8, CHROMA_DC, CHROMA_AC, MAX_POS,
                    MAX_C2, OFF_CBF, OFF_MAP, OFF_ONE, SIG8x8_CTX,
                    LAST8x8_CTX)
from .dequant import hadamard2x2, luma_dc_dequant_ihadamard
from .framedata import (MB_I4x4, MB_I16x16, MB_IPCM, MB_I8x8, MB_P16x16,
                        MB_P16x8, MB_P8x16, MB_P8x8, MB_PSKIP, INTRA_CLASSES,
                        ZSCAN_TO_RASTER)
from .slice_dec import (SliceDecodeContext, _mb_common_init,
                        _finish_inter_mb, _mark_intra_in_grids,
                        _P_SUB_SHAPES, _LUMA_DC_SCAN, check_scope)
from .slicehdr import I_SLICE


def ensure_cabac_state(fs):
    if fs.cbf_dc is None:
        fs.cbf_dc = np.zeros(fs.n_mb, dtype=np.int32)  # bits 0..2: I16DC,DCU,DCV
        h4, w4 = fs.mb_h * 4, fs.mb_w * 4
        fs.gmvd = np.zeros((2, h4, w4, 2), dtype=np.int32)
        fs.gdirect = np.zeros((h4, w4), dtype=np.int8)


class CabacSliceDecoder:
    def __init__(self, ctx: SliceDecodeContext, rbsp: bytes, bitpos: int):
        self.ctx = ctx
        self.fs = ctx.fs
        self.sh = ctx.sh
        ensure_cabac_state(self.fs)
        self.rbsp = rbsp
        qp = np.clip(ctx.qp, 0, 51)
        self.bctx = CabacContexts(self.sh.slice_type == I_SLICE,
                                  self.sh.cabac_init_idc, int(qp))
        self.eng = CabacEngine(rbsp, bitpos)
        self.last_dqp = 0

    # --- neighbor helpers -------------------------------------------------
    def _mb_xy(self, mb_idx):
        return mb_idx % self.ctx.mb_w, mb_idx // self.ctx.mb_w

    def left_top_mb(self, mb_idx):
        mbx, mby = self._mb_xy(mb_idx)
        left = mb_idx - 1 if self.ctx.mb_avail(mbx - 1, mby) else -1
        top = mb_idx - self.ctx.mb_w if self.ctx.mb_avail(mbx, mby - 1) else -1
        return left, top

    # --- syntax elements --------------------------------------------------
    def skip_flag(self, mb_idx, is_b: bool) -> bool:
        fs = self.fs
        left, top = self.left_top_mb(mb_idx)
        inc = 0
        if left >= 0 and fs.mb_type[left] != MB_PSKIP:
            inc += 1
        if top >= 0 and fs.mb_type[top] != MB_PSKIP:
            inc += 1
        base = CTX_B_SKIP if is_b else CTX_SKIP
        return bool(self.eng.decision(self.bctx, base + inc))

    def mb_type_i_slice(self, mb_idx) -> int:
        fs = self.fs
        left, top = self.left_top_mb(mb_idx)
        inc = 0
        if left >= 0 and fs.mb_type[left] not in (MB_I4x4, MB_I8x8):
            inc += 1
        if top >= 0 and fs.mb_type[top] not in (MB_I4x4, MB_I8x8):
            inc += 1
        return self._intra_mb_type(CTX_MB_TYPE_I, inc)

    def _intra_mb_type(self, base, first_inc=0) -> int:
        """Shared I mb_type suffix tree: returns raw intra mb_type 0..25."""
        eng, bctx = self.eng, self.bctx
        if not eng.decision(bctx, base + first_inc):
            return 0  # I4x4
        if eng.terminate():
            return 25  # IPCM
        v = 1 + 12 * eng.decision(bctx, base + 3)
        if eng.decision(bctx, base + 4):
            v += 4
            if eng.decision(bctx, base + 5):
                v += 4
        v += eng.decision(bctx, base + 6) << 1
        v += eng.decision(bctx, base + 7)
        return v

    def mb_type_p_slice(self) -> int:
        """Returns P mb_type raw: 0..4 inter, 5+ intra (5+intra_raw)."""
        eng, bctx = self.eng, self.bctx
        if eng.decision(bctx, CTX_SKIP + 3):
            # intra path (parity: ParseMBTypePSliceCabac: ctx 17..20)
            return 5 + self._intra_mb_type_suffix(CTX_SKIP + 6)
        if eng.decision(bctx, CTX_SKIP + 4):
            return 1 if eng.decision(bctx, CTX_SKIP + 6) else 2
        return 3 if eng.decision(bctx, CTX_SKIP + 5) else 0

    def _intra_mb_type_suffix(self, base) -> int:
        """Intra suffix inside P/B mb_type (ctx layout: base..base+2 with
        repeated contexts; parity: DecodeCabacIntraMbType)."""
        eng, bctx = self.eng, self.bctx
        if not eng.decision(bctx, base):
            return 0
        if eng.terminate():
            return 25
        v = 1 + 12 * eng.decision(bctx, base + 1)
        if eng.decision(bctx, base + 2):
            v += 4
            if eng.decision(bctx, base + 2):
                v += 4
        v += eng.decision(bctx, base + 3) << 1
        v += eng.decision(bctx, base + 3)
        return v

    def sub_mb_type_p(self) -> int:
        eng, bctx = self.eng, self.bctx
        if eng.decision(bctx, CTX_SUBMB_TYPE):
            return 0
        if eng.decision(bctx, CTX_SUBMB_TYPE + 1):
            return 3 - eng.decision(bctx, CTX_SUBMB_TYPE + 2)
        return 1

    def transform8_flag(self, mb_idx) -> bool:
        fs = self.fs
        left, top = self.left_top_mb(mb_idx)
        inc = 0
        if left >= 0 and fs.transform8[left]:
            inc += 1
        if top >= 0 and fs.transform8[top]:
            inc += 1
        return bool(self.eng.decision(self.bctx, CTX_TS8 + inc))

    def intra4x4_pred_mode(self) -> int:
        """Returns -1 for 'use predicted' else rem mode 0..7."""
        eng, bctx = self.eng, self.bctx
        if eng.decision(bctx, CTX_IPR):
            return -1
        v = eng.decision(bctx, CTX_IPR + 1)
        v |= eng.decision(bctx, CTX_IPR + 1) << 1
        v |= eng.decision(bctx, CTX_IPR + 1) << 2
        return v

    def intra_chroma_pred_mode(self, mb_idx) -> int:
        fs = self.fs
        left, top = self.left_top_mb(mb_idx)
        inc = 0
        if left >= 0 and fs.mb_type[left] != MB_IPCM and \
           fs.mb_type[left] in INTRA_CLASSES and 0 < fs.chroma_mode[left] <= 3:
            inc += 1
        if top >= 0 and fs.mb_type[top] != MB_IPCM and \
           fs.mb_type[top] in INTRA_CLASSES and 0 < fs.chroma_mode[top] <= 3:
            inc += 1
        eng, bctx = self.eng, self.bctx
        if not eng.decision(bctx, CTX_CIPR + inc):
            return 0
        if not eng.decision(bctx, CTX_CIPR + 3):
            return 1
        return 2 + eng.decision(bctx, CTX_CIPR + 3)

    def ref_idx(self, mb_idx, lx, gx, gy, num_active, is_b) -> int:
        """gx, gy: global 4x4 coords of the partition's first block."""
        if num_active <= 1:
            return 0
        fs = self.fs
        eng, bctx = self.eng, self.bctx

        def ngb(nx, ny):
            """(exists_with_ref>0, is_direct) of a neighbor block."""
            if nx < 0 or ny < 0:
                return False, False
            nmb = (ny // 4) * fs.mb_w + (nx // 4)
            if nmb == mb_idx:
                # within-MB: a neighbor counts as soon as its ref_idx is
                # parsed, before its MVs land (UpdateP8x8RefIdxCabac)
                if not fs.grefw[lx, ny, nx]:
                    return False, False
            else:
                if fs.slice_id[nmb] != fs.slice_id[mb_idx]:
                    return False, False
                if fs.mb_type[nmb] == MB_IPCM:
                    return False, False
            return (fs.gref[lx, ny, nx] > 0), bool(fs.gdirect[ny, nx])

        a_ref, a_dir = ngb(gx - 1, gy)
        b_ref, b_dir = ngb(gx, gy - 1)
        if is_b:
            inc = (2 if (b_ref and not b_dir) else 0) + \
                  (1 if (a_ref and not a_dir) else 0)
        else:
            inc = (1 if a_ref else 0) + (2 if b_ref else 0)
        if not eng.decision(bctx, CTX_REF_NO + inc):
            return 0
        # unary continuation: first bin ctx +4, subsequent +5
        if not eng.decision(bctx, CTX_REF_NO + 4):
            return self._clamp_ref(1, lx)
        v = 2
        while eng.decision(bctx, CTX_REF_NO + 5):
            v += 1
            if v > 32:
                raise ValueError("runaway ref_idx")
        return self._clamp_ref(v, lx)

    def _clamp_ref(self, r: int, lx: int) -> int:
        """Conceal out-of-range / missing refs with ref 0 (reference EC
        path, parse_mb_syn_cabac.cpp:545-553)."""
        rl = self.ctx.ref_list0 if lx == 0 else self.ctx.ref_list1
        return r if (0 <= r < len(rl) and rl[r] is not None) else 0

    def note_ref(self, lx, gx, gy, pw, ph, ref) -> None:
        """Record a parsed ref_idx in the neighbor grids before its MVs
        are known (the reference's per-partition ref-cache update in the
        ref loop: parse_mb_syn_cabac.cpp UpdateP{8x8,16x8,8x16}RefIdxCabac)."""
        fs = self.fs
        fs.gref[lx, gy:gy + ph, gx:gx + pw] = ref
        fs.grefw[lx, gy:gy + ph, gx:gx + pw] = True

    def mvd(self, mb_idx, lx, comp, gx, gy) -> int:
        fs = self.fs
        eng, bctx = self.eng, self.bctx
        base = CTX_MVD + comp * 7

        def amvd(nx, ny):
            if nx < 0 or ny < 0:
                return 0
            nmb = (ny // 4) * fs.mb_w + (nx // 4)
            if nmb == mb_idx:
                if not fs.gwritten[ny, nx]:
                    return 0
            elif fs.slice_id[nmb] != fs.slice_id[mb_idx]:
                return 0
            if fs.gref[lx, ny, nx] < 0:
                return 0
            return abs(int(fs.gmvd[lx, ny, nx, comp]))

        s = amvd(gx - 1, gy) + amvd(gx, gy - 1)
        inc = 0 if s < 3 else (2 if s > 32 else 1)
        if not eng.decision(bctx, base + inc):
            return 0
        v = eng.ueg_mv(self.bctx, base + 3) + 1
        if eng.bypass():
            v = -v
        return v

    def cbp(self, mb_idx) -> int:
        fs = self.fs
        eng, bctx = self.eng, self.bctx
        left, top = self.left_top_mb(mb_idx)
        lcbp = fs.cbp[left] if left >= 0 else 0
        tcbp = fs.cbp[top] if top >= 0 else 0
        lok = left >= 0 and fs.mb_type[left] != MB_IPCM
        tok = top >= 0 and fs.mb_type[top] != MB_IPCM
        btop = [tok and ((tcbp & (1 << 2)) == 0), tok and ((tcbp & (1 << 3)) == 0)]
        aleft = [lok and ((lcbp & (1 << 1)) == 0), lok and ((lcbp & (1 << 3)) == 0)]
        bits = [0] * 4
        cbp = 0
        inc = aleft[0] + (btop[0] << 1)
        bits[0] = eng.decision(bctx, CTX_CBP + inc)
        cbp |= bits[0]
        inc = (not bits[0]) + (btop[1] << 1)
        bits[1] = eng.decision(bctx, CTX_CBP + inc)
        cbp |= bits[1] << 1
        inc = aleft[1] + ((not bits[0]) << 1)
        bits[2] = eng.decision(bctx, CTX_CBP + inc)
        cbp |= bits[2] << 2
        inc = (not bits[2]) + ((not bits[1]) << 1)
        bits[3] = eng.decision(bctx, CTX_CBP + inc)
        cbp |= bits[3] << 3
        # chroma
        ib = top >= 0 and (fs.mb_type[top] == MB_IPCM or (fs.cbp[top] >> 4))
        ia = left >= 0 and (fs.mb_type[left] == MB_IPCM or (fs.cbp[left] >> 4))
        inc = bool(ia) + (bool(ib) << 1)
        if eng.decision(bctx, CTX_CBP + 4 + inc):
            ib = top >= 0 and (fs.mb_type[top] == MB_IPCM or (fs.cbp[top] >> 4) == 2)
            ia = left >= 0 and (fs.mb_type[left] == MB_IPCM or (fs.cbp[left] >> 4) == 2)
            inc = bool(ia) + (bool(ib) << 1)
            cbp |= 1 << (4 + eng.decision(bctx, CTX_CBP + 8 + inc))
        return cbp

    def delta_qp(self) -> int:
        eng, bctx = self.eng, self.bctx
        inc = 1 if self.last_dqp != 0 else 0
        dq = 0
        if eng.decision(bctx, CTX_DELTA_QP + inc):
            # unary continuation: first bin ctx +2, subsequent +3
            u = 0
            if eng.decision(bctx, CTX_DELTA_QP + 2):
                u = 1
                while eng.decision(bctx, CTX_DELTA_QP + 3):
                    u += 1
                    if u > 104:
                        raise ValueError("runaway delta qp")
            v = u + 1
            dq = (v + 1) >> 1
            if (v & 1) == 0:
                dq = -dq
        self.last_dqp = dq
        return dq

    # --- residuals --------------------------------------------------------
    def cbf(self, mb_idx, prop, gx=0, gy=0, comp=0, dc_bit=0) -> int:
        """coded_block_flag; for DC props pass dc_bit (0=I16DC,1=DCU,2=DCV)."""
        fs = self.fs
        cur_intra = fs.mb_type[mb_idx] in INTRA_CLASSES
        left, top = self.left_top_mb(mb_idx)
        na = nb = 1 if cur_intra else 0
        if prop in (I16_DC, CHROMA_DC):
            if top >= 0:
                nb = 1 if (fs.mb_type[top] == MB_IPCM or
                           ((fs.cbf_dc[top] >> dc_bit) & 1)) else 0
            if left >= 0:
                na = 1 if (fs.mb_type[left] == MB_IPCM or
                           ((fs.cbf_dc[left] >> dc_bit) & 1)) else 0
        else:
            # AC/4x4 blocks: global grid neighbors with availability
            grid = fs.nzc_l if prop in (I16_AC, LUMA_4x4) else fs.nzc_c[comp]
            scale = 4 if prop in (I16_AC, LUMA_4x4) else 2

            def blk_nz(nx, ny):
                if nx < 0 or ny < 0:
                    return None
                nmb = (ny // scale) * fs.mb_w + (nx // scale)
                if nmb != mb_idx and fs.slice_id[nmb] != fs.slice_id[mb_idx]:
                    return None
                if nmb != mb_idx and fs.mb_type[nmb] == MB_IPCM:
                    return 1
                return 1 if grid[ny, nx] else 0
            va = blk_nz(gx - 1, gy)
            vb = blk_nz(gx, gy - 1)
            if va is not None:
                na = va
            if vb is not None:
                nb = vb
        inc = na + (nb << 1)
        bit = self.eng.decision(self.bctx, CTX_CBF + OFF_CBF[prop] + inc)
        if bit and prop in (I16_DC, CHROMA_DC):
            fs.cbf_dc[mb_idx] |= 1 << dc_bit
        return bit

    def residual_levels(self, prop):
        """Sig map + levels of one block; returns (int32[maxpos+1] in
        scan order, coefficient count)."""
        return residual_levels_plain(self.eng, self.bctx, prop)


def residual_levels_plain(eng: CabacEngine, bctx: CabacContexts, prop):
    """The bin loop of one residual block (clause 9.3.2.3 / 9.3.3.1.3):
    significance map, then levels, high frequency first. Returns
    (levels in scan order, count)."""
    n = MAX_POS[prop] + 1
    sig = np.zeros(n, dtype=np.int32)
    if prop == LUMA_8x8:
        map_base = CTX_MAP_8x8 + OFF_MAP[prop]
        last_base = CTX_LAST_8x8 + OFF_MAP[prop]
    else:
        map_base = CTX_MAP + OFF_MAP[prop]
        last_base = CTX_LAST + OFF_MAP[prop]
    ncoef = 0
    ended = False
    for i in range(n - 1):
        ictx = int(SIG8x8_CTX[i]) if prop == LUMA_8x8 else i
        if eng.decision(bctx, map_base + ictx):
            sig[i] = 1
            ncoef += 1
            lctx = int(LAST8x8_CTX[i]) if prop == LUMA_8x8 else i
            if eng.decision(bctx, last_base + lctx):
                ended = True
                break
    if not ended:
        sig[n - 1] = 1
        ncoef += 1
    # levels, high frequency first
    if prop == LUMA_8x8:
        one_base = CTX_ONE_8x8 + OFF_ONE[prop]
        abs_base = CTX_ABS_8x8 + OFF_ONE[prop]
    else:
        one_base = CTX_ONE + OFF_ONE[prop]
        abs_base = CTX_ABS + OFF_ONE[prop]
    maxc2 = MAX_C2[prop]
    c1, c2 = 1, 0
    for i in range(n - 1, -1, -1):
        if sig[i] == 0:
            continue
        v = 1 + eng.decision(bctx, one_base + c1)
        if v == 2:
            v += eng.ueg_level(bctx, abs_base + c2)
            c2 = min(c2 + 1, maxc2)
            c1 = 0
        elif c1:
            c1 = min(c1 + 1, 4)
        if eng.bypass():
            v = -v
        sig[i] = v
    return sig, ncoef


# ---------------------------------------------------------------------------
# MB-level parse
# ---------------------------------------------------------------------------
def _store_mb_residual_cabac(dec: CabacSliceDecoder, mb_idx: int, cbp: int,
                             is_i16: bool) -> None:
    """Residual block loop (mirrors parse_mb_residual_cavlc's storage)."""
    ctx, fs, sh = dec.ctx, dec.fs, dec.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    intra = fs.mb_type[mb_idx] in (MB_I4x4, MB_I16x16, MB_I8x8)

    if is_i16 or cbp:
        delta = dec.delta_qp()
        if delta:
            ctx.qp = (ctx.qp + delta + 52) % 52
    else:
        dec.last_dqp = 0
    fs.qp[mb_idx] = ctx.qp
    qp = ctx.qp
    offs = (sh.pps.chroma_qp_index_offset, sh.pps.second_chroma_qp_index_offset)
    fs.chroma_qp_offsets = offs
    qp_c = [int(CHROMA_QP_TABLE[np.clip(qp + o, 0, 51)]) for o in offs]
    dq = ctx.dq

    if is_i16:
        if dec.cbf(mb_idx, I16_DC, dc_bit=0):
            dc_scan, _ = dec.residual_levels(I16_DC)
            dc = np.zeros(16, dtype=np.int32)
            dc[_LUMA_DC_SCAN] = dc_scan
            rec_dc = luma_dc_dequant_ihadamard(dc.reshape(4, 4),
                                               dq.luma_dc_qmul(qp))
            fs.coeffs_l[mb_idx, :, 0] = rec_dc.reshape(-1)

    if fs.transform8[mb_idx]:
        # one LUMA_8x8 block per coded 8x8 quadrant (no coded_block_flag)
        fs.ensure_coeffs8()
        for blk8 in range(4):
            gx = mbx * 4 + (blk8 % 2) * 2
            gy = mby * 4 + (blk8 // 2) * 2
            if not (cbp & (1 << blk8)):
                fs.nzc_l[gy:gy + 2, gx:gx + 2] = 0
                continue
            sig, tc = dec.residual_levels(LUMA_8x8)
            blkc = np.zeros(64, dtype=np.int32)
            blkc[ZIGZAG_8x8] = sig
            fs.coeffs8[mb_idx, blk8] = dq.luma8x8(blkc, qp, intra)
            fs.nzc_l[gy:gy + 2, gx:gx + 2] = min(tc, 16)
    else:
        for k in range(16):
            raster = int(ZSCAN_TO_RASTER[k])
            bx, by = raster % 4, raster // 4
            gx, gy = mbx * 4 + bx, mby * 4 + by
            blk8 = (by >> 1) * 2 + (bx >> 1)
            if not (cbp & (1 << blk8)):
                fs.nzc_l[gy, gx] = 0
                continue
            prop = I16_AC if is_i16 else LUMA_4x4
            if dec.cbf(mb_idx, prop, gx, gy):
                sig, tc = dec.residual_levels(prop)
                blkc = np.zeros(16, dtype=np.int32)
                if is_i16:
                    blkc[ZIGZAG_4x4[1:]] = sig
                else:
                    blkc[ZIGZAG_4x4] = sig
                deq = dq.luma_ac(blkc, qp, intra)
                if is_i16:
                    deq[0] = fs.coeffs_l[mb_idx, raster, 0]
                fs.coeffs_l[mb_idx, raster] = deq
                fs.nzc_l[gy, gx] = tc
            else:
                fs.nzc_l[gy, gx] = 0    # an I16 block keeps its DC

    if cbp & 0x30:
        for comp in range(2):
            if dec.cbf(mb_idx, CHROMA_DC, dc_bit=1 + comp):
                dc_scan, _ = dec.residual_levels(CHROMA_DC)
                had = hadamard2x2(dc_scan.reshape(2, 2))
                rec = dq.chroma_dc(had, qp_c[comp], intra, comp)
                fs.coeffs_c[mb_idx, comp, :, 0] = rec.reshape(-1)
    if cbp & 0x20:
        for comp in range(2):
            for k in range(4):
                bx, by = k % 2, k // 2
                cx, cy = mbx * 2 + bx, mby * 2 + by
                if dec.cbf(mb_idx, CHROMA_AC, cx, cy, comp=comp):
                    sig, tc = dec.residual_levels(CHROMA_AC)
                    blkc = np.zeros(16, dtype=np.int32)
                    blkc[ZIGZAG_4x4[1:]] = sig
                    deq = dq.chroma_ac(blkc, qp_c[comp], intra, comp)
                    deq[0] = fs.coeffs_c[mb_idx, comp, k, 0]
                    fs.coeffs_c[mb_idx, comp, k] = deq
                    fs.nzc_c[comp, cy, cx] = tc
                else:
                    fs.nzc_c[comp, cy, cx] = 0
    else:
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


def _decode_i_mb_cabac(dec: CabacSliceDecoder, mb_idx: int,
                       mb_type_raw: int) -> None:
    """Intra MB body after mb_type (raw 0=I4x4, 1..24=I16x16, 25=IPCM)."""
    ctx, fs, sh = dec.ctx, dec.fs, dec.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    fs.pred_mode[mb_idx, :] = -1

    if mb_type_raw == 25:  # IPCM: engine pauses; raw bytes; re-init
        fs.mb_type[mb_idx] = MB_IPCM
        eng = dec.eng
        # engine flush may end mid-byte; PCM data starts at the next byte
        # boundary (parity: RestoreCabacDecEngineToBS discards the
        # partial byte)
        bpos = (eng.pos + 7) >> 3
        raw = np.frombuffer(dec.rbsp[bpos:bpos + 384], np.uint8)
        y = raw[:256].reshape(16, 16).copy()
        u = raw[256:320].reshape(8, 8).copy()
        v = raw[320:384].reshape(8, 8).copy()
        fs.ipcm[mb_idx] = (y, u, v)
        fs.qp[mb_idx] = 0  # IPCM: QP 0 for deblocking (spec 8.7; ref pLumaQp=0)
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 16
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
        fs.i4_grid[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        fs.cbf_dc[mb_idx] = 7
        dec.last_dqp = 0
        # the next MB's bins come from a new engine after the samples;
        # residual_levels passes its pos to the C at every call
        dec.eng = CabacEngine(dec.rbsp, (bpos + 384) * 8)
        return

    if mb_type_raw == 0:  # I_NxN
        t8 = False
        if sh.pps.transform_8x8_mode:
            t8 = dec.transform8_flag(mb_idx)
        fs.mb_type[mb_idx] = MB_I8x8 if t8 else MB_I4x4
        fs.transform8[mb_idx] = t8
        n_units = 4 if t8 else 16
        modes = np.zeros(16, dtype=np.int32)
        for k in range(n_units):
            if t8:
                bx8, by8 = (k & 1) * 2, (k >> 1) * 2
                gx, gy = mbx * 4 + bx8, mby * 4 + by8
            else:
                bx, by = int(ZSCAN_TO_RASTER[k]) % 4, int(ZSCAN_TO_RASTER[k]) // 4
                gx, gy = mbx * 4 + bx, mby * 4 + by
            pred = ctx.pred_intra4x4_mode(gx, gy)
            rem = dec.intra4x4_pred_mode()
            mode = pred if rem < 0 else (rem if rem < pred else rem + 1)
            if t8:
                fs.i4_grid[gy:gy + 2, gx:gx + 2] = mode
                modes[[by8 * 4 + bx8, by8 * 4 + bx8 + 1,
                       (by8 + 1) * 4 + bx8, (by8 + 1) * 4 + bx8 + 1]] = mode
            else:
                fs.i4_grid[gy, gx] = mode
                modes[int(ZSCAN_TO_RASTER[k])] = mode
        fs.i4_modes[mb_idx] = modes
        fs.chroma_mode[mb_idx] = dec.intra_chroma_pred_mode(mb_idx)
        cbp = dec.cbp(mb_idx)
    else:  # I16x16
        fs.mb_type[mb_idx] = MB_I16x16
        mt = mb_type_raw - 1
        fs.i16_mode[mb_idx] = mt & 3
        cbp = int(CBP_I16x16[mt >> 2])
        fs.i4_grid[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        fs.chroma_mode[mb_idx] = dec.intra_chroma_pred_mode(mb_idx)
    fs.cbp[mb_idx] = cbp
    _store_mb_residual_cabac(dec, mb_idx, cbp,
                             is_i16=(fs.mb_type[mb_idx] == MB_I16x16))


def _set_part_with_mvd(dec, mb_idx, lx, px, py, pw, ph, ref):
    """Read a partition's list-lx mvd pair and set its MV from the MVP."""
    ctx, fs = dec.ctx, dec.fs
    mvd = np.array([dec.mvd(mb_idx, lx, 0, px, py),
                    dec.mvd(mb_idx, lx, 1, px, py)], np.int32)
    mv = ctx.mvctx.pred_mv(px, py, pw, ph, lx, ref, mb_idx) + mvd
    ctx.mvctx.set_partition(px, py, pw, ph, lx, ref, mv)
    fs.gmvd[lx, py:py + ph, px:px + pw] = mvd


def _decode_p_mb_cabac(dec: CabacSliceDecoder, mb_idx: int) -> None:
    ctx, fs, sh = dec.ctx, dec.fs, dec.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    fs.gmvd[:, gy:gy + 4, gx:gx + 4] = 0
    fs.gdirect[gy:gy + 4, gx:gx + 4] = 0
    raw = dec.mb_type_p_slice()
    if raw >= 5:
        _decode_i_mb_cabac(dec, mb_idx, raw - 5)
        _mark_intra_in_grids(ctx, mb_idx)
        return
    fs.pred_mode[mb_idx, :] = 0
    n_ref = sh.num_ref_idx_l0_active
    if raw == 0:
        fs.mb_type[mb_idx] = MB_P16x16
        ref = dec.ref_idx(mb_idx, 0, gx, gy, n_ref, False)
        _set_part_with_mvd(dec, mb_idx, 0, gx, gy, 4, 4, ref)
    elif raw in (1, 2):
        # 16x8 (partitions stacked) or 8x16 (side by side)
        fs.mb_type[mb_idx] = MB_P16x8 if raw == 1 else MB_P8x16
        pw, ph = (4, 2) if raw == 1 else (2, 4)
        pos = [(gx, gy + 2 * p) if raw == 1 else (gx + 2 * p, gy)
               for p in range(2)]
        refs = []
        for px, py in pos:
            r = dec.ref_idx(mb_idx, 0, px, py, n_ref, False)
            dec.note_ref(0, px, py, pw, ph, r)
            refs.append(r)
        for (px, py), r in zip(pos, refs):
            _set_part_with_mvd(dec, mb_idx, 0, px, py, pw, ph, r)
    else:  # P_8x8 (raw 3; raw 4 P8x8ref0 not generated by tree)
        fs.mb_type[mb_idx] = MB_P8x8
        subs = [dec.sub_mb_type_p() for _ in range(4)]
        refs = []
        for q in range(4):
            q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
            r = dec.ref_idx(mb_idx, 0, q_gx, q_gy, n_ref, False)
            dec.note_ref(0, q_gx, q_gy, 2, 2, r)
            refs.append(r)
        for q in range(4):
            q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
            n_parts, pw, ph = _P_SUB_SHAPES[subs[q]]
            for part in range(n_parts):
                if subs[q] == 1:
                    px, py = q_gx, q_gy + part
                elif subs[q] == 2:
                    px, py = q_gx + part, q_gy
                elif subs[q] == 3:
                    px, py = q_gx + (part % 2), q_gy + (part // 2)
                else:
                    px, py = q_gx, q_gy
                _set_part_with_mvd(dec, mb_idx, 0, px, py, pw, ph, refs[q])
    ctx.mvctx.set_partition(gx, gy, 4, 4, 1, -1, np.zeros(2, np.int32))
    _finish_inter_mb(ctx, mb_idx)
    # NoSubMbPartSizeLessThan8x8Flag (parse_mb_syn_cabac.cpp:642)
    t8_allowed = (raw < 3) or all(t == 0 for t in subs)
    cbp = dec.cbp(mb_idx)
    fs.cbp[mb_idx] = cbp
    # inter transform_size_8x8_flag (decode_slice.cpp:950-961)
    if (cbp & 15) and sh.pps.transform_8x8_mode and t8_allowed:
        fs.transform8[mb_idx] = dec.transform8_flag(mb_idx)
    if cbp:
        _store_mb_residual_cabac(dec, mb_idx, cbp, is_i16=False)
    else:
        dec.last_dqp = 0
        fs.qp[mb_idx] = ctx.qp
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


def _decode_skip_mb_cabac(dec: CabacSliceDecoder, mb_idx: int) -> None:
    ctx, fs = dec.ctx, dec.fs
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    fs.gmvd[:, gy:gy + 4, gx:gx + 4] = 0
    fs.gdirect[gy:gy + 4, gx:gx + 4] = 1
    fs.mb_type[mb_idx] = MB_PSKIP
    mv = ctx.mvctx.pred_skip_mv(gx, gy, mb_idx)
    ctx.mvctx.set_partition(gx, gy, 4, 4, 0, 0, mv)
    ctx.mvctx.set_partition(gx, gy, 4, 4, 1, -1, np.zeros(2, np.int32))
    fs.cbp[mb_idx] = 0
    fs.qp[mb_idx] = ctx.qp
    dec.last_dqp = 0
    _finish_inter_mb(ctx, mb_idx)


def decode_slice_data_cabac(rbsp: bytes, bitpos: int,
                            ctx: SliceDecodeContext) -> int:
    """Parse all MBs of a CABAC I or P slice from bit `bitpos` of its
    RBSP (the end of its header). Returns one past the last MB."""
    sh = ctx.sh
    fs = ctx.fs
    check_scope(sh)
    dec = CabacSliceDecoder(ctx, rbsp, bitpos)
    mb_idx = sh.first_mb_in_slice
    n_mb = ctx.mb_w * ctx.mb_h
    is_i = sh.slice_type == I_SLICE
    while mb_idx < n_mb:
        _mb_common_init(ctx, mb_idx)
        if is_i:
            _decode_i_mb_cabac(dec, mb_idx, dec.mb_type_i_slice(mb_idx))
        elif dec.skip_flag(mb_idx, False):
            _decode_skip_mb_cabac(dec, mb_idx)
        else:
            _decode_p_mb_cabac(dec, mb_idx)
        fs.mb_correct[mb_idx] = True
        mb_idx = (int(ctx.fmo_next[mb_idx]) if ctx.fmo_next is not None
                  else mb_idx + 1)
        if dec.eng.terminate():  # end_of_slice_flag
            break
    return mb_idx
