"""CABAC entropy encoding (H.264 §9.3.4).

Copied from openh264_tpu/encoder/cabac_enc.py (CabacEncoder,
CabacSliceWriter): host Python over numpy, run per bin, byte-identical
with it. Arithmetic encoder engine per spec flowcharts 9-7..9-12
(behavior parity: reference set_mb_syn_cabac.cpp
WelsCabacEncodeDecision/Bypass/Terminate/Flush,
svc_set_mb_syn_cabac.cpp syntax writers). Context layout and
neighbor-ctx computation mirror the JAX package's CABAC decoder
bin-for-bin, so its decoder reads these slices back exactly.
"""

from __future__ import annotations

import numpy as np

from ..decoder.cabac import (CabacContexts, RANGE_LPS, STATE_TRANS,
                             CTX_MB_TYPE_I, CTX_SKIP, CTX_MVD, CTX_DELTA_QP,
                             CTX_CIPR, CTX_CBP, CTX_CBF, CTX_MAP, CTX_LAST,
                             CTX_ONE, CTX_ABS, I16_DC, I16_AC, LUMA_4x4,
                             CHROMA_DC, CHROMA_AC, MAX_POS, MAX_C2, OFF_CBF,
                             OFF_MAP, OFF_ONE, MVD_BIN_CTX)


class CabacEncoder:
    """Spec arithmetic encoding engine (§9.3.4.2).

    Output bits are packed MSB-first into an int accumulator and
    flushed to whole bytes periodically (no per-bit Python lists —
    see ADVICE r1 on interpreter overhead in the hot entropy path).
    """

    __slots__ = ("low", "range", "outstanding", "first",
                 "_chunks", "_acc", "_nbits")

    def __init__(self):
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        self._chunks: list[bytes] = []
        self._acc = 0
        self._nbits = 0

    # --- low-level bit plumbing ----------------------------------------
    def _emit(self, n: int, v: int) -> None:
        self._acc = (self._acc << n) | v
        self._nbits += n
        if self._nbits >= 4096:
            nbytes = self._nbits // 8
            keep = self._nbits - nbytes * 8
            self._chunks.append((self._acc >> keep).to_bytes(nbytes, "big"))
            self._acc &= (1 << keep) - 1
            self._nbits = keep

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self._emit(1, b)
        if self.outstanding > 0:
            n = self.outstanding
            # run of n copies of the complement bit
            self._emit(n, ((1 << n) - 1) if b == 0 else 0)
            self.outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    # --- engine ---------------------------------------------------------
    def decision(self, ctx: CabacContexts, idx: int, bit: int) -> None:
        state = int(ctx.state[idx])
        lps = int(RANGE_LPS[state, (self.range >> 6) & 3])
        self.range -= lps
        if bit != ctx.mps[idx]:
            self.low += self.range
            self.range = lps
            if state == 0:
                ctx.mps[idx] ^= 1
            ctx.state[idx] = STATE_TRANS[state, 0]
        else:
            ctx.state[idx] = STATE_TRANS[state, 1]
        self._renorm()

    def bypass(self, bit: int) -> None:
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, bit: int) -> None:
        self.range -= 2
        if bit:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        # last two bits of low; the final 1 is the rbsp stop bit
        self._emit(2, (((self.low >> 8) & 1) << 1) | 1)

    def write_to(self, w) -> None:
        """Append the finished bin stream to a BitWriter (byte-aligns
        with cabac zero padding)."""
        npad = (8 - self._nbits % 8) % 8
        if npad:
            self._emit(npad, 0)
        if self._nbits:
            self._chunks.append(self._acc.to_bytes(self._nbits // 8, "big"))
            self._acc = 0
            self._nbits = 0
        w.put_bytes(b"".join(self._chunks))

    # --- composite binarizations -----------------------------------------
    def exp_bypass(self, k: int, v: int) -> None:
        """Exp-Golomb order-k suffix, bypass bins (mirror exp_bypass)."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        for i in range(k - 1, -1, -1):
            self.bypass((v >> i) & 1)

    def ueg_mv(self, ctx, base: int, v: int) -> None:
        """UEG3 for |mvd|-1 (mirror decoder ueg_mv)."""
        if v == 0:
            self.decision(ctx, base + MVD_BIN_CTX[0], 0)
            return
        self.decision(ctx, base + MVD_BIN_CTX[0], 1)
        if v < 8:
            # iterations 1..v, last bit 0
            for cnt in range(1, v):
                self.decision(ctx, base + MVD_BIN_CTX[min(cnt, 7)], 1)
            self.decision(ctx, base + MVD_BIN_CTX[min(v, 7)], 0)
        else:
            for cnt in range(1, 8):
                self.decision(ctx, base + MVD_BIN_CTX[min(cnt, 7)], 1)
            self.exp_bypass(3, v - 8)

    def ueg_level(self, ctx, idx: int, v: int) -> None:
        """UEG0 for coeff_abs_level - 2 (mirror decoder ueg_level)."""
        if v == 0:
            self.decision(ctx, idx, 0)
            return
        self.decision(ctx, idx, 1)
        if v < 13:
            for _ in range(v - 1):
                self.decision(ctx, idx, 1)
            self.decision(ctx, idx, 0)
        else:
            for _ in range(12):
                self.decision(ctx, idx, 1)
            self.exp_bypass(0, v - 13)


class CabacSliceWriter:
    """Per-slice CABAC MB syntax writer for the encoder's toolset
    (I16x16 intra, P16x16 / P_Skip inter; mirrors the decoder's
    slice_dec_cabac ctx computation with encoder-side state grids)."""

    def __init__(self, mb_w: int, mb_h: int, slice_qp: int, is_i: bool,
                 cabac_init_idc: int = 0):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.bctx = CabacContexts(is_i, cabac_init_idc,
                                  int(np.clip(slice_qp, 0, 51)))
        self.eng = CabacEncoder()
        self.last_dqp = 0
        n = mb_w * mb_h
        # encoder-side neighbor state (slice-local availability)
        self.mb_coded = np.zeros(n, bool)       # in this slice, already coded
        self.mb_skip = np.zeros(n, bool)
        self.mb_intra = np.zeros(n, bool)
        self._cbp_arr = np.zeros(n, np.int32)
        self.cbf_dc = np.zeros(n, np.int32)
        self.chroma_mode = np.zeros(n, np.int32)
        self.nzc_l = np.zeros((mb_h * 4, mb_w * 4), np.int32)
        self.nzc_c = np.zeros((2, mb_h * 2, mb_w * 2), np.int32)
        self.mvd = np.zeros((mb_h * 4, mb_w * 4, 2), np.int32)

    # --- neighbors -------------------------------------------------------
    def _lt(self, mb_idx):
        mbx, mby = mb_idx % self.mb_w, mb_idx // self.mb_w
        left = mb_idx - 1 if mbx > 0 and self.mb_coded[mb_idx - 1] else -1
        top = mb_idx - self.mb_w if mby > 0 and \
            self.mb_coded[mb_idx - self.mb_w] else -1
        return left, top

    # --- syntax elements ---------------------------------------------------
    def skip_flag(self, mb_idx: int, bit: int) -> None:
        left, top = self._lt(mb_idx)
        inc = 0
        if left >= 0 and not self.mb_skip[left]:
            inc += 1
        if top >= 0 and not self.mb_skip[top]:
            inc += 1
        self.eng.decision(self.bctx, CTX_SKIP + inc, bit)

    def mb_type_i16(self, mb_idx: int, i16_mode: int, cbp_luma15: bool,
                    cbp_chroma: int, p_slice: bool) -> None:
        """Encode mb_type for an I16x16 MB (raw 1..24)."""
        eng, bctx = self.eng, self.bctx
        if p_slice:
            # P-slice intra path (mirror mb_type_p_slice raw>=5)
            eng.decision(bctx, CTX_SKIP + 3, 1)
            eng.decision(bctx, CTX_SKIP + 6, 1)   # not I4x4
            eng.terminate(0)                       # not IPCM
            eng.decision(bctx, CTX_SKIP + 7, 1 if cbp_luma15 else 0)
            cc = cbp_chroma
            eng.decision(bctx, CTX_SKIP + 8, 1 if cc > 0 else 0)
            if cc > 0:
                eng.decision(bctx, CTX_SKIP + 8, 1 if cc > 1 else 0)
            eng.decision(bctx, CTX_SKIP + 9, (i16_mode >> 1) & 1)
            eng.decision(bctx, CTX_SKIP + 9, i16_mode & 1)
        else:
            left, top = self._lt(mb_idx)
            inc = 0
            if left >= 0:        # our encoder emits no I4x4/I8x8
                inc += 1
            if top >= 0:
                inc += 1
            eng.decision(bctx, CTX_MB_TYPE_I + inc, 1)
            eng.terminate(0)
            eng.decision(bctx, CTX_MB_TYPE_I + 3, 1 if cbp_luma15 else 0)
            cc = cbp_chroma
            eng.decision(bctx, CTX_MB_TYPE_I + 4, 1 if cc > 0 else 0)
            if cc > 0:
                eng.decision(bctx, CTX_MB_TYPE_I + 5, 1 if cc > 1 else 0)
            eng.decision(bctx, CTX_MB_TYPE_I + 6, (i16_mode >> 1) & 1)
            eng.decision(bctx, CTX_MB_TYPE_I + 7, i16_mode & 1)
        self.mb_intra[mb_idx] = True

    def mb_type_p16x16(self) -> None:
        eng, bctx = self.eng, self.bctx
        eng.decision(bctx, CTX_SKIP + 3, 0)
        eng.decision(bctx, CTX_SKIP + 4, 0)
        eng.decision(bctx, CTX_SKIP + 5, 0)

    def intra_chroma_pred_mode(self, mb_idx: int, mode: int) -> None:
        left, top = self._lt(mb_idx)
        inc = 0
        if left >= 0 and self.mb_intra[left] and \
           0 < self.chroma_mode[left] <= 3:
            inc += 1
        if top >= 0 and self.mb_intra[top] and \
           0 < self.chroma_mode[top] <= 3:
            inc += 1
        eng, bctx = self.eng, self.bctx
        if mode == 0:
            eng.decision(bctx, CTX_CIPR + inc, 0)
        else:
            eng.decision(bctx, CTX_CIPR + inc, 1)
            eng.decision(bctx, CTX_CIPR + 3, 0 if mode == 1 else 1)
            if mode > 1:
                eng.decision(bctx, CTX_CIPR + 3, mode - 2)
        self.chroma_mode[mb_idx] = mode

    def mvd_comp(self, mb_idx: int, comp: int, gx: int, gy: int,
                 val: int) -> None:
        """Encode one mvd component for a full-MB partition at (gx,gy)."""
        eng, bctx = self.eng, self.bctx
        base = CTX_MVD + comp * 7

        def amvd(nx, ny):
            if nx < 0 or ny < 0:
                return 0
            nmb = (ny // 4) * self.mb_w + (nx // 4)
            if nmb != mb_idx and not self.mb_coded[nmb]:
                return 0
            if nmb != mb_idx and self.mb_intra[nmb]:
                return 0     # intra neighbors have no L0 ref (gref<0)
            return abs(int(self.mvd[ny, nx, comp]))

        s = amvd(gx - 1, gy) + amvd(gx, gy - 1)
        inc = 0 if s < 3 else (2 if s > 32 else 1)
        if val == 0:
            eng.decision(bctx, base + inc, 0)
            return
        eng.decision(bctx, base + inc, 1)
        eng.ueg_mv(bctx, base + 3, abs(val) - 1)
        eng.bypass(1 if val < 0 else 0)

    def record_cbp(self, mb_idx: int, cbp: int) -> None:
        """Record an MB's cbp for later neighbor-context lookups (used
        directly for MB types whose cbp is implied, e.g. I16x16/skip)."""
        self._cbp_arr[mb_idx] = cbp

    def write_cbp(self, mb_idx: int, cbp: int) -> None:
        eng, bctx = self.eng, self.bctx
        left, top = self._lt(mb_idx)
        lcbp = int(self._cbp_arr[left]) if left >= 0 else 0
        tcbp = int(self._cbp_arr[top]) if top >= 0 else 0
        lok, tok = left >= 0, top >= 0
        btop = [tok and ((tcbp & (1 << 2)) == 0), tok and ((tcbp & (1 << 3)) == 0)]
        aleft = [lok and ((lcbp & (1 << 1)) == 0), lok and ((lcbp & (1 << 3)) == 0)]
        bits = [(cbp >> i) & 1 for i in range(4)]
        eng.decision(bctx, CTX_CBP + aleft[0] + (btop[0] << 1), bits[0])
        eng.decision(bctx, CTX_CBP + (not bits[0]) + (btop[1] << 1), bits[1])
        eng.decision(bctx, CTX_CBP + aleft[1] + ((not bits[0]) << 1), bits[2])
        eng.decision(bctx, CTX_CBP + (not bits[2]) + ((not bits[1]) << 1), bits[3])
        cc = cbp >> 4
        ib = top >= 0 and (tcbp >> 4)
        ia = left >= 0 and (lcbp >> 4)
        eng.decision(bctx, CTX_CBP + 4 + bool(ia) + (bool(ib) << 1),
                     1 if cc else 0)
        if cc:
            ib = top >= 0 and (tcbp >> 4) == 2
            ia = left >= 0 and (lcbp >> 4) == 2
            eng.decision(bctx, CTX_CBP + 8 + bool(ia) + (bool(ib) << 1),
                         cc - 1)
        self.record_cbp(mb_idx, cbp)

    def delta_qp(self, dqp: int) -> None:
        eng, bctx = self.eng, self.bctx
        inc = 1 if self.last_dqp != 0 else 0
        if dqp == 0:
            eng.decision(bctx, CTX_DELTA_QP + inc, 0)
        else:
            eng.decision(bctx, CTX_DELTA_QP + inc, 1)
            v = 2 * dqp - 1 if dqp > 0 else -2 * dqp
            u = v - 1
            if u == 0:
                eng.decision(bctx, CTX_DELTA_QP + 2, 0)
            else:
                eng.decision(bctx, CTX_DELTA_QP + 2, 1)
                for _ in range(u - 1):
                    eng.decision(bctx, CTX_DELTA_QP + 3, 1)
                eng.decision(bctx, CTX_DELTA_QP + 3, 0)
        self.last_dqp = dqp

    # --- residuals ---------------------------------------------------------
    def cbf(self, mb_idx: int, prop: int, bit: int, gx=0, gy=0, comp=0,
            dc_bit=0) -> None:
        cur_intra = bool(self.mb_intra[mb_idx])
        left, top = self._lt(mb_idx)
        na = nb = 1 if cur_intra else 0
        if prop in (I16_DC, CHROMA_DC):
            if top >= 0:
                nb = (int(self.cbf_dc[top]) >> dc_bit) & 1
            if left >= 0:
                na = (int(self.cbf_dc[left]) >> dc_bit) & 1
        else:
            grid = self.nzc_l if prop in (I16_AC, LUMA_4x4) else self.nzc_c[comp]
            scale = 4 if prop in (I16_AC, LUMA_4x4) else 2

            def blk_nz(nx, ny):
                if nx < 0 or ny < 0:
                    return None
                nmb = (ny // scale) * self.mb_w + (nx // scale)
                if nmb != mb_idx and not self.mb_coded[nmb]:
                    return None
                return 1 if grid[ny, nx] else 0
            va = blk_nz(gx - 1, gy)
            vb = blk_nz(gx, gy - 1)
            if va is not None:
                na = va
            if vb is not None:
                nb = vb
        inc = na + (nb << 1)
        off = OFF_CBF[CHROMA_DC if prop == CHROMA_DC else
                      (CHROMA_AC if prop == CHROMA_AC else prop)]
        self.eng.decision(self.bctx, CTX_CBF + off + inc, bit)
        if bit and prop in (I16_DC, CHROMA_DC):
            self.cbf_dc[mb_idx] |= 1 << dc_bit

    def residual_levels(self, prop: int, coeffs: np.ndarray) -> None:
        """Encode sig map + levels of nonzero scan-order coeffs[n]."""
        eng, bctx = self.eng, self.bctx
        n = MAX_POS[prop] + 1
        sig = coeffs != 0
        last_nz = int(np.max(np.nonzero(sig)[0]))
        map_base = CTX_MAP + OFF_MAP[prop]
        last_base = CTX_LAST + OFF_MAP[prop]
        for i in range(min(last_nz + 1, n - 1)):
            s = 1 if sig[i] else 0
            eng.decision(bctx, map_base + i, s)
            if s:
                eng.decision(bctx, last_base + i, 1 if i == last_nz else 0)
        one_base = CTX_ONE + OFF_ONE[prop]
        abs_base = CTX_ABS + OFF_ONE[prop]
        maxc2 = MAX_C2[prop]
        c1, c2 = 1, 0
        for i in range(last_nz, -1, -1):
            v = int(coeffs[i])
            if v == 0:
                continue
            a = abs(v)
            eng.decision(bctx, one_base + c1, 0 if a == 1 else 1)
            if a >= 2:
                eng.ueg_level(bctx, abs_base + c2, a - 2)
                c2 = min(c2 + 1, maxc2)
                c1 = 0
            elif c1:
                c1 = min(c1 + 1, 4)
            eng.bypass(1 if v < 0 else 0)

    def end_of_slice(self, last: bool) -> None:
        self.eng.terminate(1 if last else 0)
