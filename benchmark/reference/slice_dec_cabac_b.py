"""CABAC slice data of I, P and B slices -> FrameSymbols arrays.

The B-slice syntax (mb_type and sub_mb_type of B slices, B_Skip, and the
ref_idx / mvd order of clause 7.3.5.1-2) is a frozen copy of the port's
per-MB Python CABAC parser (openh264_tpu_torch/decoder/slice_dec_cabac.py),
on the frozen I/P parser of slice_dec_cabac.py, whose engine, contexts
and residual bins it shares. The motion of direct MBs and sub-MBs comes
from direct.py, written from clause 8.4.1.2. Departures from the port,
both to follow clause 8: no deblocking shortcut is recorded for skipped
or direct MBs (fs.ibs_mode stays 0, so every edge takes the bS rules of
clause 8.7.2.1), and the transform_size_8x8_flag of a B_Direct_16x16 MB
is read only under direct_8x8_inference_flag (7.3.5).
"""

from __future__ import annotations

import numpy as np

from .cabac import CTX_B_SKIP, CTX_B_SUBMB_TYPE, CTX_MB_TYPE_B, \
    CTX_MB_TYPE_B_INTRA, CTX_SKIP
from .framedata import (MB_B16x16, MB_B16x8, MB_B8x16, MB_B8x8, MB_BDIRECT,
                        MB_BSKIP, MB_PSKIP)
from .slice_dec import (SliceDecodeContext, _finish_inter_mb,
                        _mark_intra_in_grids, _mb_common_init)
from .slice_dec_cabac import (CabacSliceDecoder, _decode_i_mb_cabac,
                              _decode_p_mb_cabac, _decode_skip_mb_cabac,
                              _set_part_with_mvd, _store_mb_residual_cabac)
from .slicehdr import B_SLICE, I_SLICE, P_SLICE

_ZERO = np.zeros(2, np.int32)
# B mb_type 4..21, in pairs (16x8, 8x16): the two partitions' modes,
# 0 = L0, 1 = L1, 2 = BI (Table 7-14)
_B_TWOPART_MODES = [(0, 0), (1, 1), (0, 1), (1, 0), (0, 2), (1, 2),
                    (2, 0), (2, 1), (2, 2)]
# B sub_mb_type (Table 7-18): (mode, parts, width, height in 4x4
# blocks); mode -1 is direct
_B_SUB = {0: (-1, 4, 1, 1), 1: (0, 1, 2, 2), 2: (1, 1, 2, 2), 3: (2, 1, 2, 2),
          4: (0, 2, 2, 1), 5: (0, 2, 1, 2), 6: (1, 2, 2, 1), 7: (1, 2, 1, 2),
          8: (2, 2, 2, 1), 9: (2, 2, 1, 2), 10: (0, 4, 1, 1),
          11: (1, 4, 1, 1), 12: (2, 4, 1, 1)}


class CabacSliceDecoderB(CabacSliceDecoder):
    """The frozen CABAC decoder with the B-slice syntax elements."""

    def skip_flag(self, mb_idx, is_b: bool) -> bool:
        fs = self.fs
        left, top = self.left_top_mb(mb_idx)
        inc = sum(n >= 0 and fs.mb_type[n] not in (MB_PSKIP, MB_BSKIP)
                  for n in (left, top))
        base = CTX_B_SKIP if is_b else CTX_SKIP
        return bool(self.eng.decision(self.bctx, base + inc))

    def mb_type_b_slice(self, mb_idx) -> int:
        fs = self.fs
        eng, bctx = self.eng, self.bctx
        left, top = self.left_top_mb(mb_idx)
        inc = sum(n >= 0 and fs.mb_type[n] not in (MB_BSKIP, MB_BDIRECT)
                  for n in (left, top))
        if not eng.decision(bctx, CTX_MB_TYPE_B + inc):
            return 0  # B_Direct_16x16
        if not eng.decision(bctx, CTX_MB_TYPE_B + 3):
            return 1 + eng.decision(bctx, CTX_MB_TYPE_B + 5)
        v = eng.decision(bctx, CTX_MB_TYPE_B + 4) << 3
        v |= eng.decision(bctx, CTX_MB_TYPE_B + 5) << 2
        v |= eng.decision(bctx, CTX_MB_TYPE_B + 5) << 1
        v |= eng.decision(bctx, CTX_MB_TYPE_B + 5)
        if v < 8:
            return v + 3
        if v == 13:
            return 23 + self._intra_mb_type_suffix(CTX_MB_TYPE_B_INTRA)
        if v == 14:
            return 11
        if v == 15:
            return 22
        v = (v << 1) | eng.decision(bctx, CTX_MB_TYPE_B + 5)
        return v - 4

    def sub_mb_type_b(self) -> int:
        eng, bctx = self.eng, self.bctx
        if not eng.decision(bctx, CTX_B_SUBMB_TYPE):
            return 0
        if not eng.decision(bctx, CTX_B_SUBMB_TYPE + 1):
            return 1 + eng.decision(bctx, CTX_B_SUBMB_TYPE + 3)
        v = 3
        if eng.decision(bctx, CTX_B_SUBMB_TYPE + 2):
            if eng.decision(bctx, CTX_B_SUBMB_TYPE + 3):
                return 11 + eng.decision(bctx, CTX_B_SUBMB_TYPE + 3)
            v += 4
        v += 2 * eng.decision(bctx, CTX_B_SUBMB_TYPE + 3)
        v += eng.decision(bctx, CTX_B_SUBMB_TYPE + 3)
        return v


def _direct(ctx: SliceDecodeContext, mb_idx: int, gx: int, gy: int,
            n: int) -> None:
    ctx.direct.fill(ctx.mvctx, mb_idx, ctx.mb_w, gx, gy, n)
    ctx.fs.gdirect[gy:gy + n, gx:gx + n] = 1


def _decode_b_mb(dec: CabacSliceDecoderB, mb_idx: int) -> None:
    ctx, fs, sh = dec.ctx, dec.fs, dec.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    fs.gmvd[:, gy:gy + 4, gx:gx + 4] = 0
    fs.gdirect[gy:gy + 4, gx:gx + 4] = 0
    raw = dec.mb_type_b_slice(mb_idx)
    if raw >= 23:
        _decode_i_mb_cabac(dec, mb_idx, raw - 23)
        _mark_intra_in_grids(ctx, mb_idx)
        return
    mvc = ctx.mvctx
    n_act = (sh.num_ref_idx_l0_active, sh.num_ref_idx_l1_active)
    subs_raw = []
    if raw == 0:
        fs.mb_type[mb_idx] = MB_BDIRECT
        _direct(ctx, mb_idx, gx, gy, 4)
    elif raw <= 3:
        fs.mb_type[mb_idx] = MB_B16x16
        mode = raw - 1
        lists = (0,) if mode == 0 else (1,) if mode == 1 else (0, 1)
        refs = {lx: dec.ref_idx(mb_idx, lx, gx, gy, n_act[lx], True)
                for lx in lists}
        for lx in (0, 1):
            if lx not in lists:
                mvc.set_partition(gx, gy, 4, 4, lx, -1, _ZERO)
        for lx in lists:
            _set_part_with_mvd(dec, mb_idx, lx, gx, gy, 4, 4, refs[lx])
    elif raw <= 21:
        t = raw - 4
        is16x8 = (t % 2) == 0
        modes = _B_TWOPART_MODES[t // 2]
        fs.mb_type[mb_idx] = MB_B16x8 if is16x8 else MB_B8x16
        pw, ph = (4, 2) if is16x8 else (2, 4)
        pos = [(gx, gy), (gx, gy + 2) if is16x8 else (gx + 2, gy)]
        refs = [[-1, -1], [-1, -1]]
        for lx in (0, 1):
            for part, (px, py) in enumerate(pos):
                if modes[part] in (lx, 2):
                    refs[part][lx] = dec.ref_idx(mb_idx, lx, px, py,
                                                 n_act[lx], True)
                dec.note_ref(lx, px, py, pw, ph, refs[part][lx])
        for part, (px, py) in enumerate(pos):
            for lx in (0, 1):
                if refs[part][lx] < 0:
                    mvc.set_partition(px, py, pw, ph, lx, -1, _ZERO)
        for lx in (0, 1):
            for part, (px, py) in enumerate(pos):
                if refs[part][lx] >= 0:
                    _set_part_with_mvd(dec, mb_idx, lx, px, py, pw, ph,
                                       refs[part][lx])
    else:  # 22: B_8x8
        fs.mb_type[mb_idx] = MB_B8x8
        subs_raw = [dec.sub_mb_type_b() for _ in range(4)]
        subs = [_B_SUB[t] for t in subs_raw]
        quads = [(gx + (q % 2) * 2, gy + (q // 2) * 2) for q in range(4)]
        # direct sub-MBs first: their refs feed the ref_idx contexts of
        # the partitions parsed after them
        for q, (qx, qy) in enumerate(quads):
            if subs[q][0] == -1:
                _direct(ctx, mb_idx, qx, qy, 2)
        refs = [[-1, -1] for _ in range(4)]
        for lx in (0, 1):
            for q, (qx, qy) in enumerate(quads):
                if subs[q][0] == -1:
                    continue
                if subs[q][0] in (lx, 2):
                    refs[q][lx] = dec.ref_idx(mb_idx, lx, qx, qy,
                                              n_act[lx], True)
                dec.note_ref(lx, qx, qy, 2, 2, refs[q][lx])
        for q, (qx, qy) in enumerate(quads):
            if subs[q][0] == -1:
                continue
            for lx in (0, 1):
                if refs[q][lx] < 0:
                    mvc.set_partition(qx, qy, 2, 2, lx, -1, _ZERO)
        for lx in (0, 1):
            for q, (qx, qy) in enumerate(quads):
                mode, n_parts, pw, ph = subs[q]
                if mode not in (lx, 2):
                    continue
                for part in range(n_parts):
                    if (pw, ph) == (2, 1):
                        px, py = qx, qy + part
                    elif (pw, ph) == (1, 2):
                        px, py = qx + part, qy
                    elif (pw, ph) == (1, 1):
                        px, py = qx + (part % 2), qy + (part // 2)
                    else:
                        px, py = qx, qy
                    _set_part_with_mvd(dec, mb_idx, lx, px, py, pw, ph,
                                       refs[q][lx])
    _finish_inter_mb(ctx, mb_idx)
    inference = sh.sps.direct_8x8_inference
    if raw == 0:
        t8_allowed = inference
    elif raw <= 21:
        t8_allowed = True
    else:           # no sub-MB partition below 8x8 (7.3.5)
        t8_allowed = all(t in (1, 2, 3) or (t == 0 and inference)
                         for t in subs_raw)
    cbp = dec.cbp(mb_idx)
    fs.cbp[mb_idx] = cbp
    if (cbp & 15) and sh.pps.transform_8x8_mode and t8_allowed:
        fs.transform8[mb_idx] = dec.transform8_flag(mb_idx)
    if cbp:
        _store_mb_residual_cabac(dec, mb_idx, cbp, is_i16=False)
    else:
        dec.last_dqp = 0
        fs.qp[mb_idx] = ctx.qp
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


def _decode_b_skip(dec: CabacSliceDecoderB, mb_idx: int) -> None:
    ctx, fs = dec.ctx, dec.fs
    gx, gy = (mb_idx % ctx.mb_w) * 4, (mb_idx // ctx.mb_w) * 4
    fs.gmvd[:, gy:gy + 4, gx:gx + 4] = 0
    fs.mb_type[mb_idx] = MB_BSKIP
    _direct(ctx, mb_idx, gx, gy, 4)
    fs.cbp[mb_idx] = 0
    fs.qp[mb_idx] = ctx.qp
    dec.last_dqp = 0
    _finish_inter_mb(ctx, mb_idx)


def decode_slice_data_cabac_b(rbsp: bytes, bitpos: int,
                              ctx: SliceDecodeContext) -> int:
    """All MBs of a CABAC I, P or B slice from bit `bitpos` of its RBSP
    (the end of its header), in raster order; a B slice needs
    ctx.direct (direct.DirectContext). Returns one past the last MB."""
    sh, fs = ctx.sh, ctx.fs
    if sh.slice_type not in (I_SLICE, P_SLICE, B_SLICE):
        raise NotImplementedError(f"slice type {sh.slice_type}")
    dec = CabacSliceDecoderB(ctx, rbsp, bitpos)
    mb_idx = sh.first_mb_in_slice
    n_mb = ctx.mb_w * ctx.mb_h
    is_b = sh.slice_type == B_SLICE
    while mb_idx < n_mb:
        _mb_common_init(ctx, mb_idx)
        if sh.slice_type == I_SLICE:
            _decode_i_mb_cabac(dec, mb_idx, dec.mb_type_i_slice(mb_idx))
        elif dec.skip_flag(mb_idx, is_b):
            if is_b:
                _decode_b_skip(dec, mb_idx)
            else:
                _decode_skip_mb_cabac(dec, mb_idx)
        elif is_b:
            _decode_b_mb(dec, mb_idx)
        else:
            _decode_p_mb_cabac(dec, mb_idx)
        fs.mb_correct[mb_idx] = True
        mb_idx += 1
        if dec.eng.terminate():  # end_of_slice_flag
            break
    return mb_idx
