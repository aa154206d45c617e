"""B-slice direct-mode motion derivation (H.264 §8.4.1.2.2/8.4.1.2.3).

Parity anchors: codec/decoder/core/src/mv_pred.cpp PredMvBDirectSpatial
/ ComputeColocated* and decode_slice.cpp:3041 temporal scaling.

Copied from openh264_tpu/decoder/direct.py. The colocated grids come
from the port's dpb.Picture, which H264Decoder._attach_col_motion fills
for every decoded picture.
"""

from __future__ import annotations

import numpy as np

# direct_8x8_inference corner block index within an 8x8 (in 4x4 units)


def distance_scale_factor(poc_cur: int, poc0: int, poc1: int) -> int:
    """DistScaleFactor for temporal direct: col ref poc0 (L0 target),
    col pic poc1 (L1[0]).  Matches decode_slice.cpp
    ComputeColocatedTemporalScaling: it reads
    pSliceHeader->iPicOrderCntLsb, but the slice-header parse has
    already OVERWRITTEN that field with the full unwrapped POC
    (pocMsb + pocLsb, decoder_core.cpp:1092) — so tb uses the current
    picture's computed POC, like poc0/poc1 use the refs' iFramePoc.
    tx uses C (truncating) division."""
    tb = int(np.clip(poc_cur - poc0, -128, 127))
    td = int(np.clip(poc1 - poc0, -128, 127))
    if td == 0:
        return 256
    q = 16384 + (abs(td) >> 1)
    tx = q // td if td > 0 else -(q // -td)
    return int(np.clip((tb * tx + 32) >> 6, -1024, 1023))


class DirectContext:
    """Per-slice state for resolving B_Direct/B_Skip motion."""

    def __init__(self, sh, ref_list0, ref_list1, poc_cur: int):
        self.sh = sh
        self.spatial = sh.direct_spatial_mv_pred
        self.l0 = ref_list0
        self.l1 = ref_list1
        self.poc_cur = poc_cur
        self.col = ref_list1[0] if ref_list1 else None
        self.direct_8x8 = sh.sps.direct_8x8_inference
        # map colocated ref pic_id -> lowest refIdxL0 of current slice
        self.colref_to_l0 = {}
        for i, p in enumerate(ref_list0):
            self.colref_to_l0.setdefault(p.pic_id, i)
        # precompute DistScaleFactor per l0 index (post-reorder list,
        # as ComputeColocatedTemporalScaling runs after InitRefPicList)
        if self.col is not None:
            self.dsf = [distance_scale_factor(poc_cur, p.poc, self.col.poc)
                        for p in ref_list0]

    def col_motion(self, bx: int, by: int):
        """Colocated 4x4 block motion: (mv[2], ref_pic_id, is_intra,
        from_l1).  Applies direct_8x8_inference corner sampling."""
        col = self.col
        if self.direct_8x8:
            # corner sampling: each 8x8 uses its outermost-corner 4x4 block
            mb_bx, mb_by = (bx // 4) * 4, (by // 4) * 4
            ox = 0 if (bx - mb_bx) < 2 else 3
            oy = 0 if (by - mb_by) < 2 else 3
            bx, by = mb_bx + ox, mb_by + oy
        if col.col_intra[by, bx]:
            return np.zeros(2, np.int32), -1, True, False
        if col.col_ref0[by, bx] >= 0:
            return col.col_mv0[by, bx], int(col.col_refpic0[by, bx]), \
                False, False
        # col block is L1-only (col is a B-ref): use its LIST_1 motion
        # (parse_mb_syn_cavlc.cpp "mvColoc = iColocMv[LIST_1]")
        return col.col_mv1[by, bx], int(col.col_refpic1[by, bx]), False, True

    # ---- temporal direct ----
    def temporal_direct(self, bx: int, by: int):
        """Returns (ref0, ref1, mv0[2], mv1[2]).  Reference semantics
        (mv_pred.cpp PredBDirectTemporal / FillTemporalDirect8x8Mv):
        refIdxL0 stays 0 when the col block is intra OR L1-only (the
        reference maps only colocRefIndexL0 >= 0 through
        MapColToList0); no long-term special case."""
        mv_col, col_ref_id, is_intra, from_l1 = self.col_motion(bx, by)
        if is_intra:
            mv_col = np.zeros(2, np.int32)
        ref0 = 0
        if not is_intra and not from_l1:
            ref0 = self.colref_to_l0.get(col_ref_id, 0)
        dsf = self.dsf[ref0] if ref0 < len(self.dsf) else 256
        mv0 = np.array([(dsf * int(mv_col[0]) + 128) >> 8,
                        (dsf * int(mv_col[1]) + 128) >> 8], np.int32)
        mv1 = mv0 - mv_col
        return ref0, 0, mv0, mv1

    # ---- spatial direct ----
    def spatial_refs(self, mvctx, gx_mb: int, gy_mb: int, cur_mb: int):
        """MinPositive ref over neighbors A/B/C per list + the MVP mv
        (§8.4.1.2.2). Returns (ref0, ref1, mv0, mv1, use0, use1)."""
        refs = []
        mvs = []
        for lx in (0, 1):
            (aa, ra, mva), (ab, rb, mvb), (ac, rc, mvc) = \
                mvctx.neighbors(gx_mb, gy_mb, 4, lx, cur_mb)
            cands = [r for r in (ra if aa else -1, rb if ab else -1,
                                 rc if ac else -1) if r >= 0]
            ref = min(cands) if cands else -1
            refs.append(ref)
            if ref < 0:
                mvs.append(np.zeros(2, np.int32))
            else:
                mvs.append(mvctx.pred_mv(gx_mb, gy_mb, 4, 4, lx, ref, cur_mb))
        ref0, ref1 = refs
        if ref0 < 0 and ref1 < 0:
            return 0, 0, np.zeros(2, np.int32), np.zeros(2, np.int32), True, True
        return (ref0, ref1, mvs[0], mvs[1], ref0 >= 0, ref1 >= 0)

    def col_zero(self, bx: int, by: int) -> bool:
        """colZeroFlag (§8.4.1.2.2): colocated in L1[0] is short-term,
        references refIdx 0, and has tiny motion."""
        col = self.col
        if col is None or col.is_long_term:
            return False
        if col.col_intra[by, bx]:
            return False
        if self.direct_8x8:
            mb_bx, mb_by = (bx // 4) * 4, (by // 4) * 4
            ox = 0 if (bx - mb_bx) < 2 else 3
            oy = 0 if (by - mb_by) < 2 else 3
            bx, by = mb_bx + ox, mb_by + oy
        if col.col_ref0[by, bx] >= 0:
            mv = col.col_mv0[by, bx]
            ref_is0 = col.col_ref0[by, bx] == 0
        else:
            mv = col.col_mv1[by, bx]
            ref_is0 = col.col_ref1[by, bx] == 0
        return bool(ref_is0 and abs(int(mv[0])) <= 1 and abs(int(mv[1])) <= 1)
