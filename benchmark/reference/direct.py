"""Direct prediction of B macroblocks and sub-macroblocks (clause
8.4.1.2), written for the benchmark's reference from the clause itself:
the colocated block (8.4.1.2.1), spatial direct (8.4.1.2.2) and temporal
direct (8.4.1.2.3), for frames (no fields, no MBAFF).

It writes the derived reference indices and vectors into the slice's
motion grids through the frozen MV-prediction context (mvpred.py), as a
parsed partition does, so that later neighbours predict from them.
"""

from __future__ import annotations

import numpy as np

_ZERO = np.zeros(2, np.int32)


def colocated(col, bx: int, by: int, inference: bool):
    """(mvCol, refIdxCol, pic_id of the picture refIdxCol names) of the
    colocated 4x4 block of luma block (bx, by) in `col` (RefPicList1[0]):
    with direct_8x8_inference the corner block of its 8x8; an intra
    block gives (0, -1, -1); a block without list-0 prediction gives
    its list-1 motion."""
    if inference:
        bx = (bx & ~3) | (3 if bx & 2 else 0)
        by = (by & ~3) | (3 if by & 2 else 0)
    if col.intra[by, bx]:
        return _ZERO, -1, -1
    lx = 0 if col.ref_idx[0, by, bx] >= 0 else 1
    return (col.mv[lx, by, bx], int(col.ref_idx[lx, by, bx]),
            int(col.ref_id[lx, by, bx]))


def spatial_refs(mvctx, mb_idx: int, gx: int, gy: int):
    """The MB's (refIdxL0, refIdxL1, mvpL0, mvpL1, directZeroPrediction)
    of 8.4.1.2.2: each refIdx the MinPositive of the neighbours A, B and
    C (D where C is not available) of the MB as one 16x16 partition,
    each mvp the 16x16 median prediction with that refIdx."""
    refs, mvps = [], []
    for lx in (0, 1):
        cands = [r for avail, r, _ in mvctx.neighbors(gx, gy, 4, lx, mb_idx)
                 if avail and r >= 0]
        refs.append(min(cands) if cands else -1)
    if refs[0] < 0 and refs[1] < 0:
        return 0, 0, _ZERO, _ZERO, True
    for lx in (0, 1):
        mvps.append(mvctx.pred_mv(gx, gy, 4, 4, lx, refs[lx], mb_idx)
                    if refs[lx] >= 0 else _ZERO)
    return refs[0], refs[1], mvps[0], mvps[1], False


def dist_scale_factor(cur_poc: int, poc0: int, poc1: int) -> int:
    """DistScaleFactor of 8.4.1.2.3 (tb, td clipped to [-128, 127];
    divisions truncate toward zero)."""
    tb = int(np.clip(cur_poc - poc0, -128, 127))
    td = int(np.clip(poc1 - poc0, -128, 127))
    tx = int((16384 + abs(td) // 2) / td)
    return int(np.clip((tb * tx + 32) >> 6, -1024, 1023))


class DirectContext:
    """One B slice's direct prediction: its lists, the current POC and
    the colocated picture RefPicList1[0]."""

    def __init__(self, sh, l0, l1, cur_poc: int):
        self.spatial = sh.direct_spatial_mv_pred
        self.inference = sh.sps.direct_8x8_inference
        self.l0, self.l1 = l0, l1
        self.cur_poc = cur_poc
        self.col = l1[0]
        self._mb = -1

    def fill(self, mvctx, mb_idx: int, mb_w: int, gx0: int, gy0: int,
             n: int) -> None:
        """Derives the motion of the direct region of n x n 4x4 blocks
        at (gx0, gy0) of MB mb_idx (the MB, n=4, or one 8x8 of it, n=2)
        and writes it into the motion grids."""
        gx, gy = (mb_idx % mb_w) * 4, (mb_idx // mb_w) * 4
        if self.spatial and self._mb != mb_idx:
            # from the neighbours outside the MB: before any of its own
            # partitions is written
            self._refs = spatial_refs(mvctx, mb_idx, gx, gy)
            self._mb = mb_idx
        step = 2 if self.inference else 1
        for by in range(gy0, gy0 + n, step):
            for bx in range(gx0, gx0 + n, step):
                if self.spatial:
                    out = self._spatial_block(bx, by)
                else:
                    out = self._temporal_block(bx, by)
                for lx, (ref, mv) in enumerate(out):
                    mvctx.set_partition(bx, by, step, step, lx, ref, mv)

    def _spatial_block(self, bx, by):
        ref0, ref1, mvp0, mvp1, zero = self._refs
        mv_col, ref_col, _ = colocated(self.col, bx, by, self.inference)
        col_zero = (not self.col.is_long_term and ref_col == 0
                    and abs(int(mv_col[0])) <= 1 and abs(int(mv_col[1])) <= 1)
        out = []
        for ref, mvp in ((ref0, mvp0), (ref1, mvp1)):
            if ref < 0:
                out.append((-1, _ZERO))
            elif zero or (ref == 0 and col_zero):
                out.append((ref, _ZERO))
            else:
                out.append((ref, mvp))
        return out

    def _temporal_block(self, bx, by):
        mv_col, ref_col, ref_id = colocated(self.col, bx, by, self.inference)
        if ref_col < 0:
            ref0 = 0
        else:
            ref0 = next((i for i, p in enumerate(self.l0)
                         if p is not None and p.pic_id == ref_id), None)
            if ref0 is None:
                raise ValueError("temporal direct: the colocated block's "
                                 "reference is not in RefPicList0")
        pic0, pic1 = self.l0[ref0], self.col
        if pic0.is_long_term or pic1.poc == pic0.poc:
            mv0, mv1 = np.array(mv_col, np.int32), _ZERO
        else:
            dsf = dist_scale_factor(self.cur_poc, pic0.poc, pic1.poc)
            mv0 = (dsf * mv_col.astype(np.int64) + 128) >> 8
            mv1 = mv0 - mv_col
        return [(ref0, np.asarray(mv0, np.int32)),
                (0, np.asarray(mv1, np.int32))]
