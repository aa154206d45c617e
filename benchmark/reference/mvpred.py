"""Motion vector prediction (H.264 §8.4.1.3) over global 4x4-block grids.

Parity anchor: codec/decoder/core/src/mv_pred.cpp (PredMv / PredSkipMv /
PredInter8x16Mv / PredInter16x8Mv). Operates on FrameSymbols' global
motion grids which are filled progressively in decode order, so
within-MB causality is expressed by a written mask.

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/decoder/mvpred.py; only its imports changed.
"""

from __future__ import annotations

import numpy as np


def ensure_motion_grids(fs):
    if not hasattr(fs, "gmv"):
        h4, w4 = fs.mb_h * 4, fs.mb_w * 4
        fs.gmv = np.zeros((2, h4, w4, 2), dtype=np.int32)
        fs.gref = np.full((2, h4, w4), -1, dtype=np.int32)
        fs.gwritten = np.zeros((h4, w4), dtype=bool)
        # per-list "ref_idx known" mask: the CABAC ref_idx context reads
        # neighbor refs that were parsed but whose MVs aren't in yet
        # (reference updates its ref cache per partition inside the ref
        # loop, parse_mb_syn_cabac.cpp:660 UpdateP8x8RefIdxCabac)
        fs.grefw = np.zeros((2, h4, w4), dtype=bool)


_ZMV = np.zeros(2, np.int32)


class MvContext:
    """Neighbor lookup for MV prediction during parse of one slice."""

    def __init__(self, fs, slice_idx: int):
        ensure_motion_grids(fs)
        self.fs = fs
        self.slice_idx = slice_idx
        self.w4 = fs.mb_w * 4
        self.h4 = fs.mb_h * 4

    def block_info(self, bx: int, by: int, lx: int, cur_mb: int):
        """Returns (avail, ref_idx, mv[2]) of 4x4 block (bx, by)."""
        fs = self.fs
        if bx < 0 or by < 0 or bx >= self.w4 or by >= self.h4:
            return False, -1, np.zeros(2, np.int32)
        mb = (by // 4) * fs.mb_w + (bx // 4)
        if mb == cur_mb:
            if not fs.gwritten[by, bx]:
                return False, -1, np.zeros(2, np.int32)
        else:
            if fs.slice_id[mb] != self.slice_idx:
                return False, -1, np.zeros(2, np.int32)
        return True, int(fs.gref[lx, by, bx]), fs.gmv[lx, by, bx]

    def neighbors(self, gx: int, gy: int, pw: int, lx: int, cur_mb: int):
        """A, B, C (with D fallback) for a partition whose top-left 4x4
        block is (gx, gy) and width pw in 4x4 units."""
        a = self.block_info(gx - 1, gy, lx, cur_mb)
        b = self.block_info(gx, gy - 1, lx, cur_mb)
        c = self.block_info(gx + pw, gy - 1, lx, cur_mb)
        if not c[0]:
            c = self.block_info(gx - 1, gy - 1, lx, cur_mb)
        return a, b, c

    def pred_mv(self, gx: int, gy: int, pw: int, ph: int, lx: int,
                ref_idx: int, cur_mb: int) -> np.ndarray:
        """Median MVP (§8.4.1.3.1) incl. 16x8/8x16 directional rules."""
        (aa, ra, mva), (ab, rb, mvb), (ac, rc, mvc) = \
            self.neighbors(gx, gy, pw, lx, cur_mb)
        # 16x8 / 8x16 special cases (pw/ph in 4x4 units)
        if pw == 4 and ph == 2:  # 16x8
            if (gy % 4) == 0:  # upper
                if ab and rb == ref_idx:
                    return mvb.copy()
            else:  # lower
                if aa and ra == ref_idx:
                    return mva.copy()
        elif pw == 2 and ph == 4:  # 8x16
            if (gx % 4) == 0:  # left
                if aa and ra == ref_idx:
                    return mva.copy()
            else:  # right
                if ac and rc == ref_idx:
                    return mvc.copy()
        # general median rule
        match_a = aa and ra == ref_idx
        match_b = ab and rb == ref_idx
        match_c = ac and rc == ref_idx
        n_match = match_a + match_b + match_c
        if n_match == 1:
            if match_a:
                return mva.copy()
            if match_b:
                return mvb.copy()
            return mvc.copy()
        if not ab and not ac and aa:
            return mva.copy()
        va = mva if aa else _ZMV
        vb = mvb if ab else _ZMV
        vc = mvc if ac else _ZMV
        # median of three = sum - min - max, componentwise (scalar code:
        # np.median measured ~40 us/call across a 720p B frame)
        out = np.empty(2, np.int32)
        for k in (0, 1):
            x, y, z = int(va[k]), int(vb[k]), int(vc[k])
            out[k] = x + y + z - min(x, y, z) - max(x, y, z)
        return out

    def pred_skip_mv(self, gx: int, gy: int, cur_mb: int) -> np.ndarray:
        """P_Skip motion vector (§8.4.1.1)."""
        aa, ra, mva = self.block_info(gx - 1, gy, 0, cur_mb)
        ab, rb, mvb = self.block_info(gx, gy - 1, 0, cur_mb)
        if (not aa) or (not ab):
            return np.zeros(2, np.int32)
        if (ra == 0 and mva[0] == 0 and mva[1] == 0) or \
           (rb == 0 and mvb[0] == 0 and mvb[1] == 0):
            return np.zeros(2, np.int32)
        return self.pred_mv(gx, gy, 4, 4, 0, 0, cur_mb)

    def set_partition(self, gx: int, gy: int, pw: int, ph: int, lx: int,
                      ref_idx: int, mv) -> None:
        fs = self.fs
        fs.gmv[lx, gy:gy + ph, gx:gx + pw] = mv
        fs.gref[lx, gy:gy + ph, gx:gx + pw] = ref_idx
        fs.gwritten[gy:gy + ph, gx:gx + pw] = True
        fs.grefw[lx, gy:gy + ph, gx:gx + pw] = True
