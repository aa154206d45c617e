"""Frame-wide vectorized boundary-strength (bS) computation.

Pure function of FrameSymbols — no pixel dependency — so all edges of a
frame batch in one shot (the sequential part of deblocking is only the
pixel filtering). Bit-exact with oracle.deblock.compute_bs_edge
(reference deblocking.cpp DeblockingBSCalcEnc / decoder deblocking.cpp
BS rules, spec 8.7.2.1).

Copied from openh264_tpu/oracle/deblock_bs.py.
"""

from __future__ import annotations

import numpy as np

_SENTINEL = 1 << 30


def _expand_mb_to_blocks(per_mb: np.ndarray, mb_h: int, mb_w: int) -> np.ndarray:
    g = per_mb.reshape(mb_h, mb_w)
    return np.repeat(np.repeat(g, 4, axis=0), 4, axis=1)


def _block_grids(fs):
    """Per-4x4-block grids: intra flag, used/ref-pic/mv per list."""
    n = fs.n_mb
    intra_mb = (fs.mb_type >= 0) & (fs.mb_type <= 3)
    g_intra = _expand_mb_to_blocks(intra_mb, fs.mb_h, fs.mb_w)

    H4, W4 = fs.mb_h * 4, fs.mb_w * 4
    used = np.zeros((2, H4, W4), bool)
    rp = np.full((2, H4, W4), _SENTINEL, np.int64)
    mv = np.zeros((2, H4, W4, 2), np.int32)
    # quadrant expansion: refidx/ref_pic are per (mb, list, quadrant)
    for lx in range(2):
        u = (fs.refidx[:, lx, :] >= 0)                       # [n,4]
        u4 = u.reshape(fs.mb_h, fs.mb_w, 2, 2)
        u4 = u4.transpose(0, 2, 1, 3).reshape(fs.mb_h * 2, fs.mb_w * 2)
        used[lx] = np.repeat(np.repeat(u4, 2, 0), 2, 1)
        r = fs.ref_pic[:, lx, :].astype(np.int64)
        r4 = r.reshape(fs.mb_h, fs.mb_w, 2, 2)
        r4 = r4.transpose(0, 2, 1, 3).reshape(fs.mb_h * 2, fs.mb_w * 2)
        rp[lx] = np.repeat(np.repeat(r4, 2, 0), 2, 1)
        m = fs.mv[:, lx].reshape(fs.mb_h, fs.mb_w, 4, 4, 2)
        mv[lx] = m.transpose(0, 2, 1, 3, 4).reshape(H4, W4, 2)
    rp[~used] = _SENTINEL
    return g_intra, used, rp, mv


def _bs_mv_pairs(usedP, rpP, mvP, usedQ, rpQ, mvQ):
    """Vectorized _bs_mv over aligned block-pair arrays. Inputs:
    used*: [2,...] bool; rp*: [2,...] int (SENTINEL when unused);
    mv*: [2,...,2]. Returns bs (0/1) int array."""
    cntP = usedP[0].astype(np.int32) + usedP[1]
    cntQ = usedQ[0].astype(np.int32) + usedQ[1]
    bs = np.zeros(cntP.shape, np.int32)
    bs[cntP != cntQ] = 1
    # sorted ref-id multiset comparison (SENTINEL pads the unused slots)
    loP = np.minimum(rpP[0], rpP[1])
    hiP = np.maximum(rpP[0], rpP[1])
    loQ = np.minimum(rpQ[0], rpQ[1])
    hiQ = np.maximum(rpQ[0], rpQ[1])
    refdiff = (loP != loQ) | (hiP != hiQ)
    bs[(cntP == cntQ) & refdiff] = 1

    def far(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | \
               (np.abs(a[..., 1] - b[..., 1]) >= 4)

    open_ = (bs == 0)
    # cnt == 1: the single used list on each side
    m1 = open_ & (cntP == 1)
    if m1.any():
        selP = np.where(usedP[0][..., None], mvP[0], mvP[1])
        selQ = np.where(usedQ[0][..., None], mvQ[0], mvQ[1])
        bs[m1 & far(selP, selQ)] = 1
    # cnt == 2, distinct ref pics: match by picture
    m2 = open_ & (cntP == 2)
    if m2.any():
        distinct = rpP[0] != rpP[1]
        # Q's mv for P's list-0 pic / list-1 pic
        q_for_p0 = np.where((rpQ[0] == rpP[0])[..., None], mvQ[0], mvQ[1])
        q_for_p1 = np.where((rpQ[0] == rpP[1])[..., None], mvQ[0], mvQ[1])
        fard = far(mvP[0], q_for_p0) | far(mvP[1], q_for_p1)
        bs[m2 & distinct & fard] = 1
        # same picture in both lists: either pairing may satisfy
        a = ~far(mvP[0], mvQ[0]) & ~far(mvP[1], mvQ[1])
        b = ~far(mvP[0], mvQ[1]) & ~far(mvP[1], mvQ[0])
        bs[m2 & ~distinct & ~(a | b)] = 1
    return bs


def precompute_bs(fs):
    """Returns (BSV, BSH): BSV[y, x] = bS of the vertical edge between
    blocks (x-1, y) and (x, y); BSH[y, x] = bS of the horizontal edge
    between (x, y-1) and (x, y). Column/row 0 entries are 0 (picture
    border, never filtered)."""
    g_intra, used, rp, mv = _block_grids(fs)
    H4, W4 = g_intra.shape
    nz = fs.nzc_l > 0
    # 8x8-transform MBs: the nonzero condition uses the covering 8x8
    # block's OR when BOTH sides of the edge are in t8 MBs
    # (deblocking.cpp:243 DeblockingBSInsideMBAvsbase8x8, :463 marginal
    # both-t8 case)
    t8g = _expand_mb_to_blocks(fs.transform8.astype(bool), fs.mb_h, fs.mb_w)
    q_or = nz.reshape(H4 // 2, 2, W4 // 2, 2).any((1, 3))
    nz8 = np.repeat(np.repeat(q_or, 2, 0), 2, 1)

    BSV = np.zeros((H4, W4), np.int32)
    BSH = np.zeros((H4, W4), np.int32)

    for vertical in (True, False):
        if vertical:
            iq = np.s_[:, 1:]
            ip = np.s_[:, :-1]
        else:
            iq = np.s_[1:, :]
            ip = np.s_[:-1, :]
        intra_q = g_intra[iq]
        intra_p = g_intra[ip]
        # MB-boundary mask for these edges
        if vertical:
            mbb = (np.arange(1, W4) % 4 == 0)[None, :]
            mbb = np.broadcast_to(mbb, intra_q.shape)
        else:
            mbb = (np.arange(1, H4) % 4 == 0)[:, None]
            mbb = np.broadcast_to(mbb, intra_q.shape)
        bs = _bs_mv_pairs(
            (used[0][ip], used[1][ip]), (rp[0][ip], rp[1][ip]),
            (mv[0][ip], mv[1][ip]),
            (used[0][iq], used[1][iq]), (rp[0][iq], rp[1][iq]),
            (mv[0][iq], mv[1][iq]))
        nzp = np.where(t8g[ip], nz8[ip], nz[ip])
        nzq = np.where(t8g[iq], nz8[iq], nz[iq])
        bs = np.where(nzp | nzq, 2, bs)
        # interior-edge overrides (WelsDeblockingMb, deblocking.cpp:1184):
        # IS_SKIP -> no interior edges; IS_INTER_16x16 (incl. direct MBs
        # promoted by GetColocatedMb) -> nz-only, no mv term. Both sides
        # of an interior edge are the same MB, so index via iq.
        ibs = _expand_mb_to_blocks(fs.ibs_mode, fs.mb_h, fs.mb_w)[iq]
        bs = np.where(~mbb & (ibs == 1), np.where(nzp | nzq, 2, 0), bs)
        bs = np.where(~mbb & (ibs == 2), 0, bs)
        # intra rules override
        bs = np.where(mbb & (intra_p | intra_q), 4, bs)
        bs = np.where(~mbb & intra_q, 3, bs)
        if vertical:
            BSV[:, 1:] = bs
        else:
            BSH[1:, :] = bs
    return BSV, BSH
