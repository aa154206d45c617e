"""The in-loop deblocking filter (H.264 clause 8.7) of a decoded picture,
in NumPy.

The filter inputs of a picture (bS, QPs, filter offsets) come from its
FrameSymbols as the port's encoder/deblock_host.deblock_inputs derives
them (copied). The filter is a NumPy rewrite of the port's plain
PyTorch wavefront (encoder/deblock_torch.py): MBs on one knight
diagonal d = x + 2y have disjoint regions and all of their producers
(left, top, top-right) on earlier diagonals, so each diagonal filters
its MBs together, vertical edges left to right, then horizontal edges
top to bottom, as the MB-order process does.
"""

from __future__ import annotations

import numpy as np

from .deblock_bs import precompute_bs
from .tables_core import ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE, TC0_TABLE

_ALPHA = np.asarray(ALPHA_TABLE, np.int32)
_BETA = np.asarray(BETA_TABLE, np.int32)
_TC0 = np.asarray(TC0_TABLE, np.int32)


def deblock_inputs(fs):
    """(BSV, BSH, qp_mb, cqp_mb [2, n], alpha_off, beta_off) of one
    picture's FrameSymbols, int32, with the edges that are not filtered
    at bS 0: the edges of an MB not decoded correctly or with
    disable_deblock 1, an MB's left / top edge onto such a neighbour or,
    with disable_deblock 2, onto another slice, and the interior
    4-sample luma edges of an 8x8-transform MB."""
    mb_w, mb_h = fs.mb_w, fs.mb_h
    BSV, BSH = precompute_bs(fs)
    BSV = BSV.astype(np.int32)
    BSH = BSH.astype(np.int32)
    dd = fs.disable_deblock.reshape(mb_h, mb_w)
    sid = fs.slice_id.reshape(mb_h, mb_w)
    ok = (fs.mb_correct & (fs.mb_type >= 0)).reshape(mb_h, mb_w)
    cut_left = np.zeros((mb_h, mb_w), bool)
    cut_left[:, 1:] = ((dd[:, 1:] == 2) & (sid[:, 1:] != sid[:, :-1])) | \
        ~fs.mb_correct.reshape(mb_h, mb_w)[:, :-1]
    cut_top = np.zeros((mb_h, mb_w), bool)
    cut_top[1:, :] = ((dd[1:, :] == 2) & (sid[1:, :] != sid[:-1, :])) | \
        ~fs.mb_correct.reshape(mb_h, mb_w)[:-1, :]
    BSV[:, 0::4][np.repeat(cut_left, 4, 0)] = 0
    BSH[0::4, :][np.repeat(cut_top, 4, 1)] = 0
    off = np.repeat(np.repeat((dd == 1) | ~ok, 4, 0), 4, 1)
    BSV[off] = 0
    BSH[off] = 0
    t8 = np.repeat(np.repeat(fs.transform8.reshape(mb_h, mb_w), 4, 0), 4, 1)
    BSV[t8 & (np.arange(4 * mb_w) % 2 == 1)[None, :]] = 0
    BSH[t8 & (np.arange(4 * mb_h) % 2 == 1)[:, None]] = 0
    qp = fs.qp.astype(np.int32)
    offs = getattr(fs, "chroma_qp_offsets", (0, 0))
    cqp = np.stack([CHROMA_QP_TABLE[np.clip(qp + o, 0, 51)]
                    for o in offs]).astype(np.int32)
    return (BSV, BSH, qp, cqp, fs.alpha_offset.astype(np.int32),
            fs.beta_offset.astype(np.int32))


def _clip3(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def _luma_edge(sub, bs, alpha, beta, tc0):
    """sub [..., 8] int32 (p3..q3 across the edge); returns [..., 6]
    (p2..q2) filtered."""
    p3, p2, p1, p0, q0, q1, q2, q3 = np.moveaxis(sub, -1, 0)
    d0 = p0 - q0
    act = (bs > 0) & (np.abs(d0) < alpha) & \
        (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    is4 = bs == 4
    strong = np.abs(d0) < ((alpha >> 2) + 2)
    sp = ap & strong
    sq = aq & strong
    np0_4 = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                     (2 * p1 + p0 + q1 + 2) >> 2)
    np1_4 = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    np2_4 = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    nq0_4 = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                     (2 * q1 + q0 + p1 + 2) >> 2)
    nq1_4 = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    nq2_4 = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    tc = tc0 + ap + aq
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_n = np.clip(p0 + delta, 0, 255)
    nq0_n = np.clip(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    dp1 = _clip3((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
    dq1 = _clip3((q2 + avg - 2 * q1) >> 1, -tc0, tc0)
    np1_n = np.where(ap, p1 + dp1, p1)
    nq1_n = np.where(aq, q1 + dq1, q1)
    return np.stack([
        np.where(act & is4, np2_4, p2),
        np.where(act, np.where(is4, np1_4, np1_n), p1),
        np.where(act, np.where(is4, np0_4, np0_n), p0),
        np.where(act, np.where(is4, nq0_4, nq0_n), q0),
        np.where(act, np.where(is4, nq1_4, nq1_n), q1),
        np.where(act & is4, nq2_4, q2)], -1)


def _chroma_edge(sub, bs, alpha, beta, tc0):
    """sub [..., 4] (p1 p0 q0 q1); returns [..., 2] (p0 q0) filtered."""
    p1, p0, q0, q1 = np.moveaxis(sub, -1, 0)
    act = (bs > 0) & (np.abs(p0 - q0) < alpha) & \
        (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    is4 = bs == 4
    tc = tc0 + 1
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = np.where(is4, (2 * p1 + p0 + q1 + 2) >> 2, np.clip(p0 + delta, 0,
                                                              255))
    nq0 = np.where(is4, (2 * q1 + q0 + p1 + 2) >> 2, np.clip(q0 - delta, 0,
                                                              255))
    return np.stack([np.where(act, np0, p0), np.where(act, nq0, q0)], -1)


def _edge_params(BSV, BSH, qp_mb, cqp_mb, mb_w, mb_h, alpha_off, beta_off):
    """Per MB and edge: luma bs [n,4,16], alpha/beta [n,4], tc0 [n,4,16]
    and chroma bs [n,2,8], alpha/beta [n,2 planes,2], tc0 [n,2,2,8], for
    the vertical (v, cv) and horizontal (h, ch) passes. Edge 0 crosses
    the MB border: bS 0 at the picture border, the QP averaged with the
    left (v) or top (h) MB's."""
    n = mb_w * mb_h
    ar = np.arange(n)
    x, y = ar % mb_w, ar // mb_w
    left_id = y * mb_w + np.maximum(x - 1, 0)
    top_id = np.maximum(y - 1, 0) * mb_w + x
    bsv4 = BSV.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 3, 1).reshape(
        n, 4, 4).copy()
    bsh4 = BSH.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3).reshape(
        n, 4, 4).copy()
    bsv4[:, 0] *= (x > 0)[:, None]
    bsh4[:, 0] *= (y > 0)[:, None]
    ao, bo = alpha_off[:, None], beta_off[:, None]

    def pack(bs4, q, nb_id, rep):
        qnb = np.stack([q[nb_id]] + [q] * (bs4.shape[1] - 1), 1)
        qav = (q[:, None] + qnb + 1) >> 1
        ia = np.clip(qav + ao, 0, 51)
        ib = np.clip(qav + bo, 0, 51)
        bs = np.repeat(bs4, rep, axis=2)
        tc0 = _TC0[ia[..., None], np.clip(bs - 1, 0, 2)]
        return bs, _ALPHA[ia], _BETA[ib], tc0

    def pack_chroma(bs4, nb_id):
        planes = [pack(bs4, cqp_mb[k], nb_id, 2) for k in range(2)]
        return (planes[0][0],) + tuple(
            np.stack([p[i] for p in planes], 1) for i in (1, 2, 3))

    return {"v": pack(bsv4, qp_mb, left_id, 4),
            "h": pack(bsh4, qp_mb, top_id, 4),
            "cv": pack_chroma(bsv4[:, ::2], left_id),
            "ch": pack_chroma(bsh4[:, ::2], top_id)}


def _diagonals(mb_w, mb_h):
    out = []
    for d in range(mb_w + 2 * (mb_h - 1)):
        ys = np.arange(max(0, -(-(d - mb_w + 1) // 2)),
                       min(mb_h - 1, d // 2) + 1)
        out.append(ys * mb_w + (d - 2 * ys))
    return out


def _per_plane(cal, cbe, ctc, ce):
    return (cal[:, :, ce].T[:, :, None], cbe[:, :, ce].T[:, :, None],
            ctc[:, :, ce].transpose(1, 0, 2))


def _filter_mbs(Yp, UVp, prm, ids, mb_w):
    """Filters the MBs `ids` (disjoint regions) of the zero-padded int32
    working planes in place: gather, both passes, scatter."""
    mx, my = ids % mb_w, ids // mb_w
    r20, r10 = np.arange(20), np.arange(10)
    ry = (16 * my[:, None] + r20)[:, :, None]
    rx = (16 * mx[:, None] + r20)[:, None, :]
    cy = (8 * my[:, None] + r10)[:, :, None]
    cx = (8 * mx[:, None] + r10)[:, None, :]
    R = Yp[ry, rx]                       # [L,20,20]
    C = UVp[:, cy, cx]                   # [2,L,10,10]
    bs, al, be, tc = (t[ids] for t in prm["v"])
    cbs, cal, cbe, ctc = (t[ids] for t in prm["cv"])
    for e in range(4):
        R[:, 4:20, 4 * e + 1:4 * e + 7] = _luma_edge(
            R[:, 4:20, 4 * e:4 * e + 8], bs[:, e], al[:, e, None],
            be[:, e, None], tc[:, e])
        if e in (0, 2):
            ce = e // 2
            C[:, :, 2:10, 4 * ce + 1:4 * ce + 3] = _chroma_edge(
                C[:, :, 2:10, 4 * ce:4 * ce + 4], cbs[:, ce],
                *_per_plane(cal, cbe, ctc, ce))
    bs, al, be, tc = (t[ids] for t in prm["h"])
    cbs, cal, cbe, ctc = (t[ids] for t in prm["ch"])
    for e in range(4):
        new = _luma_edge(R[:, 4 * e:4 * e + 8, 4:20].transpose(0, 2, 1),
                         bs[:, e], al[:, e, None], be[:, e, None], tc[:, e])
        R[:, 4 * e + 1:4 * e + 7, 4:20] = new.transpose(0, 2, 1)
        if e in (0, 2):
            ce = e // 2
            newc = _chroma_edge(
                C[:, :, 4 * ce:4 * ce + 4, 2:10].transpose(0, 1, 3, 2),
                cbs[:, ce], *_per_plane(cal, cbe, ctc, ce))
            C[:, :, 4 * ce + 1:4 * ce + 3, 2:10] = newc.transpose(0, 1, 3, 2)
    Yp[ry, rx] = R
    UVp[:, cy, cx] = C


def deblock_picture(y, u, v, fs):
    """The deblocked (y, u, v) uint8 planes of a picture whose decoded
    planes are y, u, v (MB aligned) and whose symbols are fs."""
    mb_w, mb_h = fs.mb_w, fs.mb_h
    BSV, BSH, qp, cqp, ao, bo = deblock_inputs(fs)
    prm = _edge_params(BSV, BSH, qp, cqp, mb_w, mb_h, ao, bo)
    H, W = y.shape
    Hc, Wc = u.shape
    Yp = np.zeros((H + 4, W + 4), np.int32)
    Yp[4:, 4:] = y
    UVp = np.zeros((2, Hc + 2, Wc + 2), np.int32)
    UVp[0, 2:, 2:] = u
    UVp[1, 2:, 2:] = v
    for ids in _diagonals(mb_w, mb_h):
        _filter_mbs(Yp, UVp, prm, ids, mb_w)
    return (Yp[4:, 4:].astype(np.uint8), UVp[0, 2:, 2:].astype(np.uint8),
            UVp[1, 2:, 2:].astype(np.uint8))
