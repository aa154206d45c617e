"""Reconstruction of I, P and B pictures with several reference pictures,
weighted prediction and the 8x8 transform, in NumPy, written for the
benchmark's reference from clause 8.4.2 (the frozen recon.py covers P
pictures predicting from one picture only).

Every 4x4 luma block (and its 2x2 chroma blocks) of the inter MBs is
predicted from list 0, list 1 or both by the frozen quarter-sample
interpolation of recon.py (8.4.2.2), then combined (8.4.2.3): default
(a copy, or the rounded average of two), explicit weights of the slice's
pred_weight_table (P slices under weighted_pred_flag, B slices under
weighted_bipred_idc 1) or implicit weights from the POC distances of
the two pictures (weighted_bipred_idc 2, bi-prediction only). The
residual is added by the inverse 4x4 or 8x8 transform (8.5.12), and the
intra MBs follow in raster order (recon_intra.py).
"""

from __future__ import annotations

import numpy as np

from .direct import dist_scale_factor
from .framedata import INTRA_CLASSES, FrameSymbols
from .intra8 import _idct8_butterfly
from .recon import mc_chroma, mc_luma
from .recon_intra import HostPlanes, idct4x4_add, recon_intra_mb
from .slicehdr import B_SLICE, P_SLICE

# combination per block
DEFAULT, WEIGHTED = 0, 1


class SliceRefs:
    """What a slice's prediction needs: its header, its final lists and
    the current picture's POC."""

    def __init__(self, sh, l0, l1, cur_poc: int):
        self.sh, self.l0, self.l1, self.cur_poc = sh, l0, l1, cur_poc
        pps = sh.pps
        self.explicit = ((sh.slice_type == P_SLICE and pps.weighted_pred)
                         or (sh.slice_type == B_SLICE
                             and pps.weighted_bipred_idc == 1))
        self.implicit = (sh.slice_type == B_SLICE
                         and pps.weighted_bipred_idc == 2)

    def explicit_w(self, lx: int, ref: int, plane: int):
        """(weight, offset, logWD) of pred_weight_table (8.4.2.3)."""
        sh = self.sh
        w = sh.weights[(lx, ref)]
        if plane == 0:
            return w["luma_weight"], w["luma_offset"], \
                sh.luma_log2_weight_denom
        return (w["chroma_weight"][plane - 1], w["chroma_offset"][plane - 1],
                sh.chroma_log2_weight_denom)

    def implicit_w(self, r0: int, r1: int):
        """(w0, w1) of implicit bi-prediction (8.4.2.3.1)."""
        p0, p1 = self.l0[r0], self.l1[r1]
        if p1.poc == p0.poc or p0.is_long_term or p1.is_long_term:
            return 32, 32
        dsf = dist_scale_factor(self.cur_poc, p0.poc, p1.poc) >> 2
        if dsf < -64 or dsf > 128:
            return 32, 32
        return 64 - dsf, dsf


def _weights(fs: FrameSymbols, mb_u, q, slices):
    """Per block: kind (DEFAULT / WEIGHTED) and, per plane, the arrays
    w0, o0, w1, o1, logWD of the combination."""
    B = len(mb_u)
    r = [fs.refidx[mb_u, lx, q].astype(np.int32) for lx in (0, 1)]
    sid = fs.slice_id[mb_u]
    kind = np.zeros(B, np.int32)
    par = np.zeros((3, 5, B), np.int64)
    key = np.stack([sid, r[0], r[1]], 1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    for k, (s, r0, r1) in enumerate(uniq.tolist()):
        sr = slices[s]
        sel = inv == k
        bi = r0 >= 0 and r1 >= 0
        if sr.explicit:
            kind[sel] = WEIGHTED
            for c in range(3):
                if bi:
                    w0, o0, d = sr.explicit_w(0, r0, c)
                    w1, o1, _ = sr.explicit_w(1, r1, c)
                else:
                    lx, ri = (0, r0) if r0 >= 0 else (1, r1)
                    w0, o0, d = sr.explicit_w(lx, ri, c)
                    w1 = o1 = 0
                par[c][:, sel] = np.array([w0, o0, w1, o1, d])[:, None]
        elif sr.implicit and bi:
            kind[sel] = WEIGHTED
            w0, w1 = sr.implicit_w(r0, r1)
            par[:, :, sel] = np.array([w0, 0, w1, 0, 5])[None, :, None]
    return kind, par


def _combine(p0, p1, bi, kind, par):
    """8.4.2.3 per block: p0 the first used list's prediction, p1 list
    1's where both are used. Returns uint8."""
    ext = (slice(None),) + (None,) * (p0.ndim - 1)
    w0, o0, w1, o1, d = (a[ext] for a in par)
    b = bi[ext]
    wtd = (kind == WEIGHTED)[ext]
    single_w = np.where(d >= 1, ((p0 * w0 + (1 << np.maximum(d - 1, 0)))
                                 >> d) + o0, p0 * w0 + o0)
    bi_w = ((p0 * w0 + p1 * w1 + (1 << d)) >> (d + 1)) + ((o0 + o1 + 1) >> 1)
    out = np.where(b, np.where(wtd, bi_w, (p0 + p1 + 1) >> 1),
                   np.where(wtd, single_w, p0))
    return np.clip(out, 0, 255).astype(np.uint8)


def _idct8x8_add_batch(pred, coef):
    """The frozen 8x8 inverse transform and add (intra8.idct8x8_add) over
    K blocks at once: pred [K, 8, 8] uint8, coef [K, 64]."""
    k = len(pred)
    rows = _idct8_butterfly(coef.reshape(k * 8, 8).astype(np.int64))
    cols = _idct8_butterfly(rows.reshape(k, 8, 8).transpose(0, 2, 1)
                            .reshape(k * 8, 8))
    res = cols.reshape(k, 8, 8).transpose(0, 2, 1)
    return np.clip(pred.astype(np.int64) + ((32 + res) >> 6), 0, 255
                   ).astype(np.uint8)


def _inter(y, u, v, fs: FrameSymbols, mbs, pics: dict, slices) -> None:
    mb_w = fs.mb_w
    n = len(mbs)
    mb_u = np.repeat(mbs, 16)
    blk = np.tile(np.arange(16), n)
    q = (blk // 8) * 2 + (blk % 4) // 2
    gx4 = (mb_u % mb_w) * 4 + blk % 4
    gy4 = (mb_u // mb_w) * 4 + blk // 4
    used = [fs.refidx[mb_u, lx, q] >= 0 for lx in (0, 1)]
    if (~(used[0] | used[1])).any():
        raise ValueError("an inter block predicts from no list")
    preds = []          # per list: luma [B,4,4], cb, cr [B,2,2] int64
    for lx in (0, 1):
        pid = fs.ref_pic[mb_u, lx, q]
        mv = fs.mv[mb_u, lx, blk]
        py = np.zeros((len(mb_u), 4, 4), np.int64)
        pu = np.zeros((len(mb_u), 2, 2), np.int64)
        pv = np.zeros((len(mb_u), 2, 2), np.int64)
        for p in np.unique(pid[used[lx]]):
            sel = used[lx] & (pid == p)
            ry, ru, rv = pics[int(p)].planes
            x0, y0, mx, my = gx4[sel] * 4, gy4[sel] * 4, mv[sel, 0], \
                mv[sel, 1]
            py[sel] = mc_luma(ry, x0, y0, mx, my)
            pu[sel] = mc_chroma(ru, x0 >> 1, y0 >> 1, mx, my)
            pv[sel] = mc_chroma(rv, x0 >> 1, y0 >> 1, mx, my)
        preds.append((py, pu, pv))
    bi = used[0] & used[1]
    kind, par = _weights(fs, mb_u, q, slices)
    first = [np.where(used[0][(slice(None),) + (None,) * 2],
                      preds[0][c], preds[1][c]) for c in range(3)]
    out = [_combine(first[c], preds[1][c], bi, kind, par[c])
           for c in range(3)]
    H, W = y.shape
    yv = y.reshape(H // 4, 4, W // 4, 4).transpose(0, 2, 1, 3)
    cH, cW = u.shape
    uv = u.reshape(cH // 2, 2, cW // 2, 2).transpose(0, 2, 1, 3)
    vv = v.reshape(cH // 2, 2, cW // 2, 2).transpose(0, 2, 1, 3)
    yv[gy4, gx4], uv[gy4, gx4], vv[gy4, gx4] = out
    # residual: 4x4 or 8x8 luma transform, 4x4 chroma
    coded = (fs.cbp[mbs] & 15) != 0
    t8 = fs.transform8[mbs]
    luma = mbs[coded & ~t8]
    if len(luma):
        r4 = np.arange(4)
        g_y = ((luma // mb_w) * 4)[:, None] + np.repeat(r4, 4)[None, :]
        g_x = ((luma % mb_w) * 4)[:, None] + np.tile(r4, 4)[None, :]
        yv[g_y, g_x] = idct4x4_add(yv[g_y, g_x],
                                   fs.coeffs_l[luma].reshape(-1, 16, 4, 4))
    luma8 = mbs[coded & t8]
    if len(luma8):
        fs.ensure_coeffs8()
        y8 = y.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)
        r2 = np.arange(2)
        g_y = (((luma8 // mb_w) * 2)[:, None]
               + np.repeat(r2, 2)[None, :]).reshape(-1)
        g_x = (((luma8 % mb_w) * 2)[:, None]
               + np.tile(r2, 2)[None, :]).reshape(-1)
        y8[g_y, g_x] = _idct8x8_add_batch(y8[g_y, g_x],
                                          fs.coeffs8[luma8].reshape(-1, 64))
    chroma = mbs[(fs.cbp[mbs] & 0x30) != 0]
    if len(chroma):
        r2 = np.arange(2)
        cg_y = ((chroma // mb_w) * 2)[:, None] + np.repeat(r2, 2)[None, :]
        cg_x = ((chroma % mb_w) * 2)[:, None] + np.tile(r2, 2)[None, :]
        coefs = fs.coeffs_c[chroma].reshape(-1, 2, 4, 4, 4)
        for k, plane in enumerate((u, v)):
            pv_ = plane.reshape(cH // 4, 4, cW // 4, 4).transpose(0, 2, 1, 3)
            pv_[cg_y, cg_x] = idct4x4_add(pv_[cg_y, cg_x], coefs[:, k])


def recon_picture_b(fs: FrameSymbols, pics: dict, slices: list,
                    constrained: bool):
    """The (y, u, v) uint8 planes, before the deblock, of the picture fs
    describes. pics: pic_id -> dpb.Picture of every picture its slices
    refer to; slices: a SliceRefs per slice, by slice index."""
    h, w = fs.mb_h * 16, fs.mb_w * 16
    y = np.zeros((h, w), np.uint8)
    u = np.zeros((h // 2, w // 2), np.uint8)
    v = np.zeros((h // 2, w // 2), np.uint8)
    if not fs.mb_correct.all():
        raise ValueError("picture not completely decoded")
    inter = np.nonzero(fs.mb_type >= 4)[0]
    if len(inter):
        _inter(y, u, v, fs, inter, pics, slices)
    hp = HostPlanes(fs, y, u, v)
    for idx in np.nonzero(np.isin(fs.mb_type, INTRA_CLASSES))[0]:
        recon_intra_mb(hp, int(idx), constrained)
    return y, u, v
