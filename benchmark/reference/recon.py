"""Reconstruction of a decoded P or I picture from its FrameSymbols, in
NumPy: inter MBs by motion compensation from the one reference picture
plus their 4x4 residual, then intra MBs in raster order (recon_intra).

The motion compensation is a NumPy rewrite of the port's batched
PyTorch version (ops/recon_torch.py): clamped windows (the reference
picture's border replicated), the 6-tap quarter-sample luma filter and
the bilinear eighth-sample chroma filter of clause 8.4.2.2, every 4x4
block at once.
"""

from __future__ import annotations

import numpy as np

from .framedata import INTRA_CLASSES, FrameSymbols
from .recon_intra import HostPlanes, idct4x4_add, recon_intra_mb


def _windows(plane, yi, xi, size):
    H, W = plane.shape
    r = np.arange(size)
    ys = np.clip(yi[:, None] + r[None, :], 0, H - 1)
    xs = np.clip(xi[:, None] + r[None, :], 0, W - 1)
    return plane[ys[:, :, None], xs[:, None, :]].astype(np.int32)


def _tap6(a, axis, n):
    s = [np.take(a, np.arange(k, k + n), axis=axis) for k in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def mc_luma(plane, x0, y0, mvx, mvy):
    """4x4 luma blocks at (x0, y0) moved by quarter-sample vectors:
    uint8 [B, 4, 4]."""
    xi, yi = x0 + (mvx >> 2), y0 + (mvy >> 2)
    xf, yf = mvx & 3, mvy & 3
    wnd = _windows(plane, yi - 2, xi - 2, 10)             # [B,10,10]

    def clip8(a):
        return np.clip(a, 0, 255)

    b1 = _tap6(wnd, 2, 5)                                  # [B,10,5]
    b_full = clip8((b1[:, 2:7, :] + 16) >> 5)              # [B,5,5]
    h1 = _tap6(wnd, 1, 5)                                  # [B,5,10]
    h_full = clip8((h1[:, :, 2:7] + 16) >> 5)
    j_full = clip8((_tap6(b1, 1, 5) + 512) >> 10)          # [B,5,5]
    G = wnd[:, 2:7, 2:7]
    g0, H_, M_ = G[:, :4, :4], G[:, :4, 1:5], G[:, 1:5, :4]
    b, s = b_full[:, :4, :4], b_full[:, 1:5, :4]
    h, m = h_full[:, :4, :4], h_full[:, :4, 1:5]
    j = j_full[:, :4, :4]
    cand = np.stack([
        g0, (g0 + b + 1) >> 1, b, (H_ + b + 1) >> 1,
        (g0 + h + 1) >> 1, (b + h + 1) >> 1, (b + j + 1) >> 1,
        (b + m + 1) >> 1,
        h, (h + j + 1) >> 1, j, (j + m + 1) >> 1,
        (M_ + h + 1) >> 1, (h + s + 1) >> 1, (j + s + 1) >> 1,
        (m + s + 1) >> 1])                                 # [16,B,4,4]
    return cand[yf * 4 + xf, np.arange(len(x0))].astype(np.uint8)


def mc_chroma(plane, x0, y0, mvx, mvy):
    """2x2 chroma blocks at (x0, y0) moved by the luma vectors read as
    eighth-sample: uint8 [B, 2, 2]."""
    xi, yi = x0 + (mvx >> 3), y0 + (mvy >> 3)
    xf = (mvx & 7)[:, None, None]
    yf = (mvy & 7)[:, None, None]
    wnd = _windows(plane, yi, xi, 3)
    A, B_ = wnd[:, :2, :2], wnd[:, :2, 1:3]
    C, D = wnd[:, 1:3, :2], wnd[:, 1:3, 1:3]
    return (((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B_
             + (8 - xf) * yf * C + xf * yf * D + 32) >> 6).astype(np.uint8)


def _inter(y, u, v, fs: FrameSymbols, ref, mbs):
    """Prediction and residual of the inter MBs `mbs` of a P picture into
    the planes y, u, v, from the reference planes `ref`."""
    if (fs.pred_mode[mbs] != 0).any() or (fs.refidx[mbs, 0] != 0).any():
        raise NotImplementedError("only list-0 prediction from one "
                                  "reference picture")
    if fs.transform8[mbs].any():
        raise NotImplementedError("the 8x8 transform")
    mb_w = fs.mb_w
    n = len(mbs)
    blk = np.tile(np.arange(16), n)
    gx4 = np.repeat(mbs % mb_w, 16) * 4 + blk % 4
    gy4 = np.repeat(mbs // mb_w, 16) * 4 + blk // 4
    mv = fs.mv[np.repeat(mbs, 16), 0, blk]
    ry, ru, rv = ref
    py = mc_luma(ry, gx4 * 4, gy4 * 4, mv[:, 0], mv[:, 1])
    pu = mc_chroma(ru, gx4 * 2, gy4 * 2, mv[:, 0], mv[:, 1])
    pv = mc_chroma(rv, gx4 * 2, gy4 * 2, mv[:, 0], mv[:, 1])
    H, W = y.shape
    yv = y.reshape(H // 4, 4, W // 4, 4).transpose(0, 2, 1, 3)
    cH, cW = u.shape
    uv = u.reshape(cH // 2, 2, cW // 2, 2).transpose(0, 2, 1, 3)
    vv = v.reshape(cH // 2, 2, cW // 2, 2).transpose(0, 2, 1, 3)
    yv[gy4, gx4] = py
    uv[gy4, gx4] = pu
    vv[gy4, gx4] = pv
    luma = mbs[(fs.cbp[mbs] & 15) != 0]
    if len(luma):
        r4 = np.arange(4)
        g_y = ((luma // mb_w) * 4)[:, None] + np.repeat(r4, 4)[None, :]
        g_x = ((luma % mb_w) * 4)[:, None] + np.tile(r4, 4)[None, :]
        yv[g_y, g_x] = idct4x4_add(yv[g_y, g_x],
                                   fs.coeffs_l[luma].reshape(-1, 16, 4, 4))
    chroma = mbs[(fs.cbp[mbs] & 0x30) != 0]
    if len(chroma):
        r2 = np.arange(2)
        cg_y = ((chroma // mb_w) * 2)[:, None] + np.repeat(r2, 2)[None, :]
        cg_x = ((chroma % mb_w) * 2)[:, None] + np.tile(r2, 2)[None, :]
        coefs = fs.coeffs_c[chroma].reshape(-1, 2, 4, 4, 4)
        for k, plane in enumerate((u, v)):
            pv_ = plane.reshape(cH // 4, 4, cW // 4, 4).transpose(0, 2, 1, 3)
            pv_[cg_y, cg_x] = idct4x4_add(pv_[cg_y, cg_x], coefs[:, k])


def recon_picture(fs: FrameSymbols, ref, constrained: bool):
    """The decoded (y, u, v) uint8 planes, before the deblock, of the
    picture `fs` describes; ref is the reference picture's planes (None
    for an I picture)."""
    h, w = fs.mb_h * 16, fs.mb_w * 16
    y = np.zeros((h, w), np.uint8)
    u = np.zeros((h // 2, w // 2), np.uint8)
    v = np.zeros((h // 2, w // 2), np.uint8)
    if not fs.mb_correct.all():
        raise ValueError("picture not completely decoded")
    inter = np.nonzero(fs.mb_type >= 4)[0]
    if len(inter):
        if ref is None:
            raise ValueError("inter MBs without a reference picture")
        _inter(y, u, v, fs, ref, inter)
    hp = HostPlanes(fs, y, u, v)
    for idx in np.nonzero(np.isin(fs.mb_type, INTRA_CLASSES))[0]:
        recon_intra_mb(hp, int(idx), constrained)
    return y, u, v
