"""Numpy oracle for Intra_8x8 luma prediction (H.264 §8.3.2).

Reference-sample low-pass filtering (§8.3.2.2.1) + 9 prediction modes.
Parity anchors: codec/decoder/core/src/get_intra_predictor.cpp
WelsI8x8LumaPred*_c (:383-870).

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/oracle/intra8.py; only its imports changed.
"""

from __future__ import annotations

import numpy as np


def _filter_refs(top: np.ndarray, left: np.ndarray, tl: int,
                 avail_top: bool, avail_left: bool, avail_tl: bool,
                 avail_tr: bool):
    """Returns (ft[16], fl[8], ftl) filtered reference samples.
    top: raw 16 top samples (8..15 may be garbage if !avail_tr),
    left: raw 8."""
    ft = np.zeros(16, np.int32)
    fl = np.zeros(8, np.int32)
    ftl = 0
    if avail_top:
        t = top.astype(np.int64).copy()
        if not avail_tr:
            t[8:] = t[7]
        ft[0] = ((tl + 2 * t[0] + t[1] + 2) >> 2) if avail_tl else \
                ((3 * t[0] + t[1] + 2) >> 2)
        for i in range(1, 15):
            ft[i] = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if avail_left:
        l = left.astype(np.int64)
        fl[0] = ((tl + 2 * l[0] + l[1] + 2) >> 2) if avail_tl else \
                ((3 * l[0] + l[1] + 2) >> 2)
        for i in range(1, 7):
            fl[i] = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2
    if avail_tl:
        if avail_top and avail_left:
            ftl = (int(top[0]) + 2 * tl + int(left[0]) + 2) >> 2
        elif avail_top:
            ftl = (3 * tl + int(top[0]) + 2) >> 2
        elif avail_left:
            ftl = (3 * tl + int(left[0]) + 2) >> 2
        else:
            ftl = tl
    return ft, fl, ftl


def predict_8x8(mode: int, top: np.ndarray, left: np.ndarray, tl: int,
                avail_top: bool, avail_left: bool, avail_tl: bool,
                avail_tr: bool) -> np.ndarray:
    """Intra 8x8 prediction, modes 0..8 (V,H,DC,DDL,DDR,VR,HD,VL,HU)."""
    t, l, q = _filter_refs(top, left, tl, avail_top, avail_left, avail_tl,
                           avail_tr)
    p = np.zeros((8, 8), np.int32)
    if mode == 2:  # DC
        if avail_top and avail_left:
            dc = (t[:8].sum() + l.sum() + 8) >> 4
        elif avail_left:
            dc = (l.sum() + 4) >> 3
        elif avail_top:
            dc = (t[:8].sum() + 4) >> 3
        else:
            dc = 128
        p[:, :] = dc
    elif mode == 0:  # V
        p[:, :] = t[:8][None, :]
    elif mode == 1:  # H
        p[:, :] = l[:, None]
    elif mode == 3:  # DDL (8-95/96)
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    k = x + y
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == 4:  # DDR
        ref = np.concatenate([l[::-1], [q], t[:8]])  # 17 samples
        # p[y][x] = f(ref) along diagonals: index 8 + x - y is center
        for y in range(8):
            for x in range(8):
                i = 8 + x - y
                p[y, x] = (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2 \
                    if 0 < i < 16 else (ref[max(i - 1, 0)] + 2 * ref[i] +
                                        ref[min(i + 1, 16)] + 2) >> 2
    elif mode == 5:  # VR
        def tr(i):  # t index -1 means filtered tl
            return q if i < 0 else t[i]
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tr(i - 1) + tr(i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tr(i - 2) + 2 * tr(i - 1) + tr(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * q + t[0] + 2) >> 2
                else:
                    p[y, x] = (l[y - 2 * x - 1] + 2 * l[y - 2 * x - 2] +
                               (l[y - 2 * x - 3] if y - 2 * x - 3 >= 0 else q)
                               + 2) >> 2
    elif mode == 6:  # HD
        def lr(i):
            return q if i < 0 else l[i]
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (lr(i - 1) + lr(i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (lr(i - 2) + 2 * lr(i - 1) + lr(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * q + t[0] + 2) >> 2
                else:
                    p[y, x] = (t[x - 2 * y - 1] + 2 * t[x - 2 * y - 2] +
                               (t[x - 2 * y - 3] if x - 2 * y - 3 >= 0 else q)
                               + 2) >> 2
    elif mode == 7:  # VL
        for y in range(8):
            for x in range(8):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
    elif mode == 8:  # HU
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                i = y + (x >> 1)
                if z < 13 and z % 2 == 0:
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 13:
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    p[y, x] = l[7]
    else:
        raise ValueError(f"bad 8x8 mode {mode}")
    return np.clip(p, 0, 255).astype(np.uint8)


def wrap16(x):
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def _idct8_butterfly(m: np.ndarray) -> np.ndarray:
    """One 1-D pass of the 8x8 inverse transform over all 8 vectors at
    once (rows of m); int16 wrap after every op like the scalar code."""
    def W(a):
        return ((a + 0x8000) & 0xFFFF) - 0x8000
    p = [m[:, k] for k in range(8)]
    a0 = W(p[0] + p[4])
    a1 = W(p[0] - p[4])
    a2 = W(p[6] - (p[2] >> 1))
    a3 = W(p[2] + (p[6] >> 1))
    b0 = W(a0 + a3)
    b2 = W(a1 - a2)
    b4 = W(a1 + a2)
    b6 = W(a0 - a3)
    a0 = W(-p[3] + p[5] - p[7] - (p[7] >> 1))
    a1 = W(p[1] + p[7] - p[3] - (p[3] >> 1))
    a2 = W(-p[1] + p[7] + p[5] + (p[5] >> 1))
    a3 = W(p[3] + p[5] + p[1] + (p[1] >> 1))
    b1 = W(a0 + (a3 >> 2))
    b3 = W(a1 + (a2 >> 2))
    b5 = W(a2 - (a1 >> 2))
    b7 = W(a3 - (a0 >> 2))
    return np.stack([W(b0 + b7), W(b2 - b5), W(b4 + b3), W(b6 + b1),
                     W(b6 - b1), W(b4 - b3), W(b2 + b5), W(b0 - b7)], 1)


def idct8x8_add(pred: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """8x8 inverse transform + add (parity: IdctResAddPred8x8_c,
    decoder decode_mb_aux.cpp:80 — int16 intermediates wrap).
    Vectorized 1-D passes (the scalar loop measured ~140 us/block on
    High-profile 720p content)."""
    rs = coef.reshape(8, 8).astype(np.int64)
    tmp = _idct8_butterfly(rs)                 # row pass
    res = _idct8_butterfly(tmp.T)              # column pass
    out = pred.astype(np.int64) + ((32 + res.T) >> 6)
    return np.clip(out, 0, 255).astype(np.uint8)
