"""Numpy oracle for H.264 intra prediction (§8.3), all block sizes/modes.

Operates on single blocks given explicit neighbor sample arrays, exactly
following the spec's sample substitution and filtering rules.

Reference parity anchors: codec/decoder/core/src/get_intra_predictor.cpp
(WelsI4x4LumaPred*_c, WelsI16x16LumaPred*_c, WelsIChromaPred*_c,
WelsI8x8LumaPred*_c) — semantics only, implementation is array-based.

Conventions: `top` = p[x, -1] for x = 0..(2N-1) where available (len 2N for
4x4/8x8 luma with top-right extension), `left` = p[-1, y] y = 0..N-1,
`tl` = p[-1, -1]. Availability flags say which neighbor groups exist.

Copied from openh264_tpu/oracle/intra.py. The decoder's Python intra
recon (decoder/recon_oracle.py) uses it for the pictures that hold I8x8
MBs; every other picture's intra MBs run in host C.
"""

from __future__ import annotations

import numpy as np

# 4x4 / 8x8 luma intra modes
I_PRED_V, I_PRED_H, I_PRED_DC, I_PRED_DDL, I_PRED_DDR = 0, 1, 2, 3, 4
I_PRED_VR, I_PRED_HD, I_PRED_VL, I_PRED_HU = 5, 6, 7, 8
# 16x16 modes
I16_PRED_V, I16_PRED_H, I16_PRED_DC, I16_PRED_P = 0, 1, 2, 3
# chroma modes
C_PRED_DC, C_PRED_H, C_PRED_V, C_PRED_P = 0, 1, 2, 3


def predict_4x4(mode: int, top: np.ndarray, left: np.ndarray, tl: int,
                avail_top: bool, avail_left: bool, avail_tl: bool,
                avail_tr: bool) -> np.ndarray:
    """top: int array len 8 (x=0..7; x>=4 valid only if avail_tr, else
    caller may pass garbage — we substitute per spec), left: len 4.
    Returns uint8 [4,4] (row-major: [y][x])."""
    t = np.zeros(8, dtype=np.int32)
    l = np.zeros(4, dtype=np.int32)
    if avail_top:
        t[:4] = top[:4]
        if avail_tr:
            t[4:] = top[4:8]
        else:
            t[4:] = top[3]
    if avail_left:
        l[:] = left[:4]
    tl = int(tl)
    p = np.zeros((4, 4), dtype=np.int32)

    if mode == I_PRED_DC:
        if avail_top and avail_left:
            dc = (t[:4].sum() + l.sum() + 4) >> 3
        elif avail_left:
            dc = (l.sum() + 2) >> 2
        elif avail_top:
            dc = (t[:4].sum() + 2) >> 2
        else:
            dc = 128
        p[:, :] = dc
    elif mode == I_PRED_V:
        p[:, :] = t[:4][None, :]
    elif mode == I_PRED_H:
        p[:, :] = l[:, None]
    elif mode == I_PRED_DDL:
        # §8.3.1.2.4: p[y][x] = (t[x+y] + 2*t[x+y+1] + t[x+y+2] + 2) >> 2,
        # except p[3][3] = (t[6] + 3*t[7] + 2) >> 2
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == I_PRED_DDR:
        # §8.3.1.2.5 via the filtered diagonal reference line
        # ref = [l3, l2, l1, l0, tl, t0, t1, t2, t3]; p[y][x] = f[3 + x - y]
        ref = np.concatenate([l[::-1], [tl], t[0:4]]).astype(np.int32)
        f = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
        for y in range(4):
            for x in range(4):
                p[y, x] = f[3 + x - y]
    elif mode == I_PRED_VR:
        # §8.3.1.2.6; zVR = 2x - y
        def tref(i):
            return tl if i < 0 else t[i]
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tref(i - 1) + tref(i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tref(i - 2) + 2 * tref(i - 1) + tref(i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:  # z in {-2, -3}
                    p[y, x] = (l[y - 2 * x - 1] + 2 * l[y - 2 * x - 2]
                               + _lref(l, tl, y - 2 * x - 3) + 2) >> 2
    elif mode == I_PRED_HD:
        # §8.3.1.2.7; zHD = 2y - x
        def tref(i):
            return tl if i < 0 else t[i]
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (_lref(l, tl, i - 1) + _lref(l, tl, i) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (_lref(l, tl, i - 2) + 2 * _lref(l, tl, i - 1)
                               + _lref(l, tl, i) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:  # z in {-2, -3}
                    p[y, x] = (t[x - 2 * y - 1] + 2 * t[x - 2 * y - 2]
                               + tref(x - 2 * y - 3) + 2) >> 2
    elif mode == I_PRED_VL:
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    i = x + (y >> 1)
                    p[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    i = x + (y >> 1)
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
    elif mode == I_PRED_HU:
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 5 and z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif z < 5:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    else:
        raise ValueError(f"bad 4x4 intra mode {mode}")
    return np.clip(p, 0, 255).astype(np.uint8)


def _lref(l, tl, i):
    return tl if i < 0 else l[i]


def predict_16x16(mode: int, top: np.ndarray, left: np.ndarray, tl: int,
                  avail_top: bool, avail_left: bool) -> np.ndarray:
    p = np.zeros((16, 16), dtype=np.int32)
    t = np.asarray(top[:16], dtype=np.int32) if avail_top else None
    l = np.asarray(left[:16], dtype=np.int32) if avail_left else None
    if mode == I16_PRED_DC:
        if avail_top and avail_left:
            dc = (t.sum() + l.sum() + 16) >> 5
        elif avail_left:
            dc = (l.sum() + 8) >> 4
        elif avail_top:
            dc = (t.sum() + 8) >> 4
        else:
            dc = 128
        p[:, :] = dc
    elif mode == I16_PRED_V:
        p[:, :] = t[None, :]
    elif mode == I16_PRED_H:
        p[:, :] = l[:, None]
    elif mode == I16_PRED_P:
        h = sum((x + 1) * (int(t[8 + x]) - (int(t[6 - x]) if 6 - x >= 0 else int(tl)))
                for x in range(8))
        v = sum((y + 1) * (int(l[8 + y]) - (int(l[6 - y]) if 6 - y >= 0 else int(tl)))
                for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        for y in range(16):
            for x in range(16):
                p[y, x] = np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5, 0, 255)
    else:
        raise ValueError(f"bad 16x16 mode {mode}")
    return np.clip(p, 0, 255).astype(np.uint8)


def predict_chroma(mode: int, top: np.ndarray, left: np.ndarray, tl: int,
                   avail_top: bool, avail_left: bool) -> np.ndarray:
    """8x8 chroma prediction (4:2:0)."""
    p = np.zeros((8, 8), dtype=np.int32)
    t = np.asarray(top[:8], dtype=np.int32) if avail_top else None
    l = np.asarray(left[:8], dtype=np.int32) if avail_left else None
    if mode == C_PRED_DC:
        # per 4x4 quadrant with spec §8.3.4.1 rules
        for qy in range(2):
            for qx in range(2):
                ts = t[qx * 4:qx * 4 + 4] if avail_top else None
                ls = l[qy * 4:qy * 4 + 4] if avail_left else None
                if qx == qy:  # corner blocks use both when available
                    if avail_top and avail_left:
                        dc = (ts.sum() + ls.sum() + 4) >> 3
                    elif avail_top:
                        dc = (ts.sum() + 2) >> 2
                    elif avail_left:
                        dc = (ls.sum() + 2) >> 2
                    else:
                        dc = 128
                elif qx == 1:  # top-right quadrant prefers top
                    if avail_top:
                        dc = (ts.sum() + 2) >> 2
                    elif avail_left:
                        dc = (ls.sum() + 2) >> 2
                    else:
                        dc = 128
                else:  # bottom-left quadrant prefers left
                    if avail_left:
                        dc = (ls.sum() + 2) >> 2
                    elif avail_top:
                        dc = (ts.sum() + 2) >> 2
                    else:
                        dc = 128
                p[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = dc
    elif mode == C_PRED_H:
        p[:, :] = l[:, None]
    elif mode == C_PRED_V:
        p[:, :] = t[None, :]
    elif mode == C_PRED_P:
        h = sum((x + 1) * (int(t[4 + x]) - int(t[2 - x]) if 2 - x >= 0 else
                           int(t[4 + x]) - int(tl)) for x in range(4))
        v = sum((y + 1) * (int(l[4 + y]) - (int(l[2 - y]) if 2 - y >= 0 else int(tl)))
                for y in range(4))
        a = 16 * (int(l[7]) + int(t[7]))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        for y in range(8):
            for x in range(8):
                p[y, x] = np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5, 0, 255)
    else:
        raise ValueError(f"bad chroma mode {mode}")
    return np.clip(p, 0, 255).astype(np.uint8)
