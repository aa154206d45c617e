"""The decoded picture's planes while the decoder reconstructs them, and
the per-MB Python intra recon of the pictures that hold I8x8 MBs.

Port of openh264_tpu/decoder/recon_oracle.py: ReconState, whose planes
here are uint8 tensors on the decoder's device, and _intra_avail,
recon_intra_mb and _block_tr_avail (:33-45, :203-320), copied. The JAX
batched recon (recon_batch.py:221-228, native/__init__.py:257-266)
sends the intra MBs of a picture to host C unless one of them is I8x8,
and then sends all of them, in raster order, to recon_intra_mb; the
port does the same (recon_batch.recon_frame_batch). recon_intra_mb runs
on host numpy planes (HostPlanes), which come from the device once and
go back once per picture. It uses the numpy intra predictors of
oracle/intra.py and oracle/intra8.py and the numpy 4x4 inverse
transform idct4x4_add (copied from openh264_tpu/oracle/transform.py:93).
Parity: rec_mb.cpp RecI16x16Mb:179 / RecI4x4Mb:117 / RecChroma:1057,
decode_slice.cpp:334 WelsTargetMbConstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle import intra as oi
from ..oracle.intra8 import idct8x8_add, predict_8x8
from .dequant import wrap_i16
from .framedata import (FrameSymbols, INTRA_CLASSES, MB_I4x4, MB_I16x16,
                        MB_I8x8, MB_IPCM, RASTER_TO_ZSCAN, ZSCAN_TO_RASTER)


class ReconState:
    """Decoded picture planes (uint8 tensors on `device`, zero-filled,
    MB aligned) of the frame `fs` describes."""

    def __init__(self, fs: FrameSymbols, device: torch.device):
        self.fs = fs
        self.w = fs.mb_w * 16
        self.h = fs.mb_h * 16
        u8 = torch.uint8
        self.y = torch.zeros((self.h, self.w), dtype=u8, device=device)
        self.u = torch.zeros((self.h // 2, self.w // 2), dtype=u8,
                             device=device)
        self.v = torch.zeros((self.h // 2, self.w // 2), dtype=u8,
                             device=device)


class HostPlanes:
    """The planes of a picture as host numpy arrays (y, u, v, MB aligned,
    written in place), with the FrameSymbols that recon_intra_mb reads."""

    def __init__(self, fs: FrameSymbols, y, u, v):
        self.fs = fs
        self.w = y.shape[1]
        self.y, self.u, self.v = y, u, v


def idct4x4_add(pred: np.ndarray, coef: np.ndarray) -> np.ndarray:
    """Inverse 4x4 transform + add to prediction, clip to [0,255]: the
    horizontal pass stored int16 (wraps), the vertical pass in int32 with
    (x+32)>>6 rounding. pred: [...,4,4] uint8, coef: [...,4,4] int
    (dequantised). Returns uint8."""
    c = coef.astype(np.int32)
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    t0 = c0 + c2
    t1 = c0 - c2
    t2 = (c1 >> 1) - c3
    t3 = c1 + (c3 >> 1)
    h = wrap_i16(np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=-1))
    h0, h1, h2, h3 = h[..., 0, :], h[..., 1, :], h[..., 2, :], h[..., 3, :]
    t0 = h0 + h2
    t1 = h0 - h2
    t2 = (h1 >> 1) - h3
    t3 = h1 + (h3 >> 1)
    r = np.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], axis=-2)
    out = pred.astype(np.int32) + ((r + 32) >> 6)
    return np.clip(out, 0, 255).astype(np.uint8)


def _intra_avail(fs: FrameSymbols, cur_idx: int, mbx: int, mby: int,
                 constrained: bool) -> bool:
    """Is MB (mbx,mby) available for intra prediction from MB cur_idx?"""
    if mbx < 0 or mby < 0 or mbx >= fs.mb_w or mby >= fs.mb_h:
        return False
    idx = mby * fs.mb_w + mbx
    if fs.slice_id[idx] != fs.slice_id[cur_idx]:
        return False
    if constrained and fs.mb_type[idx] not in INTRA_CLASSES:
        return False
    return True


def recon_intra_mb(st: HostPlanes, idx: int, constrained: bool) -> None:
    """Intra prediction + residual of MB `idx` into st's host planes,
    from the samples its neighbours already hold."""
    fs = st.fs
    mbx, mby = idx % fs.mb_w, idx // fs.mb_w
    x0, y0 = mbx * 16, mby * 16
    t = fs.mb_type[idx]
    if t == MB_IPCM:
        y, u, v = fs.ipcm[idx]
        st.y[y0:y0 + 16, x0:x0 + 16] = y
        st.u[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = u
        st.v[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = v
        return

    al = _intra_avail(fs, idx, mbx - 1, mby, constrained)
    at = _intra_avail(fs, idx, mbx, mby - 1, constrained)
    atl = _intra_avail(fs, idx, mbx - 1, mby - 1, constrained)
    atr = _intra_avail(fs, idx, mbx + 1, mby - 1, constrained)

    if t == MB_I16x16:
        top = st.y[y0 - 1, x0:x0 + 16].astype(np.int32) if at else np.zeros(16, np.int32)
        left = st.y[y0:y0 + 16, x0 - 1].astype(np.int32) if al else np.zeros(16, np.int32)
        tl = int(st.y[y0 - 1, x0 - 1]) if atl else 0
        pred = oi.predict_16x16(int(fs.i16_mode[idx]), top, left, tl, at, al)
        # add residual: all 16 blocks in ONE batched IDCT call
        coefs = fs.coeffs_l[idx].reshape(4, 4, 4, 4)         # [by,bx,4,4]
        pb = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)  # [by,bx,4,4]
        rec = idct4x4_add(pb, coefs)
        st.y[y0:y0 + 16, x0:x0 + 16] = \
            rec.transpose(0, 2, 1, 3).reshape(16, 16)
    elif t == MB_I8x8:
        fs.ensure_coeffs8()
        for blk8 in range(4):
            b8x, b8y = blk8 % 2, blk8 // 2
            gx, gy = x0 + b8x * 8, y0 + b8y * 8
            b_at = (b8y > 0) or at
            b_al = (b8x > 0) or al
            if blk8 == 0:
                b_atl, b_atr = atl, at
            elif blk8 == 1:
                b_atl, b_atr = at, atr
            elif blk8 == 2:
                b_atl, b_atr = al, True
            else:
                b_atl, b_atr = True, False
            top = np.zeros(16, np.int32)
            if b_at:
                end = min(gx + 16, st.w)
                seg = st.y[gy - 1, gx:end].astype(np.int32)
                top[:len(seg)] = seg
                if len(seg) < 16:
                    top[len(seg):] = seg[-1]
            left = st.y[gy:gy + 8, gx - 1].astype(np.int32) if b_al else np.zeros(8, np.int32)
            tl = int(st.y[gy - 1, gx - 1]) if b_atl else 0
            mode = int(fs.i4_modes[idx, (b8y * 2) * 4 + b8x * 2])
            pred = predict_8x8(mode, top, left, tl, b_at, b_al, b_atl, b_atr)
            coef = fs.coeffs8[idx, blk8]
            if np.any(coef):
                st.y[gy:gy + 8, gx:gx + 8] = idct8x8_add(pred, coef)
            else:
                st.y[gy:gy + 8, gx:gx + 8] = pred
    elif t == MB_I4x4:
        for k in range(16):
            raster = int(ZSCAN_TO_RASTER[k])
            bx, by = raster % 4, raster // 4
            gx, gy = x0 + bx * 4, y0 + by * 4
            # per-block availability
            b_al = (bx > 0) or al
            b_at = (by > 0) or at
            b_atl = (bx > 0 and by > 0) or (bx > 0 and at) or (by > 0 and al) or atl
            # top-right: available if the block above-right is decoded
            # earlier in decode order and its MB is available
            b_atr = _block_tr_avail(fs, idx, mbx, mby, bx, by, k, at, atr,
                                    constrained)
            top = st.y[gy - 1, gx:gx + 8].astype(np.int32) if b_at else np.zeros(8, np.int32)
            if b_at and gx + 8 > st.w:
                top = np.concatenate([st.y[gy - 1, gx:st.w].astype(np.int32),
                                      np.full(gx + 8 - st.w, st.y[gy - 1, st.w - 1], np.int32)])
            left = st.y[gy:gy + 4, gx - 1].astype(np.int32) if b_al else np.zeros(4, np.int32)
            tl = int(st.y[gy - 1, gx - 1]) if b_atl else 0
            mode = int(fs.i4_modes[idx, raster])
            pred = oi.predict_4x4(mode, top, left, tl, b_at, b_al, b_atl, b_atr)
            coef = fs.coeffs_l[idx, raster].reshape(4, 4)
            st.y[gy:gy + 4, gx:gx + 4] = idct4x4_add(pred, coef)

    # chroma
    cx0, cy0 = x0 // 2, y0 // 2
    ctop = st.u[cy0 - 1, cx0:cx0 + 8].astype(np.int32) if at else np.zeros(8, np.int32)
    cleft = st.u[cy0:cy0 + 8, cx0 - 1].astype(np.int32) if al else np.zeros(8, np.int32)
    for comp, plane in ((0, st.u), (1, st.v)):
        top = plane[cy0 - 1, cx0:cx0 + 8].astype(np.int32) if at else np.zeros(8, np.int32)
        left = plane[cy0:cy0 + 8, cx0 - 1].astype(np.int32) if al else np.zeros(8, np.int32)
        tl = int(plane[cy0 - 1, cx0 - 1]) if atl else 0
        pred = oi.predict_chroma(int(fs.chroma_mode[idx]), top, left, tl, at, al)
        for blk in range(4):
            bx, by = blk % 2, blk // 2
            p = pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            coef = fs.coeffs_c[idx, comp, blk].reshape(4, 4)
            plane[cy0 + by * 4:cy0 + by * 4 + 4, cx0 + bx * 4:cx0 + bx * 4 + 4] = \
                idct4x4_add(p, coef)


def _block_tr_avail(fs, idx, mbx, mby, bx, by, zscan_k, at, atr, constrained):
    """Top-right availability for 4x4 block (bx,by) in MB (mbx,mby),
    decoded as the zscan_k-th block (§6.4.11.4 via decode order)."""
    gx, gy = mbx * 4 + bx, mby * 4 + by
    tx, ty = gx + 1, gy - 1
    if ty < 0 or tx >= fs.mb_w * 4:
        return False
    if by == 0:
        # neighbor is in the MB row above: top MB (same column) if bx<3,
        # else the top-right MB
        return at if bx < 3 else atr
    # same MB: the block at (bx+1, by-1) must come earlier in zscan order
    if bx == 3:
        return False  # would be in MB to the right (not yet decoded)
    neighbor_raster = (by - 1) * 4 + (bx + 1)
    return int(RASTER_TO_ZSCAN[neighbor_raster]) < zscan_k
