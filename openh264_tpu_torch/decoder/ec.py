"""Decoder error concealment (reference error_concealment.cpp).

Implements the 8 ERROR_CON_IDC modes' fill strategies over the decoded
picture planes. The output-gating consequences (EC'd pictures are not
emitted by the no-delay console flow — their construction happens inside
a data call whose SBufferInfo the follow-up flush call memsets,
welsDecoderExt.cpp DecodeFrameNoDelay:695-733) are handled by the
session in decoder.py; this module only fills pixels.

Copied from openh264_tpu/decoder/ec.py. It runs on the host numpy
planes that the decoder fetched after the deblock; the decoder then
refreshes the picture's device planes from them. The MV-copy modes'
motion compensation of each missing MB is the batched MC of
ops/recon_torch.py on 4x4 blocks, run on the CPU: the filters are
position-local, so sixteen 4x4 luma and four 2x2 chroma blocks with the
MB's vector give the bytes of one 16x16 / 8x8 block (the JAX module's
oracle/mc.py mc_luma / mc_chroma).
"""

from __future__ import annotations

import numpy as np
import torch

ERROR_CON_DISABLE = 0
ERROR_CON_FRAME_COPY = 1
ERROR_CON_SLICE_COPY = 2
ERROR_CON_FRAME_COPY_CROSS_IDR = 3
ERROR_CON_SLICE_COPY_CROSS_IDR = 4
ERROR_CON_SLICE_COPY_CROSS_IDR_FREEZE_RES_CHANGE = 5
ERROR_CON_SLICE_MV_COPY_CROSS_IDR = 6
ERROR_CON_SLICE_MV_COPY_CROSS_IDR_FREEZE_RES_CHANGE = 7

_FRAME_COPY_MODES = (ERROR_CON_FRAME_COPY, ERROR_CON_FRAME_COPY_CROSS_IDR)
_SLICE_COPY_MODES = (ERROR_CON_SLICE_COPY, ERROR_CON_SLICE_COPY_CROSS_IDR,
                     ERROR_CON_SLICE_COPY_CROSS_IDR_FREEZE_RES_CHANGE)
_MV_COPY_MODES = (ERROR_CON_SLICE_MV_COPY_CROSS_IDR,
                  ERROR_CON_SLICE_MV_COPY_CROSS_IDR_FREEZE_RES_CHANGE)


def implement_error_con(mode: int, st, fs, mb_correct: np.ndarray,
                        prev_pic, is_idr: bool, ref_list0=None,
                        cur_poc: int = 0) -> None:
    """Fill the un-decoded MBs of st (host numpy planes y, u, v) in
    place.

    prev_pic: pPreviousDecodedPictureInDpb analog (last constructed
    picture of matching size, EC'd or not, output or not; a dpb.Picture
    whose `host` planes are read) or None.
    """
    if mode == ERROR_CON_DISABLE:
        return
    src = None if prev_pic is None else _HostPic(prev_pic)
    # no cross-IDR: an IDR must not conceal from the previous sequence
    if is_idr and mode in (ERROR_CON_FRAME_COPY, ERROR_CON_SLICE_COPY):
        src = None
    if src is not None and src.y.shape != st.y.shape:
        src = None
    if mode in _FRAME_COPY_MODES:
        if src is None:
            st.y[:] = 128
            st.u[:] = 128
            st.v[:] = 128
        else:
            st.y[:] = src.y
            st.u[:] = src.u
            st.v[:] = src.v
        return
    if mode in _MV_COPY_MODES:
        _slice_mv_copy(st, fs, mb_correct, src, is_idr, ref_list0, cur_poc)
        return
    # slice-copy family: co-located MB copy for each missing MB
    bad = ~mb_correct.reshape(fs.mb_h, fs.mb_w)
    for mby, mbx in zip(*np.nonzero(bad)):
        y0, x0 = mby * 16, mbx * 16
        c0, d0 = mby * 8, mbx * 8
        if src is None:
            st.y[y0:y0 + 16, x0:x0 + 16] = 128
            st.u[c0:c0 + 8, d0:d0 + 8] = 128
            st.v[c0:c0 + 8, d0:d0 + 8] = 128
        else:
            st.y[y0:y0 + 16, x0:x0 + 16] = src.y[y0:y0 + 16, x0:x0 + 16]
            st.u[c0:c0 + 8, d0:d0 + 8] = src.u[c0:c0 + 8, d0:d0 + 8]
            st.v[c0:c0 + 8, d0:d0 + 8] = src.v[c0:c0 + 8, d0:d0 + 8]


class _HostPic:
    """A picture's host planes and POC, as the JAX module reads them."""

    def __init__(self, pic):
        self.y, self.u, self.v = pic.host
        self.poc = pic.poc


def _mc_mb(src, x0, y0, mx, my):
    """The 16x16 luma and two 8x8 chroma predictions of the MB at pixel
    (x0, y0) from src's planes with quarter-pel vector (mx, my)."""
    from ..ops.recon_torch import mc_chroma, mc_luma
    i32 = torch.int32
    k = torch.arange(16, dtype=i32)
    bx, by = k % 4, k // 4
    mvx = torch.full((16,), mx, dtype=i32)
    mvy = torch.full((16,), my, dtype=i32)
    ly = mc_luma(torch.from_numpy(src.y), x0 + 4 * bx, y0 + 4 * by, mvx,
                 mvy)
    luma = ly.reshape(4, 4, 4, 4).permute(0, 2, 1, 3).reshape(16, 16)
    chroma = []
    for p in (src.u, src.v):
        c = mc_chroma(torch.from_numpy(p), x0 // 2 + 2 * bx,
                      y0 // 2 + 2 * by, mvx, mvy)
        chroma.append(c.reshape(4, 4, 2, 2).permute(0, 2, 1, 3).reshape(
            8, 8).numpy())
    return luma.numpy(), chroma[0], chroma[1]


def _slice_mv_copy(st, fs, mb_correct, src, is_idr, ref_list0, cur_poc):
    """SLICE_MV_COPY (error_concealment.cpp:379 DoErrorConSliceMVCopy +
    :262 GetAvilInfoFromCorrectMb): average the L0 MVs of correctly
    decoded inter MBs per ref idx, then MC missing MBs with that MV."""
    from .framedata import INTRA_CLASSES

    bad = ~mb_correct.reshape(fs.mb_h, fs.mb_w)
    if not bad.any():
        return
    if src is None:
        for mby, mbx in zip(*np.nonzero(bad)):
            y0, x0 = mby * 16, mbx * 16
            c0, d0 = mby * 8, mbx * 8
            st.y[y0:y0 + 16, x0:x0 + 16] = 128
            st.u[c0:c0 + 8, d0:d0 + 8] = 128
            st.v[c0:c0 + 8, d0:d0 + 8] = 128
        return
    # accumulate per-refidx average MV over correct inter MBs (L0 only)
    mv_sum = np.zeros((16, 2), np.int64)
    mv_n = np.zeros(16, np.int64)
    ec_ref_poc = {}
    for idx in range(fs.n_mb):
        if not mb_correct[idx]:
            continue
        t = int(fs.mb_type[idx])
        if t < 0 or t in INTRA_CLASSES:
            continue
        for q in range(4):
            r = int(fs.refidx[idx, 0, q])
            if r < 0 or r >= 16:
                continue
            blk = (q // 2) * 8 + (q % 2) * 2
            mv_sum[r] += fs.mv[idx, 0, blk]
            mv_n[r] += 1
            if ref_list0 is not None and r < len(ref_list0):
                ec_ref_poc[r] = ref_list0[r].poc
    use_r = next(iter(ec_ref_poc)) if ec_ref_poc else -1
    if is_idr or use_r < 0:
        # plain co-located copy
        for mby, mbx in zip(*np.nonzero(bad)):
            y0, x0 = mby * 16, mbx * 16
            c0, d0 = mby * 8, mbx * 8
            st.y[y0:y0 + 16, x0:x0 + 16] = src.y[y0:y0 + 16, x0:x0 + 16]
            st.u[c0:c0 + 8, d0:d0 + 8] = src.u[c0:c0 + 8, d0:d0 + 8]
            st.v[c0:c0 + 8, d0:d0 + 8] = src.v[c0:c0 + 8, d0:d0 + 8]
        return
    mvx = int(mv_sum[use_r, 0] // mv_n[use_r]) if mv_n[use_r] else 0
    mvy = int(mv_sum[use_r, 1] // mv_n[use_r]) if mv_n[use_r] else 0
    # scale the averaged MV to the concealment source (the previously
    # decoded picture) by POC distance (DoMbECMvCopy:214-217)
    p0 = ec_ref_poc[use_r]
    sc0 = p0 - cur_poc
    sc1 = getattr(src, "poc", 0) - cur_poc
    if sc0 != 0:
        mvx = int(mvx * sc1 / sc0)
        mvy = int(mvy * sc1 / sc0)
    else:
        mvx = mvy = 0
    H, W = st.y.shape
    for mby, mbx in zip(*np.nonzero(bad)):
        y0, x0 = int(mby) * 16, int(mbx) * 16
        c0, d0 = int(mby) * 8, int(mbx) * 8
        # clip the full-pel/subpel position like DoMbECMvCopy:222-256
        fx = (x0 << 2) + mvx
        fy = (y0 << 2) + mvy
        if fx < (0 + 2) * 4:
            fx = max(0, (fx >> 2) * 4)
        elif fx > (W - 18) * 4:
            fx = min((W - 16) * 4, (fx >> 2) * 4)
        if fy < (0 + 2) * 4:
            fy = max(0, (fy >> 2) * 4)
        elif fy > (H - 18) * 4:
            fy = min((H - 16) * 4, (fy >> 2) * 4)
        mx, my = fx - (x0 << 2), fy - (y0 << 2)
        (st.y[y0:y0 + 16, x0:x0 + 16], st.u[c0:c0 + 8, d0:d0 + 8],
         st.v[c0:c0 + 8, d0:d0 + 8]) = _mc_mb(src, x0, y0, mx, my)
