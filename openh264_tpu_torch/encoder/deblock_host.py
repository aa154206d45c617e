"""In-loop deblocking of the host encoder's and the decoder's frames
through the port's deblock kernel.

Does what openh264_tpu/oracle/deblock.py::deblock_frame does for a
frame's FrameSymbols (:178-277), in the kernel's inputs:
- bS from oracle.deblock_bs.precompute_bs, in the [4*mb_h, 4*mb_w]
  layout of BSV/BSH;
- the edges that the oracle skips outside the bS values are zeroed:
  every edge of an MB that was not decoded (mb_type < 0) or not
  correctly (mb_correct false: error concealment fills it after the
  deblock), and of an MB whose disable_deblock is 1; an MB's left (top)
  MB edge where that neighbour was not decoded correctly, or where its
  disable_deblock is 2 and the neighbour lies in another slice
  (deblock.py:190-210);
- qp_mb is the MB's QP; cqp_mb its chroma QPs, CHROMA_QP_TABLE[qp + o]
  for the frame's Cb and Cr offsets o (fs.chroma_qp_offsets, set by the
  decoder's parser from the PPS; the encoder's FrameSymbols carry none,
  so it deblocks chroma with offset 0 whatever its config says, as the
  oracle does with them); one row when both offsets are equal, else
  [2, n] (deblock.py:255-260);
- the per-MB alpha/beta filter offsets of the MB's slice, or None where
  they are all 0 (deblock.py:235-237, :261-263);
- an 8x8-transform MB (fs.transform8) has no interior 4-sample luma
  edges: its BSV columns 1 and 3 and BSH rows 1 and 3 are zeroed, the
  edges the oracle skips (deblock.py:214-216). Chroma edges follow luma
  edges 0 and 2 only (:251-254), so chroma is untouched, and the kernel
  needs no change.

A CUDA plane goes to the Hopper kernel (deblock_cuda.deblock_frame_cuda),
a CPU plane to its plain version (deblock_torch.deblock_frame_device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.deblock_bs import precompute_bs
from ..tables import CHROMA_QP_TABLE
from ..utils import trace
from .deblock_torch import deblock_frame_auto


def deblock_inputs(fs):
    """(BSV, BSH, qp_mb, cqp_mb, alpha_off, beta_off) as numpy int32 for
    one frame's FrameSymbols, with the oracle's skipped edges zeroed;
    cqp_mb is [n] or [2, n], and each offset None when all zero."""
    mb_w, mb_h = fs.mb_w, fs.mb_h
    BSV, BSH = precompute_bs(fs)
    BSV = BSV.astype(np.int32)
    BSH = BSH.astype(np.int32)
    dd = fs.disable_deblock.reshape(mb_h, mb_w)
    sid = fs.slice_id.reshape(mb_h, mb_w)
    ok = (fs.mb_correct & (fs.mb_type >= 0)).reshape(mb_h, mb_w)
    # the MB's own left / top edge: a neighbour not decoded correctly, or
    # the slice-edge rule of deblock_idc 2
    cut_left = np.zeros((mb_h, mb_w), bool)
    cut_left[:, 1:] = ((dd[:, 1:] == 2) & (sid[:, 1:] != sid[:, :-1])) | \
        ~fs.mb_correct.reshape(mb_h, mb_w)[:, :-1]
    cut_top = np.zeros((mb_h, mb_w), bool)
    cut_top[1:, :] = ((dd[1:, :] == 2) & (sid[1:, :] != sid[:-1, :])) | \
        ~fs.mb_correct.reshape(mb_h, mb_w)[:-1, :]
    BSV[:, 0::4][np.repeat(cut_left, 4, 0)] = 0
    BSH[0::4, :][np.repeat(cut_top, 4, 1)] = 0
    # none of the MB's own edges: disable_deblock 1, or the MB missing
    off = np.repeat(np.repeat((dd == 1) | ~ok, 4, 0), 4, 1)
    BSV[off] = 0
    BSH[off] = 0
    # no interior 4-sample luma edges (1 and 3) in an 8x8-transform MB
    t8 = np.repeat(np.repeat(fs.transform8.reshape(mb_h, mb_w), 4, 0), 4, 1)
    BSV[t8 & (np.arange(4 * mb_w) % 2 == 1)[None, :]] = 0
    BSH[t8 & (np.arange(4 * mb_h) % 2 == 1)[:, None]] = 0
    qp = fs.qp.astype(np.int32)
    offs = getattr(fs, "chroma_qp_offsets", (0, 0))
    cqp = np.stack([CHROMA_QP_TABLE[np.clip(qp + o, 0, 51)]
                    for o in offs]).astype(np.int32)
    if offs[0] == offs[1]:
        cqp = cqp[0]
    ao, bo = (None if not a.any() else a.astype(np.int32)
              for a in (fs.alpha_offset, fs.beta_offset))
    return BSV, BSH, qp, cqp, ao, bo


def deblock_frame(y, u, v, fs):
    """Deblocks one frame's recon planes (uint8 tensors on one device,
    MB aligned) as the oracle does for `fs`; returns the filtered
    (y, u, v). On CUDA the kernel filters y/u/v in place."""
    dev = y.device
    with trace.span("deblock.bs"):
        inputs = deblock_inputs(fs)
    with trace.span("deblock.kernel"):
        BSV, BSH, qp, cqp, ao, bo = (None if a is None else
                                     torch.from_numpy(a).to(dev)
                                     for a in inputs)
        return deblock_frame_auto(y, u, v, BSV, BSH, qp, cqp, fs.mb_w,
                                  fs.mb_h, ao, bo)
