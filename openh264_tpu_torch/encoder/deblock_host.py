"""In-loop deblocking of the host encoder's frames through the port's
deblock kernel.

Does what openh264_tpu/oracle/deblock.py::deblock_frame does for the
FrameSymbols that H264Encoder builds (:178-277), in the kernel's inputs:
- bS from oracle.deblock_bs.precompute_bs, in the [4*mb_h, 4*mb_w]
  layout of BSV/BSH;
- the edges that the oracle skips outside the bS values are zeroed: an
  MB's left (top) MB edge where its disable_deblock is 2 and that
  neighbour lies in another slice (deblock.py:202-207), and every edge
  of an MB whose disable_deblock is 1;
- qp_mb is the MB's QP, cqp_mb its chroma QP CHROMA_QP_TABLE[qp + 0]:
  the encoder's FrameSymbols carry no chroma QP offsets, so the oracle
  deblocks chroma with offset 0 whatever the config says.
The kernel averages the QPs of the two MBs on an MB edge and uses alpha
and beta offsets 0, as the oracle does with the encoder's symbols (their
offsets are 0; anything else is refused here).

A CUDA plane goes to the Hopper kernel (deblock_cuda.deblock_frame_cuda),
a CPU plane to its plain version (deblock_torch.deblock_frame_device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.deblock_bs import precompute_bs
from ..tables import CHROMA_QP_TABLE
from .deblock_torch import deblock_frame_auto


def deblock_inputs(fs):
    """(BSV, BSH, qp_mb, cqp_mb) as numpy int32 for one frame's
    FrameSymbols, with the oracle's skipped edges zeroed."""
    if fs.alpha_offset.any() or fs.beta_offset.any():
        raise ValueError("the deblock kernel takes alpha/beta offsets 0")
    if fs.transform8.any() or (fs.mb_type < 0).any() or \
            not fs.mb_correct.all():
        raise ValueError("the host encoder's frames have no 8x8 transform, "
                         "missing or concealed MBs")
    mb_w, mb_h = fs.mb_w, fs.mb_h
    BSV, BSH = precompute_bs(fs)
    BSV = BSV.astype(np.int32)
    BSH = BSH.astype(np.int32)
    dd = fs.disable_deblock.reshape(mb_h, mb_w)
    sid = fs.slice_id.reshape(mb_h, mb_w)
    # slice-edge rule of deblock_idc 2: the MB's own left / top edge
    cut_left = np.zeros((mb_h, mb_w), bool)
    cut_left[:, 1:] = (dd[:, 1:] == 2) & (sid[:, 1:] != sid[:, :-1])
    cut_top = np.zeros((mb_h, mb_w), bool)
    cut_top[1:, :] = (dd[1:, :] == 2) & (sid[1:, :] != sid[:-1, :])
    BSV[:, 0::4][np.repeat(cut_left, 4, 0)] = 0
    BSH[0::4, :][np.repeat(cut_top, 4, 1)] = 0
    # disable_deblock 1: none of the MB's own edges
    off = np.repeat(np.repeat(dd == 1, 4, 0), 4, 1)
    BSV[off] = 0
    BSH[off] = 0
    qp = fs.qp.astype(np.int32)
    cqp = CHROMA_QP_TABLE[np.clip(qp, 0, 51)].astype(np.int32)
    return BSV, BSH, qp, cqp


def deblock_frame(y, u, v, fs):
    """Deblocks one frame's recon planes (uint8 tensors on one device,
    MB aligned) as the oracle does for `fs`; returns the filtered
    (y, u, v). On CUDA the kernel filters y/u/v in place."""
    dev = y.device
    BSV, BSH, qp, cqp = (torch.from_numpy(a).to(dev)
                         for a in deblock_inputs(fs))
    return deblock_frame_auto(y, u, v, BSV, BSH, qp, cqp, fs.mb_w, fs.mb_h)
