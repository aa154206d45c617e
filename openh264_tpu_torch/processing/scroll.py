"""Scroll detection for screen content (METHOD_SCROLL_DETECTION).

Port of openh264_tpu/processing/scroll.py (detect_scroll), with the same
result on the same planes. Behavior parity: processing
ScrollDetectionFuncs.cpp ScrollDetectionCore:110. A high-variance test
row of the current frame and its +-CHECK_OFFSET neighbours are matched
exactly against every candidate window of the reference within
+-max_mv rows; the nearest hit (first by |offset|, then by offset
order) is the scroll vector.

The row statistics and the match of all candidate windows run on the
planes' device; the few numbers they give are fetched, and the pick is
made on the host with the reference's numpy arithmetic: the test row is
the first argmax of a float64 variance, a flat window (numpy std < 1) is
no evidence, and the hit is the first argmin of |offset|.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SCROLL_MV_Y = 255
CHECK_OFFSET = 4


def _row_variance_pick(cur) -> int:
    """The test row: the max-variance row in the middle half of the
    picture (scroll.py:_row_variance_pick). Row sums are exact int64 on
    the device; the float64 variance is formed on the host from them as
    numpy's mean forms it (an exact integer sum over a count)."""
    h, w = cur.shape
    lo, hi = h // 4, max(h // 4 + 1, 3 * h // 4)
    rows = cur[lo:hi].to(torch.int64)
    s = rows.sum(1).cpu().numpy().astype(np.float64)
    sq = (rows * rows).sum(1).cpu().numpy().astype(np.float64)
    var = sq / w - (s / w) ** 2
    return int(lo + var.argmax())


def detect_scroll(cur, ref, max_mv: int = MAX_SCROLL_MV_Y):
    """Returns (flag, mv_y). cur/ref: [H, W] uint8 luma tensors on one
    device."""
    h, w = cur.shape
    test = _row_variance_pick(cur)
    half = CHECK_OFFSET
    k = 2 * half + 1
    if test - half < 0 or test + half >= h:
        return False, 0
    offs = [o for o in range(-max_mv, max_mv + 1)
            if 0 <= test + o - half and test + o + half < h]
    if not offs:
        return False, 0
    cur_win = cur[test - half:test + half + 1]
    # row_eq[i, j]: current window row i equals reference row j
    row_eq = (cur_win[:, None, :] == ref[None, :, :]).all(-1)      # [k, h]
    starts = torch.tensor([test + o - half for o in offs], device=cur.device)
    idx = starts[:, None] + torch.arange(k, device=cur.device)[None, :]
    eq = row_eq[torch.arange(k, device=cur.device)[None, :], idx].all(1)
    eq = eq.cpu().numpy()
    if not eq.any():
        return False, 0
    # a flat window matches everywhere: not evidence of scrolling
    if cur_win.cpu().numpy().std() < 1.0:
        return False, 0
    hits = np.asarray(offs)[eq]
    return True, int(hits[np.abs(hits).argmin()])
