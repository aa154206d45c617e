"""Background detection (METHOD_BACKGROUND_DETECTION) in PyTorch.

Port of openh264_tpu/processing/background.py (background_division),
byte-identical with it. Behavior parity: processing
BackgroundDetection.cpp ForegroundBackgroundDivision:157 (per-16x16 OU
classification from VAA 8x8 stats), ForegroundDilation:268 /
BackgroundErosion:292 refinement.

As in the JAX version, the dilation/erosion is one functional step over
the phase-1 flags (the reference mutates flags in raster order, so each
OU reads already-refined left/top neighbours). The flags are int32 0/1,
and dil23 stays a bool tensor, so ~dil23 is a logical not.

Thresholds (BackgroundDetection.h:37-46): OU=16x16, THD_SAD=512,
Q_FACTOR=8, MAD limit 63.
"""

from __future__ import annotations

import torch

I32 = torch.int32

BGD_OU_SIZE = 16
Q_FACTOR = 8
BGD_THD_SAD = 2 * BGD_OU_SIZE * BGD_OU_SIZE  # 512


def _nbr(x, dy, dx, fill):
    """Shifted OU-grid view with constant fill at the border: a pad, a
    roll and a crop, as in the JAX version."""
    h, w = x.shape
    p = torch.full((h + 2, w + 2), fill, dtype=x.dtype, device=x.device)
    p[1:-1, 1:-1] = x
    return torch.roll(p, (-dy, -dx), (0, 1))[1:-1, 1:-1]


def background_division(vaa):
    """Classify each OU (=MB) as background from VAA stats.

    Args: vaa dict from processing.vaa.vaa_calc (sad8x8/sd8x8/mad8x8
    as [mh, mw, 4] int32 tensors).
    Returns: dict of int32 tensors on their device: 'flag' [mh,mw]
    (1=background), plus the per-OU sad/sd/mad/min_sub_mad/
    max_diff_sub_sd aggregates.
    """
    sad8 = vaa["sad8x8"]
    sd8 = vaa["sd8x8"]
    mad8 = vaa["mad8x8"]
    sad = sad8.sum(-1, dtype=I32)
    sd = sd8.sum(-1, dtype=I32).abs()
    mad = mad8.amax(-1)
    min_sub_mad = mad8.amin(-1)
    max_diff_sub_sd = sd8.amax(-1) - sd8.amin(-1)

    # --- phase 1: division (exact parity with the C) -------------------
    quiet = ((max_diff_sub_sd <= (sad >> 3))
             | (max_diff_sub_sd <= BGD_OU_SIZE * Q_FACTOR)) & \
        (sad < (BGD_THD_SAD << 1))
    tiny = sad <= BGD_OU_SIZE * Q_FACTOR
    sd_ok = torch.where(sad < BGD_THD_SAD,
                        sd < ((sad * 3) >> 2),
                        (sd << 1) < sad)
    flag = ((mad <= 63) & quiet & (tiny | sd_ok)).to(I32)

    # --- phase 2: one functional dilation/erosion step ------------------
    fl = _nbr(flag, 0, -1, 0)
    fr = _nbr(flag, 0, 1, 0)
    fu = _nbr(flag, -1, 0, 0)
    fd = _nbr(flag, 1, 0, 0)
    nsum = fl + fr + fu + fd
    madl = _nbr(mad, 0, -1, 0)
    madr = _nbr(mad, 0, 1, 0)
    madu = _nbr(mad, -1, 0, 0)
    madd = _nbr(mad, 1, 0, 0)

    def fg_mad(f, m):
        return torch.where(f == 0, m, 0)

    def bg_mad(f, m):
        return torch.where(f == 1, m, 0)

    max_fg = torch.maximum(torch.maximum(fg_mad(fl, madl), fg_mad(fr, madr)),
                           torch.maximum(fg_mad(fu, madu), fg_mad(fd, madd)))
    max_bg = torch.maximum(torch.maximum(bg_mad(fl, madl), bg_mad(fr, madr)),
                           torch.maximum(bg_mad(fu, madu), bg_mad(fd, madd)))
    # ForegroundDilation23Luma: promote to foreground when the texture
    # gradient points at a foreground neighbor
    dil23 = (mad > (min_sub_mad << 1)) & \
        ((max_fg > (min_sub_mad << 2))
         | ((mad > (max_bg << 1)) & (mad <= (max_fg * 3) >> 1)))
    active = sad > BGD_OU_SIZE * Q_FACTOR
    flag2 = torch.where(active & (nsum <= 1), 0,
                        torch.where(active & (nsum <= 3), (~dil23).to(I32),
                                    flag))
    # BackgroundErosion: re-mark quiet OUs surrounded by background
    sadl = _nbr(sad, 0, -1, 0)
    sadr = _nbr(sad, 0, 1, 0)
    sadu = _nbr(sad, -1, 0, 0)
    sadd = _nbr(sad, 1, 0, 0)
    nbr_bg_sad = fl * sadl + fr * sadr + fu * sadu + fd * sadd
    erod_ok = (max_diff_sub_sd <= BGD_OU_SIZE * Q_FACTOR) & \
        (sad * nsum <= (3 * nbr_bg_sad) >> 1)
    erode = erod_ok & ((nsum == 4)
                       | (((fl & fr) | (fu & fd)).bool() & ~dil23))
    flag2 = torch.where((flag == 0) & erode, 1, flag2)

    return {"flag": flag2, "sad": sad, "sd": sd, "mad": mad,
            "min_sub_mad": min_sub_mad, "max_diff_sub_sd": max_diff_sub_sd}
