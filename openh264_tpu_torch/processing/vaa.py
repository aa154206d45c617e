"""VAA (visual analysis array) statistics in PyTorch.

Port of openh264_tpu/processing/vaa.py (vaa_calc), bit-exact with it.
Behavior parity: processing vaacalcfuncs.cpp VAACalcSadSsdBgd_c:338.
Per 8x8 block of the luma plane: SAD, signed sum of differences (SD)
and max abs difference (MAD) against the reference; per 16x16 MB: sum
and sum of squares of the current plane and the sum of squared
differences. All sums are int32, as in JAX without x64.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _blocks8(x):
    """[H, W] -> [mbH, mbW, 4, 64]: the 8x8 quadrants of each MB (TL, TR,
    BL, BR)."""
    h, w = x.shape
    mh, mw = h // 16, w // 16
    return x.reshape(mh, 2, 8, mw, 2, 8).permute(0, 3, 1, 4, 2, 5).reshape(
        mh, mw, 4, 64)


def vaa_calc(cur, ref):
    """Full VAA statistics between current and reference luma planes.

    cur, ref: [H, W] uint8 tensors on one device, H and W multiples of
    16. Returns a dict of int32 tensors on that device: frame_sad [],
    sad8x8 / sd8x8 / mad8x8 [mh, mw, 4], sum16x16 / sqsum16x16 /
    sqdiff16x16 [mh, mw]."""
    c = _blocks8(cur.to(I32))
    r = _blocks8(ref.to(I32))
    d = c - r
    ad = d.abs()
    sad8 = ad.sum(-1, dtype=I32)
    return {
        "sad8x8": sad8,
        "sd8x8": d.sum(-1, dtype=I32),
        "mad8x8": ad.amax(-1),
        "sum16x16": c.sum((-1, -2), dtype=I32),
        "sqsum16x16": (c * c).sum((-1, -2), dtype=I32),
        "sqdiff16x16": (ad * ad).sum((-1, -2), dtype=I32),
        "frame_sad": sad8.sum(dtype=I32),
    }
