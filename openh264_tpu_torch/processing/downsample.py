"""Spatial-layer downsamplers in PyTorch.

Port of openh264_tpu/processing/downsample.py (dyadic_downsample,
general_bilinear_downsample), byte-identical with it. Behavior parity:
processing downsamplefuncs.cpp DyadicBilinearDownsampler_c:47 (and the
quarter/eighth variants), GeneralBilinearAccurateDownsampler_c:187
(15-bit fixed-point bilinear with the reference's exact rounding and
last-row/col nearest sampling). Planes are [H, W] uint8 tensors; the
result lies on the input's device.

The general filter blends in int64, as the C does; the JAX version
stages the same blend in int32 (it runs without x64) and gets the same
bytes, since its split of the 30-bit shift is exact.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64


def dyadic_downsample(src, ratio_log2: int = 1):
    """Halve width/height `ratio_log2` times.

    Parity: DyadicBilinearDownsampler_c — dst = ((a+b+1)>>1 + (c+d+1)>>1
    + 1) >> 1 over each 2x2; the quarter/eighth C variants subsample the
    same 2x2 average at strides 4/8 (top-left 2x2 of each cell), which
    iterating the half filter does NOT reproduce, so we gather the
    top-left 2x2 per cell directly.
    """
    s = 1 << ratio_log2
    h, w = src.shape
    x = src.to(I32)
    # top-left 2x2 of each sxs cell (for s=2 that's the whole cell)
    a = x[0::s, 0::s][: h // s, : w // s]
    b = x[0::s, 1::s][: h // s, : w // s]
    c = x[1::s, 0::s][: h // s, : w // s]
    d = x[1::s, 1::s][: h // s, : w // s]
    r1 = (a + b + 1) >> 1
    r2 = (c + d + 1) >> 1
    return ((r1 + r2 + 1) >> 1).to(torch.uint8)


def _gb_indices(src_w: int, dst_w: int, scale_bit: int):
    """Fixed-point x positions/fractions per dst column (host precompute,
    copied from the JAX module: Python's round of the float ratio)."""
    scale = 1 << scale_bit
    step = int(round(src_w / dst_w * scale))
    xinv = (1 << (scale_bit - 1)) + step * np.arange(dst_w, dtype=np.int64)
    return ((xinv >> scale_bit).astype(np.int32),
            (xinv & (scale - 1)).astype(np.int32))


def general_bilinear_downsample(src, dst_h: int, dst_w: int):
    """Arbitrary-ratio accurate bilinear downsample (15-bit fixed point).

    Parity: GeneralBilinearAccurateDownsampler_c:187 including the
    nearest-sample last row and column.
    """
    kbit = 15
    kscale = 1 << kbit
    src_h, src_w = src.shape
    dev = src.device
    xi, fu = (torch.as_tensor(a, dtype=I64, device=dev)
              for a in _gb_indices(src_w, dst_w, kbit))
    yi, fv = (torch.as_tensor(a, dtype=I64, device=dev)
              for a in _gb_indices(src_h, dst_h, kbit))
    x = src.to(I64)
    # clamp gathers so the +1 neighbors stay in bounds; interior dst
    # pixels never touch the clamp (fixed-point positions < src-1)
    xi0 = xi.clamp(0, src_w - 1)
    xi1 = (xi + 1).clamp(0, src_w - 1)
    yi0 = yi.clamp(0, src_h - 1)
    yi1 = (yi + 1).clamp(0, src_h - 1)
    r0 = x[yi0]
    r1 = x[yi1]
    a, b = r0[:, xi0], r0[:, xi1]
    c, d = r1[:, xi0], r1[:, xi1]
    wu1 = fu[None, :]
    wu0 = (kscale - 1) - wu1
    wv1 = fv[:, None]
    wv0 = (kscale - 1) - wv1
    t0 = wu0 * a + wu1 * b
    t1 = wu0 * c + wu1 * d
    acc = (wv0 * t0 + wv1 * t1 + (1 << (2 * kbit - 1))) >> (2 * kbit)
    acc = acc.clamp(0, 255).to(torch.uint8)
    # last column / last row use nearest sampling in the reference
    near = a.to(torch.uint8)
    acc[:, dst_w - 1] = near[:, dst_w - 1]
    acc[dst_h - 1, :] = near[dst_h - 1, :]
    return acc
