"""Denoise filters (METHOD_DENOISE) in PyTorch.

Port of openh264_tpu/processing/denoise.py (bilateral_luma,
waverage_chroma, denoise_frame), byte-identical with it. Behavior
parity: processing denoise_filter.cpp BilateralLumaFilter8_c (3x3
bilateral, weight (32-|d|)^2>>5 within gray radius 32),
WaverageChromaFilter8_c (5x5 weighted average, kernel
[[1,1,2,1,1],[1,2,4,2,1],[2,4,20,4,2],...] >> 6), driven by denoise.cpp
BilateralDenoiseLuma:92 / WaverageDenoiseChroma:107 over the plane
interior.

As in the JAX version, every window reads the original frame (the
reference filters in place, so its windows read already-denoised pixels
above and left). The neighbours come from torch.roll, which wraps at the
borders like jnp.roll; only the interior is taken and the border keeps
the source. Planes are [H, W] uint8 tensors; the result lies on the
input's device.
"""

from __future__ import annotations

import torch

I32 = torch.int32

_CHROMA_K = ((1, 1, 2, 1, 1),
             (1, 2, 4, 2, 1),
             (2, 4, 20, 4, 2),
             (1, 2, 4, 2, 1),
             (1, 1, 2, 1, 1))


def _interior(out, src, r: int):
    """out inside a border of r pixels, src on it, as uint8."""
    res = src.clone()
    res[r:-r, r:-r] = out[r:-r, r:-r]
    return res.to(torch.uint8)


def bilateral_luma(y):
    """3x3 bilateral: w = ((32-|p-c|)^2)>>5 when |p-c| <= 32 else 0;
    out = (sum(p*w) + c*(256-sum(w))) >> 8."""
    x = y.to(I32)
    c = x
    nsum = torch.zeros_like(x)
    wsum = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            p = torch.roll(x, (-dy, -dx), (0, 1))
            d = (p - c).abs()
            w = torch.where(d <= 32, ((32 - d) * (32 - d)) >> 5, 0)
            nsum += p * w
            wsum += w
    out = (nsum + c * (256 - wsum)) >> 8
    # interior only (radius 1); borders keep the source
    return _interior(out, x, 1)


def waverage_chroma(c):
    """5x5 weighted average (kernel above, >>6) over the interior."""
    x = c.to(I32)
    acc = torch.zeros_like(x)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            kw = _CHROMA_K[dy + 2][dx + 2]
            acc += kw * torch.roll(x, (-dy, -dx), (0, 1))
    return _interior(acc >> 6, x, 2)


def denoise_frame(y, u, v, components: int = 7):
    """Denoise a YUV frame. components: bit0=Y, bit1=U, bit2=V
    (DENOISE_ALL_COMPONENT in the reference)."""
    if components & 1:
        y = bilateral_luma(y)
    if components & 2:
        u = waverage_chroma(u)
    if components & 4:
        v = waverage_chroma(v)
    return y, u, v
