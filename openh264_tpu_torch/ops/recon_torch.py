"""Batched motion compensation of the decoder's inter recon, in PyTorch.

Port of openh264_tpu/ops/recon_jax.py (`_mc_luma_jit`, `_mc_chroma_jit`):
clamped gather windows, then 6-tap quarter-pel luma or bilinear
eighth-pel chroma, for all 4x4 blocks of a frame at once. Integer-only
arithmetic on int32, bit-exact with the JAX twin and so with the
reference's C fallbacks (mc.cpp:215-369). It runs on whatever device the
reference plane lives on; the plane stays uint8 and only the windows are
widened, so no int32 copy of a whole plane is made (the role of
recon_jax.py's per-picture `_plane_i32` cache). The JAX twin pads the
block count to a power of two to bound its recompiles; eager PyTorch has
nothing to recompile, so there is no padding.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _windows(plane, yi, xi, size: int):
    """[B, size, size] int32 windows of `plane` at rows yi.. and columns
    xi.., clamped to the picture (border replication, the reference's
    expanded picture, expand_pic.cpp:388)."""
    H, W = plane.shape
    r = torch.arange(size, device=plane.device, dtype=I32)
    ys = (yi[:, None] + r[None, :]).clamp(0, H - 1).long()
    xs = (xi[:, None] + r[None, :]).clamp(0, W - 1).long()
    return plane[ys[:, :, None], xs[:, None, :]].to(I32)


def _tap6(a, dim: int, n: int):
    """Unnormalized 6-tap [1,-5,20,20,-5,1] along `dim`, n outputs."""
    s = [a.narrow(dim, k, n) for k in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def mc_luma(plane, x0, y0, mvx, mvy):
    """4x4 luma quarter-pel MC of B blocks on one reference plane.
    plane: uint8 [H, W]; x0, y0 (block position in pixels) and mvx, mvy
    (quarter-pel) int32 [B] on the plane's device. Returns uint8
    [B, 4, 4]. Every block computes the 16 sub-pel candidates and takes
    the one at yf * 4 + xf (recon_jax.py:26-75)."""
    xi = x0 + (mvx >> 2)
    yi = y0 + (mvy >> 2)
    xf = mvx & 3
    yf = mvy & 3
    wnd = _windows(plane, yi - 2, xi - 2, 10)             # [B,10,10]

    def clip8(a):
        return a.clamp(0, 255)

    b1 = _tap6(wnd, 2, 5)                                  # [B,10,5]
    b_full = clip8((b1[:, 2:7, :] + 16) >> 5)              # [B,5,5]
    h1 = _tap6(wnd, 1, 5)                                  # [B,5,10]
    h_full = clip8((h1[:, :, 2:7] + 16) >> 5)
    j1 = _tap6(b1, 1, 5)                                   # [B,5,5]
    j_full = clip8((j1 + 512) >> 10)

    G = wnd[:, 2:7, 2:7]
    g0, H_, M_ = G[:, :4, :4], G[:, :4, 1:5], G[:, 1:5, :4]
    b, s = b_full[:, :4, :4], b_full[:, 1:5, :4]
    h, m = h_full[:, :4, :4], h_full[:, :4, 1:5]
    j = j_full[:, :4, :4]

    cand = torch.stack([
        g0, (g0 + b + 1) >> 1, b, (H_ + b + 1) >> 1,
        (g0 + h + 1) >> 1, (b + h + 1) >> 1, (b + j + 1) >> 1,
        (b + m + 1) >> 1,
        h, (h + j + 1) >> 1, j, (j + m + 1) >> 1,
        (M_ + h + 1) >> 1, (h + s + 1) >> 1, (j + s + 1) >> 1,
        (m + s + 1) >> 1,
    ])                                                     # [16,B,4,4]
    k = (yf * 4 + xf).long()[None, :, None, None].expand(1, -1, 4, 4)
    return torch.gather(cand, 0, k)[0].to(torch.uint8)


def mc_chroma(plane, x0, y0, mvx, mvy):
    """2x2 chroma eighth-pel bilinear MC (recon_jax.py:77-93). plane:
    uint8 [H, W] (half resolution); x0, y0 the block's chroma position;
    mvx, mvy the luma quarter-pel vector, read as eighth-pel here.
    Returns uint8 [B, 2, 2]."""
    xi = x0 + (mvx >> 3)
    yi = y0 + (mvy >> 3)
    xf = (mvx & 7)[:, None, None]
    yf = (mvy & 7)[:, None, None]
    wnd = _windows(plane, yi, xi, 3)
    A, B_ = wnd[:, :2, :2], wnd[:, :2, 1:3]
    C, D = wnd[:, 1:3, :2], wnd[:, 1:3, 1:3]
    out = ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B_
           + (8 - xf) * yf * C + xf * yf * D + 32) >> 6
    return out.to(torch.uint8)
