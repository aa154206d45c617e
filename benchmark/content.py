"""Synthetic camera content, made from a seed.

A copy of chip_smoke.py's frames_720p, kept here so that the
benchmark's inputs do not change when the program's scripts do. The
size is a parameter for the CPU tests; at 1280x720 the frames equal the
copied generator's, sample for sample.
"""

from __future__ import annotations

import numpy as np


def frames(n: int, seed: int, width: int = 1280, height: int = 720):
    """n frames of moving content as (y, u, v) uint8 planes: a textured
    gradient panning 2 px a frame (its texture repeats every 32 frames),
    a slowly drifting chroma wave, a static logo block and camera
    noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    tex = np.random.default_rng(seed + 1).integers(0, 64,
                                                   (height, width + 64))
    cy, cx = np.mgrid[0:height // 2, 0:width // 2].astype(np.float32)
    out = []
    for i in range(n):
        y = (0.08 * xx + 0.06 * yy + 40 * np.sin((xx - 2 * i) / 37.0)
             * np.cos(yy / 23.0) + tex[:, 2 * i % 64:2 * i % 64 + width]
             + 30)
        y = y + rng.integers(-2, 3, y.shape)
        y[600:680, 1040:1200] = 200                       # static logo
        u = 128 + 30 * np.sin((cx - i) / 19.0) + rng.integers(-1, 2, cx.shape)
        v = 128 + 25 * np.cos((cy + i) / 13.0)
        out.append(tuple(np.clip(a, 0, 255).astype(np.uint8)
                         for a in (y, u, v)))
    return out
