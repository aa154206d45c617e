"""Host helpers of the encoder core.

Copied from openh264_tpu/encoder/core_np.py (pad_to_mb only; the numpy
core itself is the JAX package's oracle and is not part of the port).
"""

from __future__ import annotations

import numpy as np


def pad_to_mb(plane: np.ndarray, mb_size: int = 16) -> np.ndarray:
    h, w = plane.shape
    H = (h + mb_size - 1) // mb_size * mb_size
    W = (w + mb_size - 1) // mb_size * mb_size
    if H == h and W == w:
        return plane
    out = np.empty((H, W), plane.dtype)
    out[:h, :w] = plane
    out[h:, :w] = plane[h - 1:h, :]
    out[:h, w:] = plane[:, w - 1:w]
    out[h:, w:] = plane[h - 1, w - 1]
    return out
