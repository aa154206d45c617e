"""Image rotation (METHOD_IMAGE_ROTATE) in PyTorch.

Port of openh264_tpu/processing/rotate.py (rotate_image): torch.rot90
with the JAX version's k values (torch.rot90 follows numpy's and JAX's
direction). Behavior parity: processing imagerotatefuncs.cpp
ImageRotate90D/180D/270D — pure permutations of the plane.
"""

from __future__ import annotations

import torch


def rotate_image(plane, degrees: int):
    """Rotate a [H, W] plane by 90/180/270 degrees clockwise.

    ImageRotate90D: dst[x][h-1-y] = src[y][x] (clockwise);
    180D: point reflection; 270D: counter-clockwise quarter.
    """
    if degrees % 360 == 0:
        return plane
    if degrees == 90:
        return torch.rot90(plane, -1, (0, 1))
    if degrees == 180:
        return torch.rot90(plane, 2, (0, 1))
    if degrees == 270:
        return torch.rot90(plane, 1, (0, 1))
    raise ValueError("rotation must be a multiple of 90 degrees")
