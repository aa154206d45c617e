"""PSNR computation (parity: codec/common/src/utils.cpp:43 WelsCalcPsnr).

The reference computes 10*log10(255^2 * W * H / SSD) per plane; identical
formula here over numpy planes (stride-free).

Copied from openh264_tpu/utils/psnr.py.
"""

from __future__ import annotations

import math

import numpy as np


def calc_psnr(ref: np.ndarray, rec: np.ndarray) -> float:
    diff = ref.astype(np.int64) - rec.astype(np.int64)
    ssd = int(np.sum(diff * diff))
    if ssd == 0:
        return 99.0
    return 10.0 * math.log10((255.0 * 255.0 * ref.size) / ssd)
