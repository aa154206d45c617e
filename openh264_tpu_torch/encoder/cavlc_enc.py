"""CAVLC entropy writing (H.264 §9.2, encode direction).

Uses the same spec code tables as the decoder (tables/cavlc.py), so
encoder and decoder are table-consistent by construction. Parity
anchors: set_mb_syn_cavlc.cpp CavlcParamCal_c:84 /
WriteBlockResidualCavlc:108.

Copied from openh264_tpu/encoder/cavlc_enc.py.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitWriter
from ..tables.cavlc import (COEFF_TOKEN, RUN_BEFORE, TOTAL_ZEROS,
                            TOTAL_ZEROS_CHROMA_DC)


def write_residual_block(w: BitWriter, coeffs_scan: np.ndarray, nc: int,
                         max_coeff: int) -> int:
    """Write one residual block; coeffs_scan: levels in scan order
    (length max_coeff). Returns total_coeff (for nzc bookkeeping)."""
    nz = np.flatnonzero(coeffs_scan)
    total = len(nz)
    # trailing ones: up to 3 trailing +-1
    t1 = 0
    t1_signs = []
    for i in range(total - 1, -1, -1):
        v = int(coeffs_scan[nz[i]])
        if abs(v) == 1 and t1 < 3:
            t1 += 1
            t1_signs.append(1 if v < 0 else 0)
        else:
            break
    # coeff_token
    if nc < 0:
        cls = 4
    elif nc < 2:
        cls = 0
    elif nc < 4:
        cls = 1
    elif nc < 8:
        cls = 2
    else:
        cls = 3
    val, ln = int(COEFF_TOKEN[cls, total, t1, 0]), int(COEFF_TOKEN[cls, total, t1, 1])
    assert ln > 0, (cls, total, t1)
    w.u(ln, val)
    if total == 0:
        return 0
    # trailing one signs (highest frequency first)
    for s in t1_signs:
        w.u(1, s)
    # levels (remaining, highest frequency first)
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    idx = total - 1 - t1
    first = True
    while idx >= 0:
        level = int(coeffs_scan[nz[idx]])
        abs_m1 = abs(level) - 1
        sign = 1 if level < 0 else 0
        level_code = (abs_m1 << 1) | sign
        if first and t1 < 3:
            level_code -= 2
            first = False
        elif first:
            first = False
        _write_level(w, level_code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
        idx -= 1
    # total_zeros
    if total < max_coeff:
        zeros = int(nz[-1]) + 1 - total
        if max_coeff == 4:
            zval, zln = (int(TOTAL_ZEROS_CHROMA_DC[total, zeros, 0]),
                         int(TOTAL_ZEROS_CHROMA_DC[total, zeros, 1]))
        else:
            zval, zln = (int(TOTAL_ZEROS[total, zeros, 0]),
                         int(TOTAL_ZEROS[total, zeros, 1]))
        assert zln > 0, (total, zeros)
        w.u(zln, zval)
    else:
        zeros = 0
    # run_before (highest frequency first)
    zl = zeros
    for i in range(total - 1, 0, -1):
        if zl <= 0:
            break
        run = int(nz[i]) - int(nz[i - 1]) - 1
        rval, rln = (int(RUN_BEFORE[min(zl, 7), run, 0]),
                     int(RUN_BEFORE[min(zl, 7), run, 1]))
        assert rln > 0, (zl, run)
        w.u(rln, rval)
        zl -= run
    return total


def _write_level(w: BitWriter, level_code: int, suffix_len: int) -> None:
    """Write coeff level with the adaptive suffix scheme (§9.2.2.1)."""
    if suffix_len == 0:
        if level_code < 14:
            w.u(level_code + 1, 1)  # unary: level_code zeros then 1
        elif level_code < 30:
            w.u(15, 1)              # prefix 14 -> 4-bit suffix
            w.u(4, level_code - 14)
        else:
            # escape: prefix 15, 12-bit suffix
            w.u(16, 1)
            w.u(12, level_code - 30)
    else:
        prefix = level_code >> suffix_len
        if prefix < 15:
            w.u(prefix + 1, 1)
            w.u(suffix_len, level_code & ((1 << suffix_len) - 1))
        else:
            w.u(16, 1)
            w.u(12, level_code - (15 << suffix_len))
