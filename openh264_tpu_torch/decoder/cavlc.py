"""CAVLC residual parsing (H.264 §9.2).

Behavior parity: reference codec/decoder/core/src/parse_mb_syn_cavlc.cpp
WelsResidualBlockCavlc (:860) — table-driven via the LUTs generated in
tables/cavlc.py from the spec code tables.

Copied from openh264_tpu/decoder/cavlc.py: the per-MB Python parser
(slice_dec.py) reads its residual blocks with these; slices without FMO
go to the host C parser (csrc/parse_cavlc.c), which reads the same LUTs.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from ..tables.cavlc import (COEFF_TOKEN_LUTS, RUN_BEFORE_LUTS,
                            TOTAL_ZEROS_CDC_LUTS, TOTAL_ZEROS_LUTS)


def nc_class(nc: int) -> int:
    if nc < 0:
        return 4
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


def read_coeff_token(br: BitReader, nc: int) -> tuple[int, int]:
    """Returns (total_coeff, trailing_ones)."""
    lut = COEFF_TOKEN_LUTS[nc_class(nc)]
    v = int(lut[br.peek(16)])
    if v == 0:
        raise ValueError(f"invalid coeff_token at bit {br.pos} (nC={nc})")
    br.skip(v & 31)
    return v >> 10, (v >> 7) & 7


def _read_level_prefix(br: BitReader) -> int:
    lz = 0
    while True:
        chunk = br.peek(32)
        if chunk == 0:
            br.skip(32)
            lz += 32
            if lz > 64:
                raise ValueError("runaway level_prefix")
            continue
        z = 32 - chunk.bit_length()
        br.skip(z + 1)
        return lz + z


def parse_residual_block(br: BitReader, nc: int, max_coeff: int):
    """Parse one CAVLC residual block.

    Returns (coeffs, total_coeff): coeffs is int32[max_coeff] in SCAN
    order (zigzag position k -> coeffs[k]), raw levels (no dequant).
    """
    total_coeff, trailing_ones = read_coeff_token(br, nc)
    coeffs = np.zeros(max_coeff, dtype=np.int32)
    if total_coeff == 0:
        return coeffs, 0
    if total_coeff > max_coeff or trailing_ones > 3:
        raise ValueError("invalid coeff_token contents")

    levels = np.zeros(total_coeff, dtype=np.int64)
    # trailing one signs
    for i in range(trailing_ones):
        levels[i] = -1 if br.u(1) else 1
    # remaining levels
    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        prefix = _read_level_prefix(br)
        suffix_size = suffix_len
        if prefix == 14 and suffix_len == 0:
            suffix_size = 4
        elif prefix >= 15:
            suffix_size = prefix - 3
        level_code = min(15, prefix) << suffix_len
        if suffix_size > 0:
            level_code += br.u(suffix_size)
        if prefix >= 15 and suffix_len == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code & 1:
            levels[i] = -((level_code + 1) >> 1)
        else:
            levels[i] = (level_code + 2) >> 1
        if suffix_len == 0:
            suffix_len = 1
        if abs(int(levels[i])) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    if total_coeff < max_coeff:
        if max_coeff == 4:  # chroma DC
            lut = TOTAL_ZEROS_CDC_LUTS[total_coeff]
            v = int(lut[br.peek(3)])
        else:
            lut = TOTAL_ZEROS_LUTS[total_coeff]
            v = int(lut[br.peek(9)])
        if v == 0:
            raise ValueError("invalid total_zeros")
        br.skip(v & 31)
        zeros_left = v >> 5
    else:
        zeros_left = 0
    if zeros_left + total_coeff > max_coeff:
        raise ValueError("invalid total_zeros value")

    # run_before for each coefficient except the last parsed
    runs = np.zeros(total_coeff, dtype=np.int32)
    zl = zeros_left
    for i in range(total_coeff - 1):
        if zl <= 0:
            break
        lut = RUN_BEFORE_LUTS[min(zl, 7)]
        v = int(lut[br.peek(11)])
        if v == 0:
            raise ValueError("invalid run_before")
        br.skip(v & 31)
        runs[i] = v >> 5
        zl -= runs[i]
        if zl < 0:
            raise ValueError("negative zeros left")
    runs[total_coeff - 1] = zl if zl > 0 else 0

    # place coefficients: levels[0] is the highest-frequency coefficient
    pos = -1
    for i in range(total_coeff - 1, -1, -1):
        pos += runs[i] + 1
        if pos >= max_coeff:
            raise ValueError("coefficient position overflow")
        coeffs[pos] = levels[i]
    return coeffs, total_coeff
