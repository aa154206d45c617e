"""Annex-B NAL unit framing with emulation prevention (writer side).

Copied from openh264_tpu/bitstream/nal.py, writer side only (parity:
codec/encoder/core/src/nal_encap.cpp:120 WelsEncodeNal).
"""

from __future__ import annotations

import numpy as np

# NAL unit types (H.264 Table 7-1) the encoder session writes.
NAL_SLICE = 1
NAL_IDR = 5
NAL_SPS = 7
NAL_PPS = 8


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte so no 00 00 0x (x<=3) runs
    appear in the payload (H.264 §7.4.1.1)."""
    b = np.frombuffer(rbsp, dtype=np.uint8)
    n = len(b)
    if n < 3:
        return rbsp
    # Candidate sites on the ORIGINAL bytes; the sequential scan of
    # nal_encap.cpp:120 consumes two bytes per insertion, which equals
    # a greedy non-overlapping selection (next site >= prev + 2), and
    # insertions never create new sites, so one vectorized np.insert
    # is exact.
    cand = np.flatnonzero((b[:-2] == 0) & (b[1:-1] == 0) & (b[2:] <= 3))
    if len(cand) == 0:
        return rbsp
    sel = []
    last = -2
    for c in cand:            # loops only over violation sites (rare)
        if c >= last + 2:
            sel.append(c)
            last = c
    return np.insert(b, np.asarray(sel, np.int64) + 2, 3).tobytes()


def make_annexb_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
                    long_start_code: bool = True) -> bytes:
    """Wrap an RBSP payload into an Annex-B NAL unit."""
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    sc = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return sc + hdr + escape_rbsp(rbsp)
