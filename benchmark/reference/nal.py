"""Annex-B NAL unit framing: start-code scan, emulation prevention.

A frozen copy, for the benchmark's plain reference, of the port's
openh264_tpu_torch/bitstream/nal.py; only its imports changed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# NAL unit types (H.264 Table 7-1).
NAL_SLICE = 1
NAL_DPA = 2
NAL_DPB = 3
NAL_DPC = 4
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_SEQ = 10
NAL_END_STREAM = 11
NAL_FILLER = 12
NAL_SPS_EXT = 13
NAL_PREFIX = 14
NAL_SUBSET_SPS = 15
NAL_AUX_SLICE = 19
NAL_SLICE_EXT = 20


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: bytes  # emulation-prevention removed, header byte stripped
    # SVC/MVC extension fields (present when nal_unit_type in {14, 20}).
    svc_ext: dict | None = None

    @property
    def is_vcl(self) -> bool:
        return self.nal_unit_type in (NAL_SLICE, NAL_DPA, NAL_IDR, NAL_SLICE_EXT)

    @property
    def is_idr(self) -> bool:
        return self.nal_unit_type == NAL_IDR


def find_start_codes(buf: np.ndarray) -> list[tuple[int, int]]:
    """Return [(payload_start, start_code_len), ...] for 00 00 01 /
    00 00 00 01 prefixes, vectorized."""
    if len(buf) < 3:
        return []
    b = buf
    # positions i where b[i:i+3] == 00 00 01
    hits = np.flatnonzero((b[:-2] == 0) & (b[1:-1] == 0) & (b[2:] == 1))
    out = []
    for i in hits:
        i = int(i)
        sc_len = 3
        if i > 0 and b[i - 1] == 0:
            sc_len = 4
        out.append((i + 3, sc_len))
    return out


def unescape_rbsp(ebsp: bytes | np.ndarray) -> bytes:
    """Remove emulation_prevention_three_byte: 00 00 03 -> 00 00."""
    b = np.frombuffer(bytes(ebsp), dtype=np.uint8) if not isinstance(ebsp, np.ndarray) else ebsp
    if len(b) < 3:
        return bytes(b)
    # A 0x03 at i is an emulation byte iff b[i-2]==0 and b[i-1]==0.
    is03 = np.zeros(len(b), dtype=bool)
    is03[2:] = (b[2:] == 3) & (b[1:-1] == 0) & (b[:-2] == 0)
    if not is03.any():
        return b.tobytes()
    # Spec guarantees an emulation 03 is followed by 00/01/02/03, so two
    # flagged positions are never adjacent in a legal stream — a single
    # vectorized mask removal is exact.
    keep = ~is03
    return b[keep].tobytes()


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


def split_annexb(stream: bytes) -> list[NalUnit]:
    """Split an Annex-B byte stream into NAL units (header parsed,
    payload unescaped)."""
    buf = np.frombuffer(stream, dtype=np.uint8)
    scs = find_start_codes(buf)
    nals: list[NalUnit] = []
    for k, (start, _sclen) in enumerate(scs):
        end = scs[k + 1][0] - scs[k + 1][1] if k + 1 < len(scs) else len(buf)
        if end <= start:
            continue
        hdr = int(buf[start])
        if hdr & 0x80:
            continue  # forbidden_zero_bit set: corrupt, skip
        nal_type = hdr & 0x1F
        ref_idc = (hdr >> 5) & 3
        payload = buf[start + 1:end]
        # Strip trailing zero padding (trailing_zero_8bits).
        nz = np.flatnonzero(payload)
        payload = payload[: int(nz[-1]) + 1] if len(nz) else payload[:0]
        svc_ext = None
        rbsp_off = 0
        if nal_type in (NAL_PREFIX, NAL_SLICE_EXT) and len(payload) >= 3:
            b0, b1, b2 = int(payload[0]), int(payload[1]), int(payload[2])
            svc_ext = {
                "idr_flag": (b0 >> 6) & 1,
                "priority_id": b0 & 0x3F,
                "no_inter_layer_pred_flag": (b1 >> 7) & 1,
                "dependency_id": (b1 >> 4) & 7,
                "quality_id": b1 & 0xF,
                "temporal_id": (b2 >> 5) & 7,
                "use_ref_base_pic_flag": (b2 >> 4) & 1,
                "discardable_flag": (b2 >> 3) & 1,
                "output_flag": (b2 >> 2) & 1,
            }
            rbsp_off = 3
        nals.append(NalUnit(ref_idc, nal_type, unescape_rbsp(payload[rbsp_off:]), svc_ext))
    return nals
