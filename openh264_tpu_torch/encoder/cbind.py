"""Host C of the host encoder, bound with ctypes: the I-frame intra mode
decision and encode (enc_intra_frame_native) and the token bit packer
(bitpack), both in csrc/host_native.c, whose signatures
_build.SIGNATURES declares.

Port of the functions of openh264_tpu/native/__init__.py that these
paths run. Unlike the JAX package, which falls back to numpy and to
I16-only intra when its C does not build, this module has no fallback:
a failed build raises.
"""

from __future__ import annotations

import numpy as np

from .. import _build
from ..tables import DEQUANT_4x4, QUANT_MF_4x4


def bitpack(vals: np.ndarray, lens: np.ndarray, out: np.ndarray,
            start_bit: int) -> int:
    """Append MSB-first tokens into `out` (zeroed uint8 from start_bit
    on); returns the new bit position."""
    v = np.ascontiguousarray(vals.reshape(-1), np.uint32)
    ln = np.ascontiguousarray(lens.reshape(-1), np.uint8)
    if out.dtype != np.uint8 or out.ndim != 1 or \
            not out.flags["C_CONTIGUOUS"]:
        raise ValueError("bitpack: out must be a contiguous uint8 vector")
    # a token may be longer than its 32-bit value (leading zeros), but
    # the C accumulator holds at most 7 pending bits plus 56
    if len(v) != len(ln) or (ln > 56).any():
        raise ValueError("bitpack: one length of at most 56 per value")
    if start_bit + int(ln.sum(dtype=np.int64)) > 8 * out.size:
        raise ValueError("bitpack: the tokens overrun `out`")
    return _build.bind("host_native").bitpack(
        v.ctypes.data, ln.ctypes.data, len(v), out.ctypes.data, start_bit)


def enc_intra_frame_native(y, u, v, qp: int, qp_c: int, lam: int,
                           enable_i4: bool = True) -> dict:
    """I-frame MD + encode in C (I16x16 vs I4x4 per MB). y/u/v: host
    uint8 planes, MB aligned. Returns the encoder's symbol dict, numpy,
    with the recon planes."""
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    if y.shape != (16 * mb_h, 16 * mb_w) or mb_h == 0 or mb_w == 0 or \
            u.shape != (8 * mb_h, 8 * mb_w) or v.shape != u.shape:
        raise ValueError("enc_intra_frame_native: y must be MB aligned and "
                         "u, v half its size")
    if not (0 <= qp <= 51 and 0 <= qp_c <= 51):
        raise ValueError("enc_intra_frame_native: QP out of 0..51")
    n = mb_w * mb_h
    qmf = np.ascontiguousarray(np.asarray(QUANT_MF_4x4).reshape(52, 16),
                               np.int32)
    dqt = np.ascontiguousarray(np.asarray(DEQUANT_4x4).reshape(52, 16),
                               np.int32)
    kind = np.zeros(n, np.int32)
    i16m = np.zeros(n, np.int32)
    i4m = np.zeros((n, 16), np.int32)
    i4prev = np.zeros((n, 16), np.int32)
    i4rem = np.zeros((n, 16), np.int32)
    cmode = np.zeros(n, np.int32)
    ldc = np.zeros((n, 16), np.int32)
    lac = np.zeros((n, 16, 16), np.int32)
    cdc = np.zeros((n, 2, 4), np.int32)
    cac = np.zeros((n, 2, 4, 16), np.int32)
    ry, ru, rv = y.copy(), u.copy(), v.copy()
    arrs = [y, u, v, qmf, dqt, kind, i16m, i4m, i4prev, i4rem, cmode,
            ldc, lac, cdc, cac, ry, ru, rv]
    ptrs = np.array([a.ctypes.data for a in arrs], np.uint64)
    params = np.array([mb_w, mb_h, qp, qp_c, lam, int(enable_i4)],
                      np.int32)
    _build.bind("host_native").enc_intra_frame(ptrs.ctypes.data,
                                               params.ctypes.data)
    return {"kind": kind, "i16_mode": i16m, "i4_modes": i4m,
            "i4_prev": i4prev, "i4_rem": i4rem, "chroma_mode": cmode,
            "luma_dc": ldc.reshape(n, 4, 4), "luma_ac": lac,
            "chroma_dc": cdc, "chroma_ac": cac,
            "recon_y": ry, "recon_u": ru, "recon_v": rv}
