"""Adaptive quantization (METHOD_ADAPTIVE_QUANT).

Behavior parity: processing AdaptiveQuantization.cpp Process:57 — per
MB, a motion index (variance of the frame difference) and a texture
index (variance of the current MB) are normalized by their frame
averages and mapped through the rate-model Q-step curve to a delta QP
in [-6, 6]; AQ_QUALITY_MODE uses texture (plus negative motion
deltas), AQ_BITRATE_MODE uses texture + motion.

Fixed-point constants follow AdaptiveQuantization.h
(AQ_INT_MULTIPLY=100, AQ_TIME_INT_MULTIPLY=100, AQ_QSTEP_INT_MULTIPLY
=100, MODEL_ALPHA=1.5*100=150/..., MODEL_TIME=9.0*100) — we compute
the same curve in float64-free int64-free form: the quantities fit
comfortably in float32's 24-bit mantissa only for small frames, so we
use python/numpy int64 on host; the map is tiny (one value per MB).

Copied from openh264_tpu/processing/adaptivequant.py: host numpy over
the VAA statistics that processing/vaa.py computes on the device.
"""

from __future__ import annotations

import numpy as np

AQ_QUALITY_MODE = 0
AQ_BITRATE_MODE = 1

_AQ_INT = 100
_AQ_TIME_INT = 100
_AQ_QSTEP_INT = 100
_MODEL_ALPHA = 150          # 1.5 * AQ_TIME_INT_MULTIPLY
_MODEL_TIME = 900           # 9.0 * AQ_TIME_INT_MULTIPLY
_AVERAGE_TIME_MOTION = 350          # 3.5 * AQ_TIME_INT_MULTIPLY
_AVERAGE_TIME_TEXTURE_QUALITY = 140  # 1.4
_AVERAGE_TIME_TEXTURE_BITRATE = 100  # 1.0
_AQ_PESN = 1


def _trunc_div(a, b):
    """C-style int64 division (truncates toward zero); b==0 -> a
    (mirrors the WELS_DIV_ROUND64 macro's y==0 arm x/(y+1))."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    babs = np.where(b == 0, 1, np.abs(b))
    q = np.abs(a) // babs
    return np.where((a < 0) ^ (b < 0), -q, q)


def _div_round64(a, b):
    """WELS_DIV_ROUND64: ((b/2 + a) / b) with C truncating division."""
    b = np.asarray(b, np.int64)
    return np.where(b == 0, np.asarray(a, np.int64),
                    _trunc_div(np.asarray(a, np.int64) + _trunc_div(b, 2), b))


def adaptive_quant_map(vaa, mode: int = AQ_QUALITY_MODE) -> np.ndarray:
    """Per-MB delta-QP map [mh, mw] int8 from VAA stats.

    vaa: dict from processing.vaa.vaa_calc, fetched to numpy.
    """
    sad = np.asarray(vaa["sad8x8"]).astype(np.int64).sum(-1)    # [mh,mw]
    ssd = np.asarray(vaa["sqdiff16x16"]).astype(np.int64)
    s = np.asarray(vaa["sum16x16"]).astype(np.int64)
    sq = np.asarray(vaa["sqsum16x16"]).astype(np.int64)
    mh, mw = sad.shape
    n = mh * mw

    sum_diff = sad >> 8
    motion = (ssd >> 8) - sum_diff * sum_diff
    mean = s >> 8
    texture = (sq >> 8) - mean * mean

    avg_motion = int(_div_round64(int(motion.sum()) * _AQ_INT, n))
    avg_texture = int(_div_round64(int(texture.sum()) * _AQ_INT, n))
    if -_AQ_PESN <= avg_motion <= _AQ_PESN:
        avg_motion = _AQ_INT
    if -_AQ_PESN <= avg_texture <= _AQ_PESN:
        avg_texture = _AQ_INT
    avg_motion = int(_div_round64(_AVERAGE_TIME_MOTION * avg_motion,
                                  _AQ_TIME_INT))
    tex_time = (_AVERAGE_TIME_TEXTURE_QUALITY if mode == AQ_QUALITY_MODE
                else _AVERAGE_TIME_TEXTURE_BITRATE)
    avg_texture = int(_div_round64(tex_time * avg_texture, _AQ_TIME_INT))

    def qcurve(idx, avg):
        a = _div_round64(idx * (_AQ_INT * _AQ_TIME_INT), avg)
        qstep = _div_round64((a - _AQ_TIME_INT) * _AQ_QSTEP_INT,
                             a + _MODEL_ALPHA)
        return _MODEL_TIME * qstep    # scaled delta qp (x100x100)

    eps = -(_AQ_PESN * _AQ_TIME_INT * _AQ_QSTEP_INT) // _AQ_INT
    tex_dqp = _trunc_div(qcurve(texture, avg_texture), _AQ_TIME_INT)
    mot_dqp_s = qcurve(motion, avg_motion)
    mot_dqp = _trunc_div(mot_dqp_s, _AQ_TIME_INT)
    if mode == AQ_BITRATE_MODE:
        dqp = tex_dqp + mot_dqp
    else:
        dqp = tex_dqp + np.where(mot_dqp_s < eps, mot_dqp, 0)
    return _trunc_div(dqp, _AQ_QSTEP_INT).astype(np.int8)
