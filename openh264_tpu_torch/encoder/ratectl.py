"""Rate control: frame-level QP ladder + leaky-bucket frame skip.

Copied from openh264_tpu/encoder/ratectl.py.

Modeled on the reference's RC (codec/encoder/core/src/ratectl.cpp):
mode dispatch WelsRcInitFuncPointers:1492-1567, picture QP calculation
RcCalculatePictureQp:476, frame-skip via virtual buffer
(RcVBufferCalculationSkipPic), bits feedback per frame
(pfWelsRcPictureInfoUpdate). Granularity here is per-frame (the
reference refines to GOM/MB-row granularity — a later milestone);
the control law is the same family: a log-domain R-QP model updated
from measured bits, clamped to ±3 QP steps per frame
(reference's delta-QP bounds), with IDR frames budgeted
iIdrBitrateRatio/100 times a P frame.

Deliberate tuning deltas vs the reference (kept explicit, not parity):
IDR ratio 3.0 (ref 4.0) and asymmetric up/down QP step bounds — both
tighten the measured bitrate window for short GOPs; a caller-supplied
initial QP can be preserved with honor_init_qp=True (cfg
rc_honor_init_qp) instead of the bpp-based RcInitialQp pick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# RC_MODES (codec_app_def.h:268-275)
RC_OFF_MODE = -1
RC_QUALITY_MODE = 0
RC_BITRATE_MODE = 1
RC_BUFFERBASED_MODE = 2
RC_TIMESTAMP_MODE = 3

_IDR_RATIO = 3.0        # iIdrBitrateRatio (tamed from 400% for tighter windows)
_MAX_DELTA_QP = 3       # per-frame QP step bound
_SKIP_FULLNESS = 0.85   # skip when buffer this full (vbuf skip threshold)


@dataclass
class RcState:
    qp: int
    buffer_fullness: float = 0.0   # bits currently "in flight"
    model_x: float = 0.0           # R-QP model scale: bits = x / qstep
    frames: int = 0


class RateControl:
    """One instance per encoder session (re-created on re-config)."""

    def __init__(self, mode: int, target_bitrate: float, fps: float,
                 init_qp: int, min_qp: int = 0, max_qp: int = 51,
                 enable_skip: bool = True, idr_ratio: float = _IDR_RATIO,
                 n_pixels: int = 0, honor_init_qp: bool = False,
                 max_bitrate: float = 0):
        self.mode = mode
        self.fps = max(1.0, fps)
        self.bits_per_frame = max(1.0, target_bitrate / self.fps)
        self.buffer_size = target_bitrate * 1.0  # 1s leaky bucket
        # iMaxBitrate hard ceiling over a one-second sliding window
        # (ratectl.cpp CheckFrameSkipBasedMaxbr / max-br window checks)
        self.max_bitrate = max(0.0, float(max_bitrate or 0))
        from collections import deque
        self._win = deque(maxlen=max(1, int(round(self.fps))))
        self.min_qp, self.max_qp = min_qp, max_qp
        self.enable_skip = enable_skip and mode in (RC_BITRATE_MODE,
                                                    RC_BUFFERBASED_MODE,
                                                    RC_TIMESTAMP_MODE)
        self.idr_ratio = idr_ratio
        if mode not in (RC_OFF_MODE,) and n_pixels > 0 and target_bitrate > 0 \
                and not honor_init_qp:
            # initial QP from bits-per-pixel (RcInitialQp analog,
            # ratectl.cpp: dBpp thresholds -> start QP)
            bpp = self.bits_per_frame / n_pixels
            if bpp <= 0.03:
                init_qp = 42
            elif bpp <= 0.08:
                init_qp = 38
            elif bpp <= 0.2:
                init_qp = 33
            elif bpp <= 0.5:
                init_qp = 29
            else:
                init_qp = 25
        self.st = RcState(qp=init_qp)

    # ------------------------------------------------------------------
    @staticmethod
    def _qstep(qp: int) -> float:
        return 0.625 * (2.0 ** (qp / 6.0))

    def should_skip(self) -> bool:
        """Leaky-bucket skip decision (reference: frame-skip when the
        virtual buffer would overflow, ratectl.cpp skip path), plus the
        max-bitrate sliding-window check."""
        if not self.enable_skip:
            return False
        if self.st.buffer_fullness > _SKIP_FULLNESS * self.buffer_size:
            return True
        return (self.max_bitrate > 0
                and sum(self._win) > self.max_bitrate)

    def frame_qp(self, is_idr: bool, temporal_id: int = 0) -> int:
        """QP for the next frame."""
        st = self.st
        if self.mode == RC_OFF_MODE:
            return int(min(self.max_qp, max(self.min_qp, st.qp)))
        if st.model_x > 0.0:
            target = self.bits_per_frame
            if is_idr:
                target *= self.idr_ratio
            # drain pressure: spend less when the bucket is filling
            pressure = st.buffer_fullness / max(1.0, self.buffer_size)
            target *= max(0.2, 1.0 - 1.5 * pressure)
            if self.max_bitrate > 0:
                # shrink the frame budget as the 1 s window nears the
                # hard ceiling so QP rises before skipping kicks in
                wfrac = sum(self._win) / self.max_bitrate
                if wfrac > 0.75:
                    target *= max(0.2, 1.0 - 2.0 * (wfrac - 0.75))
            want_qstep = st.model_x / max(1.0, target)
            want_qp = 6.0 * math.log2(max(1e-3, want_qstep / 0.625))
            # asymmetric bounds: raise QP fast (overshoot recovery),
            # lower it slowly (avoid oscillation after the IDR)
            up = 6 if st.frames < 3 else _MAX_DELTA_QP
            down = 1
            dq = max(-down, min(up, round(want_qp) - st.qp))
            qp = st.qp + dq
        else:
            qp = st.qp
        if is_idr and st.frames > 0:
            qp = qp - 2   # reference budgets IDR at lower QP than P
        qp += temporal_id  # dyadic layers ride a small QP ladder
        return int(min(self.max_qp, max(self.min_qp, qp)))

    def update(self, bits: int, qp_used: int, is_idr: bool) -> None:
        """Bits feedback after encoding one frame
        (pfWelsRcPictureInfoUpdate role)."""
        st = self.st
        st.frames += 1
        self._win.append(bits)
        if self.mode == RC_OFF_MODE:
            return
        st.qp = qp_used
        # leaky bucket: add produced bits, drain one frame interval
        st.buffer_fullness = max(
            0.0, st.buffer_fullness + bits - self.bits_per_frame)
        # R-QP model refresh (EWMA over measured bits*qstep)
        x = bits * self._qstep(qp_used)
        if is_idr:
            x /= self.idr_ratio
        st.model_x = x if st.model_x == 0.0 else 0.75 * st.model_x + 0.25 * x

    def skipped(self) -> None:
        """Account a skipped frame (buffer drains one interval)."""
        self.st.buffer_fullness = max(
            0.0, self.st.buffer_fullness - self.bits_per_frame)
        self._win.append(0)
