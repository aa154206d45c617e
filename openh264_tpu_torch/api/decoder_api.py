"""ISVCDecoder-equivalent session object.

Port of openh264_tpu/api/decoder_api.py (CWelsDecoder,
WelsCreateDecoder). The engine is the port's decoder.H264Decoder on
`device` (default "cuda"; without a GPU the default raises when the
decoder is initialised), which takes I and P slices in CAVLC or CABAC,
with FMO and 4x4 scaling lists. A slice it does not take (B, the 8x8
transform) raises NotImplementedError out of the decode calls instead
of coming back as a bitstream error. Mirrors CWelsDecoder (codec/decoder/plus/src/welsDecoderExt.cpp):
Initialize :373, DecodeFrameNoDelay :695, DecodeFrame2 :918,
FlushFrame, SetOption/GetOption, statistics. Incremental Annex-B
input: callers feed one or more NALs per call; completed access units
decode immediately (no-delay semantics for non-B streams; B streams
reorder through the internal output queue like
ReleaseBufferedReadyPictureReorder).
"""

from __future__ import annotations

import time

import numpy as np

from .options import DECODER_OPTION, DECODING_STATE
from .params import SDecodingParam, SDecoderStatistics
from ..decoder import H264Decoder
from ..device import resolve_device


class CWelsDecoder:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.param: SDecodingParam | None = None
        self._dec: H264Decoder | None = None
        self._stats = SDecoderStatistics()
        self._buf = b""
        self._t_total = 0.0
        self._num_threads = 1

    # ------------------------------------------------------------------
    def Initialize(self, p: SDecodingParam | None = None) -> int:
        self.param = p or SDecodingParam()
        self._dec = H264Decoder(device=self.device)
        self._stats = SDecoderStatistics()
        return 0

    def Uninitialize(self) -> int:
        self._dec = None
        return 0

    # ------------------------------------------------------------------
    def DecodeFrameNoDelay(self, src: bytes):
        """Feed Annex-B bytes — possibly a FRAGMENT of a NAL unit; the
        session buffers input until NALs complete (the reference's
        DecodeFrame2 bitstream buffering, welsDecoderExt.cpp:918).
        Returns (state, [frames]) for every access unit completed by
        this call. welsDecoderExt.cpp:695 semantics."""
        if self._dec is None:
            return DECODING_STATE.dsInitialOptExpected, []
        if not src:
            return DECODING_STATE.dsErrorFree, []
        t0 = time.perf_counter()
        try:
            frames = self._dec.feed_annexb(src)
        except NotImplementedError:
            raise
        except Exception:
            self._stats.uiEcFrameNum += 1
            return DECODING_STATE.dsBitstreamError, []
        self._account(frames, time.perf_counter() - t0)
        return DECODING_STATE.dsErrorFree, frames

    def DecodeFrame2(self, src: bytes):
        return self.DecodeFrameNoDelay(src)

    def FlushFrame(self):
        """End of stream: decode the buffered tail and drain the
        reorder queue."""
        if self._dec is None:
            return DECODING_STATE.dsInitialOptExpected, []
        t0 = time.perf_counter()
        try:
            frames = self._dec.flush()
        except NotImplementedError:
            raise
        except Exception:
            self._stats.uiEcFrameNum += 1
            return DECODING_STATE.dsBitstreamError, []
        self._account(frames, time.perf_counter() - t0)
        return DECODING_STATE.dsErrorFree, frames

    def _account(self, frames, dt: float) -> None:
        self._t_total += dt
        st = self._stats
        st.uiDecodedFrameCount += len(frames)
        if frames:
            h, w = frames[0].y.shape
            st.uiWidth, st.uiHeight = w, h
        if st.uiDecodedFrameCount:
            st.fAverageFrameSpeedInMs = (1000.0 * self._t_total /
                                         st.uiDecodedFrameCount)

    # ------------------------------------------------------------------
    def SetOption(self, eOptionId: int, value) -> int:
        """Implemented options take effect immediately; everything else
        returns an error instead of silently succeeding
        (welsDecoderExt.cpp SetOption dispatch)."""
        if eOptionId == DECODER_OPTION.NUM_OF_THREADS:
            self._num_threads = max(1, min(16, int(value)))
            return 0
        if eOptionId == DECODER_OPTION.ERROR_CON_IDC:
            if self.param:
                self.param.eEcActiveIdc = int(value)
            if self._dec is not None:
                self._dec.ec_mode = int(value)
            return 0
        if eOptionId == DECODER_OPTION.END_OF_STREAM:
            self._eos = bool(value)
            return 0
        if eOptionId in (DECODER_OPTION.TRACE_LEVEL,):
            from ..utils.trace import set_trace_level
            set_trace_level(int(value))
            return 0
        return 2  # cmInitParaError: option not supported

    def GetOption(self, eOptionId: int):
        if eOptionId == DECODER_OPTION.GET_STATISTICS:
            return self._stats
        if eOptionId == DECODER_OPTION.NUM_OF_THREADS:
            return self._num_threads
        if eOptionId == DECODER_OPTION.ERROR_CON_IDC and self.param:
            return self.param.eEcActiveIdc
        if eOptionId == DECODER_OPTION.NUM_OF_FRAMES_REMAINING_IN_BUFFER \
                and self._dec is not None:
            return len(self._dec._reorder_q)
        sps = self._dec.active_sps if self._dec is not None else None
        if eOptionId == DECODER_OPTION.PROFILE:
            return getattr(sps, "profile_idc", 0)
        if eOptionId == DECODER_OPTION.LEVEL:
            return getattr(sps, "level_idc", 0)
        return None


def WelsCreateDecoder(device="cuda") -> CWelsDecoder:
    """Factory (codec_api.h:514 WelsCreateDecoder)."""
    return CWelsDecoder(device=device)
