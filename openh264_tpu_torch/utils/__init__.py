"""Logging and PSNR helpers of the public API (copied from
openh264_tpu/utils)."""

from .trace import (WELS_LOG_QUIET, WELS_LOG_ERROR, WELS_LOG_WARNING,
                    WELS_LOG_INFO, WELS_LOG_DEBUG, WELS_LOG_DETAIL,
                    TraceContext, wels_log, set_trace_callback, set_trace_level)
from .psnr import calc_psnr

__all__ = ["WELS_LOG_QUIET", "WELS_LOG_ERROR", "WELS_LOG_WARNING",
           "WELS_LOG_INFO", "WELS_LOG_DEBUG", "WELS_LOG_DETAIL",
           "TraceContext", "wels_log", "set_trace_callback",
           "set_trace_level", "calc_psnr"]
