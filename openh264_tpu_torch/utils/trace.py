"""Leveled logging with a pluggable trace callback.

Mirrors the reference's logging subsystem: WelsLog + SLogContext
(codec/common/inc/utils.h:51-65), levels WELS_LOG_QUIET..DETAIL
(codec/api/wels/codec_app_def.h:322-332), and the pluggable sink
WelsTraceCallback (codec_api.h:539) selected via the
TRACE_CALLBACK/TRACE_LEVEL options. Default sink writes to stderr like
welsCodecTrace.cpp's ODS/file writer.

Copied from openh264_tpu/utils/trace.py.
"""

from __future__ import annotations

import sys
import time

WELS_LOG_QUIET = 0x00
WELS_LOG_ERROR = 0x01
WELS_LOG_WARNING = 0x02
WELS_LOG_INFO = 0x04
WELS_LOG_DEBUG = 0x08
WELS_LOG_DETAIL = 0x10

_LEVEL_NAMES = {
    WELS_LOG_ERROR: "Error",
    WELS_LOG_WARNING: "Warning",
    WELS_LOG_INFO: "Info",
    WELS_LOG_DEBUG: "Debug",
    WELS_LOG_DETAIL: "Detail",
}


def _default_sink(ctx, level: int, message: str) -> None:
    name = _LEVEL_NAMES.get(level, "Info")
    ts = time.strftime("%H:%M:%S")
    print(f"[OpenH264TPU] {ts} [{name}]: {message}", file=sys.stderr)


class TraceContext:
    """Per-session log context (analog of SLogContext carried in every
    encoder/decoder ctx). level is a max-severity filter like the
    reference's iTraceLevel."""

    def __init__(self, level: int = WELS_LOG_WARNING, callback=None,
                 callback_ctx=None):
        self.level = level
        self.callback = callback or _default_sink
        self.callback_ctx = callback_ctx

    def log(self, level: int, message: str) -> None:
        if level <= self.level and self.level != WELS_LOG_QUIET:
            self.callback(self.callback_ctx, level, message)

    def error(self, message: str) -> None:
        self.log(WELS_LOG_ERROR, message)

    def warning(self, message: str) -> None:
        self.log(WELS_LOG_WARNING, message)

    def info(self, message: str) -> None:
        self.log(WELS_LOG_INFO, message)

    def debug(self, message: str) -> None:
        self.log(WELS_LOG_DEBUG, message)


# module-level default context (used by code not attached to a session)
_global_ctx = TraceContext()


def wels_log(level: int, message: str, ctx: TraceContext | None = None) -> None:
    (ctx or _global_ctx).log(level, message)


def set_trace_callback(callback, callback_ctx=None) -> None:
    _global_ctx.callback = callback or _default_sink
    _global_ctx.callback_ctx = callback_ctx


def set_trace_level(level: int) -> None:
    _global_ctx.level = level
