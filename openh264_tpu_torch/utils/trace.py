"""Leveled logging with a pluggable trace callback, and the port's span
recorder.

The logging API mirrors the reference's logging subsystem: WelsLog +
SLogContext (codec/common/inc/utils.h:51-65), levels WELS_LOG_QUIET..DETAIL
(codec/api/wels/codec_app_def.h:322-332), and the pluggable sink
WelsTraceCallback (codec_api.h:539) selected via the
TRACE_CALLBACK/TRACE_LEVEL options. Default sink writes to stderr like
welsCodecTrace.cpp's ODS/file writer.

The logging API is copied from openh264_tpu/utils/trace.py.

The span recorder times the port's layers: `span(name, **attrs)` is a
context manager that records its name, its start and end
(time.perf_counter_ns), its parent span and the frame id it inherits
(an attr `frame` sets it); `count(name, n)` adds to a counter of the
innermost open span. `enable()` turns recording on, `disable()` off,
and `drain()` hands out what was recorded as plain tuples and dicts.
Off is the default: then `span` returns one shared no-op object (no
clock read, no allocation, no device synchronization), unless the
caller keeps its own statistics from the span's time (`clock=True`,
e.g. the session's last_stats, the decoder's stage_seconds), when it
only reads the clock. While recording, and while a torch.profiler
session is active, each span also enters
torch.autograd.profiler.record_function(name), so the spans appear in
the profiler's own event list, on its clock. Spans sit at layer
boundaries only (a frame, a slice, a stage, a blocking read), never per
macroblock or per bin.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# Span recorder
# ---------------------------------------------------------------------------
class SpanRecord(NamedTuple):
    """One finished span: ids are unique within the process (0: none)."""
    id: int
    parent: int
    name: str
    frame: object           # the frame id it carries or inherits, or None
    start_ns: int
    end_ns: int
    attrs: dict


_on = False
_done: list = []            # finished SpanRecords, in order of their end
_counters: dict = {}        # span id -> {counter: total}
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_profiling = None           # torch.autograd._profiler_enabled, once on
_record_function = None


class _NoSpan:
    """The shared span of a recorder that is off."""
    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


NO_SPAN = _NoSpan()


class _Clock(_NoSpan):
    """A span that is not recorded but reads the clock for its caller."""
    __slots__ = ("start_ns", "end_ns")

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Span(_Clock):
    """A recorded span."""
    __slots__ = ("name", "id", "parent", "frame", "attrs", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._rf = None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else 0
        self.frame = self.attrs.pop(
            "frame", up.frame if up is not None else None)
        stack.append(self)
        if _profiling():
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        _done.append(SpanRecord(self.id, self.parent, self.name,
                                self.frame, self.start_ns, self.end_ns,
                                self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Adds attrs known only once the span is open."""
        self.attrs.update(attrs)

    def count(self, name: str, n: int = 1) -> None:
        _add(self.id, name, n)


def _add(sid: int, name: str, n: int) -> None:
    c = _counters.setdefault(sid, {})
    c[name] = c.get(name, 0) + n


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def span(name: str, clock: bool = False, **attrs):
    """A context manager timing one layer's work; see the module's
    docstring. With the recorder off it is the shared NO_SPAN, or, with
    clock=True, a span that only reads the clock (its `seconds`)."""
    if _on:
        return _Span(name, attrs)
    if clock:
        return _Clock()
    return NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name` of the innermost open span (of no span:
    id 0); nothing when the recorder is off."""
    if not _on:
        return
    st = _stack()
    _add(st[-1].id if st else 0, name, n)


def enabled() -> bool:
    """Whether spans are being recorded (for work done only to feed a
    counter or an attr)."""
    return _on


def enable() -> None:
    """Starts recording spans and counters."""
    global _on, _profiling, _record_function
    import torch
    from torch.autograd.profiler import record_function
    _profiling = torch.autograd._profiler_enabled
    _record_function = record_function
    _on = True


def disable() -> None:
    """Stops recording; spans open now are still recorded when they end."""
    global _on
    _on = False


def drain() -> tuple[list, dict]:
    """(spans, counters) recorded since the last drain, and forgets
    them: spans a list of SpanRecord tuples in order of their end,
    counters {span id: {name: total}}."""
    global _done, _counters
    spans, counters = _done, _counters
    _done, _counters = [], {}
    return spans, counters
