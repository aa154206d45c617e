"""The program's spans (openh264_tpu_torch/utils/trace.py) read against a
run: pure functions over the recorder's drained spans and counters and
over a profiled sub-window's intervals, which the CPU tests exercise on
synthetic data.

Two views of one set of spans: the recorder's own records
(trace.drain(): SpanRecord tuples on time.perf_counter_ns, with frame
ids, attrs and counters) give times per frame; the profiler's copies of
the same spans (each span enters torch.profiler's record_function while
a profile is active) lie on the device trace's own clock, so the idle
time of the card can be put under the innermost program span that was
open, by the rule profiling.idle_gaps uses for host operations.

`capture` and `reduce` are profiling.capture with the program's spans
kept: a SpanTrace is a profiling.Trace with a `spans` list, the CPU-row
user annotations other than the window's label. The CUDA-row copies of the
annotations (gpu_user_annotation) are neither spans nor device time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import profiling

NO_SPAN = "(no program span)"
LAUNCH = "cudaLaunchKernel"


@dataclass
class SpanTrace(profiling.Trace):
    # (name, start_s, end_s) of the program's spans, relative to the
    # sub-window's start like `device` and `host`
    spans: list = field(default_factory=list)


def capture(block, label: str = "span_window"):
    """Runs block() under torch.profiler (CPU and CUDA activity), the
    device synchronized at the end, as profiling.capture does. Returns
    (block's result, the profile, the block's wall seconds) for
    `reduce`, which the caller runs after the measured work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(label):
            t0 = time.perf_counter()
            out = block()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return out, prof, wall


def reduce(prof, wall: float, names, label: str = "span_window"
           ) -> SpanTrace:
    """The profile as a SpanTrace: profiling._reduce's device and host
    intervals without the program's spans, whose names are `names`
    (those of trace.drain()), and those spans apart. (profiling._reduce
    drops user annotations where the profiler marks them; the names
    keep them out of the device's busy time where it does not.)"""
    names = set(names)
    t = profiling._reduce(prof, label, wall)
    return SpanTrace(t.window_s, [d for d in t.device if d[0] not in names],
                     [h for h in t.host if h[0] not in names],
                     annotations(prof.events(), names, label))


def annotations(events, names, label: str):
    """(name, start_s, end_s) of the CPU-row events named in `names`,
    relative to the start of the label's CPU span (as
    profiling._reduce places the device and host operations)."""
    from torch.autograd import DeviceType
    names = set(names) - {label}
    base, out = None, []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue                    # the CUDA row's copies
        tr = e.time_range
        if e.name == label:
            base = tr.start * 1e-6 if base is None else base
        elif e.name in names:
            out.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    base = base if base is not None else min((a for _, a, _ in out),
                                             default=0.0)
    return [(n, a - base, b - base) for n, a, b in out]


# ---------------------------------------------------------------------------
# The recorder's records
# ---------------------------------------------------------------------------
def durations_ns(spans) -> dict:
    """Span id -> its duration."""
    return {s.id: s.end_ns - s.start_ns for s in spans}


def self_ns(spans) -> dict:
    """Span id -> its self time: its duration less its children's."""
    own = durations_ns(spans)
    out = dict(own)
    for s in spans:
        if s.parent in out:
            out[s.parent] -= own[s.id]
    return out


def total_ms(spans, name: str, self_time: bool = False,
             under: str | None = None) -> float:
    """Milliseconds of the spans named `name` (their self time with
    self_time), only those whose parent is named `under` if given."""
    t = self_ns(spans) if self_time else durations_ns(spans)
    parent = {s.id: s.name for s in spans}
    return 1e-6 * sum(t[s.id] for s in spans if s.name == name and (
        under is None or parent.get(s.parent) == under))


def frames_of(spans, name: str) -> int:
    """The distinct frame ids of spans named `name` that were not
    skipped by rate control."""
    return len({s.frame for s in spans
                if s.name == name and not s.attrs.get("skipped")})


def per_frame(spans, frames: int, name: str, **kw) -> float | None:
    """total_ms(spans, name, **kw) per frame; None without frames or
    without such spans."""
    if not frames or not any(s.name == name for s in spans):
        return None
    return total_ms(spans, name, **kw) / frames


def frame_counters(spans, counters, name: str) -> dict:
    """{counter: total} over the spans named `name`."""
    out: dict = {}
    for s in spans:
        if s.name == name:
            for k, v in counters.get(s.id, {}).items():
                out[k] = out.get(k, 0) + v
    return out


def coverage(spans, start_ns: int, end_ns: int) -> float | None:
    """The share of [start_ns, end_ns] inside some root span (a span
    without a parent)."""
    if end_ns <= start_ns:
        return None
    roots = [(max(s.start_ns, start_ns), min(s.end_ns, end_ns))
             for s in spans if s.parent == 0]
    inside = sum(b - a for a, b in profiling.union(roots) if b > a)
    return inside / (end_ns - start_ns)


# ---------------------------------------------------------------------------
# The profiled sub-window
# ---------------------------------------------------------------------------
def idle_by_span(trace: SpanTrace, n: int | None = None):
    """[[span name, seconds]]: the sub-window's idle time on the device,
    summed by the innermost (shortest) program span that covers each
    gap's middle, NO_SPAN where none does; the n largest (all without
    n)."""
    as_host = profiling.Trace(trace.window_s, trace.device, trace.spans)
    rows = profiling.idle_gaps(as_host, n=len(trace.spans) + 1)
    rows = [[NO_SPAN if k == "(host Python, no operation)" else k, v]
            for k, v in rows]
    return rows if n is None else rows[:n]


def events_under(trace: SpanTrace, span: str, event: str = LAUNCH) -> int:
    """Host events named `event` that start inside a span named `span`
    in the sub-window."""
    iv = profiling.union([(a, b) for k, a, b in trace.spans if k == span])
    if not iv:
        return 0
    lo = np.array([a for a, _ in iv])
    hi = np.array([b for _, b in iv])
    starts = np.array([a for k, a, _ in trace.host if k == event])
    if not len(starts):
        return 0
    i = np.searchsorted(lo, starts, side="right") - 1
    return int(np.count_nonzero((i >= 0) & (starts <= hi[np.clip(i, 0,
                                                                  None)])))


def spans_in_window(trace: SpanTrace, span: str) -> int:
    """Spans named `span` that start inside the sub-window."""
    return sum(1 for k, a, _ in trace.spans
               if k == span and 0.0 <= a < trace.window_s)


# ---------------------------------------------------------------------------
# The per-layer metrics the spans give (ms per frame coded or picture
# returned; launches per frame), by the spans each reads
# ---------------------------------------------------------------------------
def _api(spans, f, _trace):
    """What the API adds to the encoder: api.encode_frame less its
    encoder.frame (its statistics and the per-frame PSNR download)."""
    if not f or not any(s.name == "api.encode_frame" for s in spans):
        return None
    return (total_ms(spans, "api.encode_frame")
            - total_ms(spans, "encoder.frame", under="api.encode_frame")) / f


def _decoder_control(spans, f, _trace):
    if not f:
        return None
    return (total_ms(spans, "decoder.feed", self_time=True)
            + total_ms(spans, "decoder.picture", self_time=True)) / f


def _launches(spans, f, trace):
    if trace is None:
        return None
    n = spans_in_window(trace, "session.launch")
    return events_under(trace, "session.launch") / n if n else None


def _sum(name: str, **kw):
    return lambda spans, f, _trace: per_frame(spans, f, name, **kw)


# name -> (the frame span that counts the frames, the reader)
METRICS = {
    "api.overhead_ms_per_frame": ("api.encode_frame", _api),
    "encoder.control_ms_per_frame": ("encoder.frame",
                                     _sum("encoder.frame", self_time=True)),
    "encoder.dispatch_ms_per_frame": ("encoder.frame",
                                      _sum("encoder.dispatch")),
    "encoder.fetch_ms_per_frame": ("encoder.frame", _sum("encoder.fetch")),
    "encoder.write_ms_per_frame": ("encoder.frame", _sum("encoder.write")),
    "encoder.deblock_ms_per_frame": ("encoder.frame",
                                     _sum("encoder.deblock")),
    "session.core_ms_per_frame": ("session.launch", _sum("session.core")),
    "session.entropy_ms_per_frame": ("session.launch",
                                     _sum("session.entropy")),
    "session.launches_per_frame": ("session.launch", _launches),
    "decoder.control_ms_per_frame": ("decoder.picture", _decoder_control),
    "decoder.intra_recon_ms_per_frame": ("decoder.picture",
                                         _sum("recon.intra")),
    "decoder.bs_ms_per_frame": ("decoder.picture",
                                _sum("deblock.bs", under="decoder.deblock")),
}


def metrics(spans, trace: SpanTrace | None = None) -> dict:
    """{metric: value} of METRICS that the spans give: times from the
    recorder's records, launches from the profiled sub-window."""
    out = {}
    for name, (frame_span, fn) in METRICS.items():
        f = frames_of(spans, frame_span)
        if not f:
            continue
        v = fn(spans, f, trace)
        if v is not None:
            out[name] = v
    return out
