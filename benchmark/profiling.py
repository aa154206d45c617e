"""The traced run's device trace: torch.profiler over a steady
sub-window, reduced to plain intervals, and the arithmetic on them.

`capture` runs a block under the profiler; the Trace it yields holds
plain numbers, and the reductions below (busy time as the union of device
intervals, idle gaps labelled with the host operation that was running,
device time by name) are pure functions the CPU tests exercise on
synthetic intervals.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float                       # host wall of the sub-window
    # (name, start_s, end_s) relative to the sub-window's start
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)


def deblock_launches() -> int:
    """The port's count of deblock kernel launches so far."""
    from openh264_tpu_torch.encoder import deblock_cuda
    return deblock_cuda.launches


def capture(block, label: str = "window"):
    """Runs block() under torch.profiler (CPU and CUDA activity), the
    device synchronized at the end. Returns (block's result, a function
    that reduces the profile to a Trace, the deblock kernel's launches
    during the block). The reduction takes seconds for a large profile:
    the harness calls it after the window, not inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    n0 = deblock_launches()
    with profile(activities=acts) as prof:
        with record_function(label):
            t0 = time.perf_counter()
            out = block()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return out, lambda: _reduce(prof, label, wall), deblock_launches() - n0


def _reduce(prof, label: str, wall: float) -> Trace:
    """The profile's device and host operations as intervals relative to
    the start of the label's span."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev, host, spans = [], [], []
    for e in events:
        tr = e.time_range
        if e.name == label:               # the label's own span
            if e.device_type == DeviceType.CPU:
                spans.append(tr.start * 1e-6)
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        rec = (e.name[:NAME_CHARS], tr.start * 1e-6, tr.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    t_base = spans[0] if spans else min((h[1] for h in host), default=0)
    return Trace(wall, [(n, a - t_base, b - t_base) for n, a, b in dev],
                 [(n, a - t_base, b - t_base) for n, a, b in host])


def union(intervals):
    """Merged (start, end) pairs of a list of (start, end)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the sub-window in which some operation ran on the
    device."""
    lo, hi = 0.0, trace.window_s
    return sum(min(b, hi) - max(a, lo) for a, b in
               union([(a, b) for _, a, b in trace.device])
               if min(b, hi) > max(a, lo))


def idle_share_percent(trace: Trace) -> float | None:
    """100 x (1 - busy / sub-window wall); None without device events."""
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def device_seconds(trace: Trace, contains: str) -> float:
    """Device seconds of operations whose name contains `contains`."""
    return sum(b - a for n, a, b in trace.device if contains in n)


def top_device_ops(trace: Trace, n: int = 10):
    """[[name, seconds]] of the n device operations with most time."""
    tot: dict[str, float] = {}
    for name, a, b in trace.device:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(trace: Trace, n: int = 10):
    """[[label, seconds]]: the device's idle time in the sub-window,
    summed by the host operation running at each gap's middle (the
    innermost, i.e. shortest, one recorded), the n largest."""
    import numpy as np
    busy = union([(a, b) for _, a, b in trace.device])
    gaps, t = [], 0.0
    for a, b in busy + [(trace.window_s, trace.window_s)]:
        a = min(a, trace.window_s)
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if not gaps:
        return []
    mids = np.array([0.5 * (a + b) for a, b in gaps])
    order = np.argsort(mids)
    mids = mids[order]
    best = np.full(len(mids), np.inf)       # duration of the innermost op
    who = np.full(len(mids), -1)
    for k, (_, ha, hb) in enumerate(trace.host):
        i0, i1 = np.searchsorted(mids, [ha, hb], side="left")[0], \
            np.searchsorted(mids, hb, side="right")
        if i1 > i0:
            sl = slice(i0, i1)
            inner = (hb - ha) < best[sl]
            best[sl] = np.where(inner, hb - ha, best[sl])
            who[sl] = np.where(inner, k, who[sl])
    tot: dict[str, float] = {}
    lens = np.array([b - a for a, b in gaps])[order]
    for w, d in zip(who.tolist(), lens.tolist()):
        label = trace.host[w][0] if w >= 0 else "(host Python, no operation)"
        tot[label] = tot.get(label, 0.0) + d
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:n]]
