#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json with the program's span recorder
(openh264_tpu_torch/utils/trace.py) on, and prints what the spans show.

    python3 benchmark/span_report.py --workload <cell> --seed <n>
        --seconds <s> [--profile-seconds <p>] [--overhead <k>]

Set-up is run.py's (the cell's entry driver, benchmark/entries/). Then
the entry's plain window (as with --trace 0) runs three times: for
--profile-seconds under torch.profiler with the recorder on, for
--seconds with the recorder alone, and, with --overhead k, k more pairs
of --seconds, the recorder off then on, each read by the cell's
end-to-end rate (benchmark/end_to_end/). It prints one JSON object as
its last line:

- metrics: benchmark/spans.py's METRICS, the times from the
  recorder-only window, the launches from the profiled one;
- idle_spans: the profiled window's device idle time by the innermost
  program span (spans.idle_by_span), beside profiling.idle_gaps' host
  operations (idle_gaps) and the device's busy seconds;
- coverage: the share of the recorder-only window's wall time inside a
  root span;
- self_ms_per_frame: each span name's self time per frame (a dispatch
  span's by its `core` attr), and the frame spans' counters per frame;
- span_ns: one span's cost off and on (no profiler), spans per frame;
- overhead: the rate of each window, off and on.

It never runs in a benchmark cell; run.py does not read it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the frame span of each side: its spans per frame count the frames
FRAME_SPANS = ("api.encode_frame", "encoder.frame", "session.launch",
               "decoder.picture")


def span_cost_ns(n: int = 200_000) -> dict:
    """Nanoseconds of one empty `with trace.span(...)` off and on."""
    from openh264_tpu_torch.utils import trace
    out = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost", frame=0):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        trace.disable()
        trace.drain()
    return out


def frames_in(spans) -> int:
    """Frames of the run: those of its outermost frame span."""
    from benchmark import spans as sp
    for name in FRAME_SPANS:
        f = sp.frames_of(spans, name)
        if f:
            return f
    return 0


def self_per_frame(spans, counters, frames: int) -> dict:
    from benchmark import spans as sp
    own = sp.self_ns(spans)
    tot: dict = {}
    for s in spans:
        # the dispatch spans apart by the core they enqueue
        k = s.name + (f"[{s.attrs['core']}]" if "core" in s.attrs else "")
        tot[k] = tot.get(k, 0) + own[s.id]
    out = {k: 1e-6 * v / frames for k, v in sorted(tot.items(),
                                                    key=lambda kv: -kv[1])}
    for name in FRAME_SPANS:
        c = sp.frame_counters(spans, counters, name)
        if c:
            out[name + ".counters"] = {k: v / frames for k, v in c.items()}
    return out


def report(name: str, seed: int, seconds: float, profile_s: float,
           overhead: int, device: str = "cuda") -> dict:
    from benchmark import profiling, run
    from benchmark import spans as sp
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(bench, name, seed, device)
    entry = run.load_module(HERE / "entries" / f"{cell.mix['entry']}.py")
    rate = [run.load_module(HERE / "end_to_end" / f"{m['name']}.py")
            for m in run.metrics_of(bench, "end_to_end", name)
            if m["name"] in ("encode_fps", "decode_fps")][0]
    from openh264_tpu_torch.utils import trace
    state = entry.setup(cell)
    out = {"cell": name, "seed": seed, "setup_s": time.perf_counter()
           - T_START, "span_ns": span_cost_ns()}

    trace.enable()
    _, prof, wall = sp.capture(
        lambda: entry.window(state, profile_s, False))
    trace.disable()
    p_spans, _ = trace.drain()
    t = sp.reduce(prof, wall, {s.name for s in p_spans})
    del prof

    trace.enable()
    t0 = time.perf_counter_ns()
    rec = entry.window(state, seconds, False)
    cell.sync()
    t1 = time.perf_counter_ns()
    trace.disable()
    spans, counters = trace.drain()
    frames = frames_in(spans)
    out["metrics"] = sp.metrics(spans)
    launches = sp.metrics(p_spans, t).get("session.launches_per_frame")
    if launches is not None:
        out["metrics"]["session.launches_per_frame"] = launches
    out["rate_on"] = rate.read(rec)
    out["frames"] = frames
    out["coverage"] = sp.coverage(spans, t0, t1)
    out["span_ns"]["per_frame"] = len(spans) / frames if frames else None
    out["self_ms_per_frame"] = self_per_frame(spans, counters, frames)
    out["profiled"] = {
        "window_s": t.window_s, "busy_s": profiling.busy_s(t),
        "frames": frames_in(p_spans),
        "idle_spans": sp.idle_by_span(t),
        "idle_gaps": profiling.idle_gaps(t)}
    rates = {"off": [], "on": []}
    for _ in range(overhead):
        for on in (False, True):
            (trace.enable if on else trace.disable)()
            rec = entry.window(state, seconds, False)
            cell.sync()
            trace.disable()
            trace.drain()
            rates["on" if on else "off"].append(rate.read(rec))
    if overhead:
        out["overhead"] = rates
    entry.close(state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile-seconds", type=float, default=3.0)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = report(a.workload, a.seed, a.seconds, a.profile_seconds,
                 a.overhead, a.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
