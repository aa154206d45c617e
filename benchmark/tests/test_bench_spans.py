"""benchmark/spans.py on synthetic spans and intervals: self time, per
frame sums, launches under a span, the idle time by the innermost
program span, the annotations kept from a profile (the CUDA row's
copies neither spans nor busy time); then span_report.py on the tiny
CPU cells, where each of the twelve span metrics is read in the cells
whose path it times."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark import profiling, spans
from benchmark.tests.conftest import run_py

MS = 1_000_000


def rec(i, parent, name, frame, a_ms, b_ms, **attrs):
    from openh264_tpu_torch.utils.trace import SpanRecord
    return SpanRecord(i, parent, name, frame, a_ms * MS, b_ms * MS, attrs)


def api_frames():
    """Two API frames: 100 ms and 80 ms, of which the encoder takes 90
    and 70, its writer 20 and 10, its fetches 5 + 5 and 4."""
    return [
        rec(3, 2, "encoder.fetch", 0, 10, 15),
        rec(4, 2, "encoder.write", 0, 20, 40, bits=800),
        rec(5, 2, "encoder.fetch", 0, 50, 55),
        rec(2, 1, "encoder.frame", 0, 5, 95, idr=False, skipped=False),
        rec(1, 0, "api.encode_frame", 0, 0, 100, skipped=False),
        rec(8, 7, "encoder.fetch", 1, 110, 114),
        rec(9, 7, "encoder.write", 1, 120, 130, bits=400),
        rec(7, 6, "encoder.frame", 1, 105, 175, idr=False, skipped=False),
        rec(6, 0, "api.encode_frame", 1, 100, 180, skipped=False),
    ]


def test_self_time_and_sums_per_frame():
    sp = api_frames()
    own = spans.self_ns(sp)
    assert own[1] == 10 * MS and own[6] == 10 * MS
    assert own[2] == (90 - 5 - 20 - 5) * MS
    assert spans.total_ms(sp, "encoder.fetch") == pytest.approx(14.0)
    assert spans.total_ms(sp, "encoder.frame", self_time=True) == \
        pytest.approx(60 + 56)
    assert spans.frames_of(sp, "api.encode_frame") == 2
    m = spans.metrics(sp)
    assert m["api.overhead_ms_per_frame"] == pytest.approx((10 + 10) / 2)
    assert m["encoder.control_ms_per_frame"] == pytest.approx(116 / 2)
    assert m["encoder.fetch_ms_per_frame"] == pytest.approx(7.0)
    assert m["encoder.write_ms_per_frame"] == pytest.approx(15.0)
    # no dispatch or deblock span: those metrics are not read
    assert "encoder.dispatch_ms_per_frame" not in m
    assert not any(k.startswith(("session.", "decoder.")) for k in m)


def test_skipped_frames_do_not_count_and_decoder_metrics():
    sp = [rec(1, 0, "decoder.feed", None, 0, 50),
          rec(3, 2, "decoder.parse", 0, 2, 10, mbs=4),
          rec(5, 4, "recon.intra", 0, 12, 20),
          rec(6, 4, "recon.inter", 0, 10, 12),
          rec(4, 2, "decoder.recon", 0, 10, 22),
          rec(8, 7, "deblock.bs", 0, 23, 26),
          rec(9, 7, "deblock.kernel", 0, 26, 27),
          rec(7, 2, "decoder.deblock", 0, 22, 28),
          rec(10, 2, "decoder.output", 0, 28, 30),
          rec(2, 1, "decoder.picture", 0, 1, 40),
          # a bS under the encoder's deblock is not the decoder's
          rec(12, 11, "deblock.bs", None, 60, 70),
          rec(11, 0, "encoder.deblock", None, 60, 71),
          rec(13, 0, "session.launch", 5, 80, 90, skipped=True)]
    m = spans.metrics(sp)
    assert m["decoder.control_ms_per_frame"] == pytest.approx(
        (50 - 39) + (39 - 8 - 12 - 6 - 2))
    assert m["decoder.intra_recon_ms_per_frame"] == pytest.approx(8.0)
    assert m["decoder.bs_ms_per_frame"] == pytest.approx(3.0)
    assert spans.frames_of(sp, "session.launch") == 0
    assert spans.frame_counters(sp, {2: {"skip": 3, "inter": 1}, 1: {"x": 1}},
                                "decoder.picture") == {"skip": 3, "inter": 1}


def test_coverage_by_root_spans():
    sp = api_frames() + [rec(20, 0, "api.encode_frame", 2, 190, 200)]
    assert spans.coverage(sp, 0, 200 * MS) == pytest.approx(190 / 200)
    assert spans.coverage(sp, 50 * MS, 150 * MS) == pytest.approx(1.0)
    assert spans.coverage(sp, 5, 5) is None


def span_trace():
    # device busy 0-1, 3-4 and 8-9 of a 10-s window; program spans
    # launch 0-5 holding core 0.5-2.5 and entropy 2.5-4.5; fetch 6-9
    # holding nothing; no span over 5-6 and 9-10
    return spans.SpanTrace(
        window_s=10.0,
        device=[("k", 0.0, 1.0), ("k", 3.0, 4.0), ("deblock", 8.0, 9.0)],
        host=[("cudaLaunchKernel", 0.6, 0.61), ("cudaLaunchKernel", 1.0,
                                                1.01),
              ("cudaLaunchKernel", 2.6, 2.61), ("aten::add", 2.7, 2.8),
              ("cudaLaunchKernel", 5.5, 5.51),
              ("cudaLaunchKernel", 6.1, 6.11),
              ("cudaLaunchKernel", 12.0, 12.01)],
        spans=[("session.launch", 0.0, 5.0), ("session.core", 0.5, 2.5),
               ("session.entropy", 2.5, 4.5), ("session.fetch", 6.0, 9.0)])


def test_idle_by_innermost_span():
    t = span_trace()
    rows = dict(spans.idle_by_span(t))
    # gaps 1-3 (middle 2: core), 4-8 (middle 6: fetch), 9-10 (none)
    assert rows == {"session.fetch": pytest.approx(4.0),
                    "session.core": pytest.approx(2.0),
                    spans.NO_SPAN: pytest.approx(1.0)}
    assert sum(rows.values()) == pytest.approx(
        t.window_s - profiling.busy_s(t))
    assert spans.idle_by_span(t, n=1) == [["session.fetch",
                                           pytest.approx(4.0)]]


def test_launches_under_a_span():
    t = span_trace()
    assert spans.events_under(t, "session.launch") == 3
    assert spans.events_under(t, "session.core") == 2
    assert spans.events_under(t, "session.fetch") == 1
    assert spans.events_under(t, "session.wait_input") == 0
    assert spans.spans_in_window(t, "session.launch") == 1
    sp = [rec(1, 0, "session.launch", 0, 0, 5000, skipped=False)]
    assert spans.metrics(sp, t)["session.launches_per_frame"] == 3
    assert "session.launches_per_frame" not in spans.metrics(sp)


def test_annotations_keep_the_cpu_row_only():
    from torch.autograd import DeviceType

    def ev(name, dev, a_us, b_us):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a_us,
                                                          end=b_us))
    events = [ev("span_window", DeviceType.CPU, 1000, 9000),
              ev("session.launch", DeviceType.CPU, 1500, 4000),
              # the CUDA row's copy of the same annotation
              ev("session.launch", DeviceType.CUDA, 1600, 6000),
              ev("aten::add", DeviceType.CPU, 2000, 2100)]
    got = spans.annotations(events, {"session.launch", "span_window"},
                            "span_window")
    assert got == [("session.launch", pytest.approx(0.5e-3),
                    pytest.approx(3.0e-3))]
    # through reduce, with a profiler that does not mark annotations:
    # the CUDA-row copy is neither a span nor busy time
    events.append(ev("deblock_rows", DeviceType.CUDA, 2000, 3000))
    t = spans.reduce(SimpleNamespace(events=lambda: events), 0.008,
                     {"session.launch"})
    assert t.spans == got
    assert t.device == [("deblock_rows", pytest.approx(1e-3),
                         pytest.approx(2e-3))]
    assert [h[0] for h in t.host] == ["aten::add"]
    assert profiling.busy_s(t) == pytest.approx(0.001)


def test_reduce_on_a_cpu_profile():
    from openh264_tpu_torch.utils import trace
    import torch

    def work():
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(64).add_(1)
    trace.enable()
    try:
        _, prof, wall = spans.capture(work)
    finally:
        trace.disable()
    recs, _ = trace.drain()
    t = spans.reduce(prof, wall, {s.name for s in recs})
    assert sorted(n for n, _, _ in t.spans) == ["inner", "outer"]
    (o,) = [s for s in t.spans if s[0] == "outer"]
    (i,) = [s for s in t.spans if s[0] == "inner"]
    assert 0 <= o[1] <= i[1] <= i[2] <= o[2]
    assert not any(n in ("inner", "outer") for n, _, _ in t.host)
    assert any(n.startswith("aten::") and o[1] <= a <= o[2]
               for n, a, _ in t.host)


# the cells of the tiny copy and the span metrics each must read
CELL_METRICS = {
    "tiny.encode": ("session.core_ms_per_frame",
                    "session.entropy_ms_per_frame"),
    "tiny.encode_api": ("api.overhead_ms_per_frame",
                        "encoder.control_ms_per_frame",
                        "encoder.dispatch_ms_per_frame",
                        "encoder.fetch_ms_per_frame",
                        "encoder.write_ms_per_frame",
                        "encoder.deblock_ms_per_frame"),
    "tiny.decode": ("decoder.control_ms_per_frame",
                    "decoder.intra_recon_ms_per_frame",
                    "decoder.bs_ms_per_frame"),
}


@pytest.mark.parametrize("cell", list(CELL_METRICS))
def test_span_report_on_the_tiny_cells(tiny_root, cell):
    code = ("import json\n"
            "from benchmark import span_report\n"
            f"r = span_report.report({cell!r}, 5000000011, 1.5, 1.0, 1, "
            "device='cpu')\n"
            "print(json.dumps(r))\n")
    res = run_py(tiny_root, code)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    want = set(CELL_METRICS[cell])
    assert want <= set(r["metrics"]), r["metrics"]
    others = set().union(*CELL_METRICS.values()) - want
    assert not others & set(r["metrics"])
    assert all(v >= 0 for v in r["metrics"].values())
    assert r["frames"] >= 1
    assert r["coverage"] >= 0.95
    idle = dict(r["profiled"]["idle_spans"])
    assert idle.get(spans.NO_SPAN, 0.0) <= 0.05 * sum(idle.values())
    assert r["span_ns"]["off"] < r["span_ns"]["on"]
    assert len(r["overhead"]["off"]) == len(r["overhead"]["on"]) == 1
