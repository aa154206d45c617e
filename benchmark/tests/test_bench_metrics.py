"""The metric arithmetic: rates over the whole window, the 95th
percentile over all pictures, the device's idle share from profiler
intervals, the roofline counts, and which metrics a cell reports."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from benchmark import profiling, roofline, run

HERE = Path(__file__).resolve().parents[1]


def reader(folder: str, name: str):
    return run.load_module(HERE / folder / f"{name}.py").read


def test_encode_rate_is_over_the_whole_window():
    rec = {"side": "encode", "frames_in": 150, "window_s": 31.25}
    assert reader("end_to_end", "encode_fps")(rec) == pytest.approx(4.8)
    assert reader("end_to_end", "decode_fps")(rec) is None


def test_decode_rate_and_p95_are_over_all_pictures():
    lat = [0.040] * 190 + [0.100] * 10          # 5% slow pictures
    rec = {"side": "decode", "latencies": lat, "window_s": 10.0}
    assert reader("end_to_end", "decode_fps")(rec) == pytest.approx(20.0)
    p95 = reader("end_to_end", "decode_frame_p95_ms")(rec)
    assert p95 == pytest.approx(1e3 * np.percentile(lat, 95))
    assert 40.0 < p95 < 100.0
    assert reader("end_to_end", "encode_fps")(rec) is None


def test_per_frame_host_timers():
    rec = {"side": "decode", "staged_frames": 4,
           "stage_seconds": {"parse": 0.2, "inter_intra_recon": 0.1,
                             "deblock": 0.04}}
    assert reader("layers", "decoder.parse_ms_per_frame")(rec) == \
        pytest.approx(50.0)
    assert reader("layers", "decoder.deblock_ms_per_frame")(rec) == \
        pytest.approx(10.0)
    enc = {"side": "encode", "stats": {"launch_s": 1.5, "fetch_s": 0.03,
                                       "frames": 10}}
    assert reader("layers", "session.launch_ms_per_frame")(enc) == \
        pytest.approx(150.0)
    assert reader("layers", "session.fetch_ms_per_frame")(enc) == \
        pytest.approx(3.0)


def synthetic_trace():
    # device busy 0-1, 0.5-2 (overlapping), 4-5 and past the end 9.5-11;
    # host ops around the gaps 2-4 and 5-9.5
    return profiling.Trace(
        window_s=10.0,
        device=[("k1", 0.0, 1.0), ("deblock_rows", 0.5, 2.0),
                ("k2", 4.0, 5.0), ("deblock_rows", 9.5, 11.0)],
        host=[("window", 0.0, 10.0), ("aten::item", 1.9, 4.1),
              ("cudaStreamSynchronize", 5.0, 9.0)])


def test_idle_share_from_the_union_of_device_intervals():
    t = synthetic_trace()
    assert profiling.busy_s(t) == pytest.approx(2.0 + 1.0 + 0.5)
    assert profiling.idle_share_percent(t) == pytest.approx(65.0)
    assert profiling.idle_share_percent(profiling.Trace(1.0)) is None


def test_breakdown_lists():
    t = synthetic_trace()
    ops = dict(profiling.top_device_ops(t))
    assert ops["deblock_rows"] == pytest.approx(3.0)
    gaps = dict(profiling.idle_gaps(t))
    assert gaps["aten::item"] == pytest.approx(2.0)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(4.5)
    assert profiling.device_seconds(t, "deblock") == pytest.approx(3.0)


def test_roofline_counts_at_720p():
    assert roofline.deblock_frame_bytes(80, 45, 2) == 3_254_400
    assert roofline.deblock_frame_bytes(80, 45, 5) == 3_297_600
    ops_s = roofline.deblock_frame_ops_max(80, 45) / roofline.SCALAR_OPS_PER_S
    bytes_s = 3_254_400 / roofline.HBM_BYTES_PER_S
    assert ops_s < bytes_s
    assert roofline.deblock_frame_bound_s(80, 45, 2) == pytest.approx(bytes_s)
    # 8 frames in 8 x 0.34 ms of kernel time: ~0.29% of the roofline
    share = roofline.roofline_percent(8, 8 * 0.34e-3, 80, 45, 2)
    assert share == pytest.approx(100 * bytes_s / 0.34e-3)
    assert roofline.roofline_percent(0, 1.0, 80, 45, 2) is None


def test_roofline_reader_counts_frames_over_kernel_time():
    # the harness's own count of frames; the program's launch counter
    # is a diagnostic and does not enter
    rec = {"side": "encode", "trace": synthetic_trace(),
           "profiled_frames": 2, "diagnostics": {"deblock_launches": 4},
           "mb_w": 80, "mb_h": 45}
    got = reader("layers", "kernel.deblock_roofline.encode")(rec)
    assert got == pytest.approx(roofline.roofline_percent(2, 3.0, 80, 45, 2))
    assert reader("layers", "kernel.deblock_roofline.decode")(rec) is None


def test_metrics_of_a_cell():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(bench, "end_to_end",
                                                 w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = run.metrics_of(bench, "per_layer", w["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
        for m in layers:
            assert (HERE / "layers" / f"{m['name']}.py").exists()
        for name in e2e:
            assert (HERE / "end_to_end" / f"{name}.py").exists()


def test_spread_is_the_quartile_distance_over_the_median():
    # the rule the bounds were set by (PERF.md section 2)
    vals = [4.8, 5.0, 5.1, 4.9, 5.2, 5.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert (q3 - q1) / statistics.median(vals) == pytest.approx(
        (5.125 - 4.875) / 5.0)
