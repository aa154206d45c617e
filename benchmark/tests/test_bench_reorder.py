"""The decode cell whose pictures come out reordered
(entries/decode_reorder.py, chains.py, reference/decoder_b.py), on the
CPU: a tiny cell over the small x264 B-pyramid stream of the tier-1
tests, added as new files and entries only; its run is correct, its
control and a planted fault are not, a traced run reads the new
per-layer metrics; and the check's (lap, GOP, POC) matching and chains
on a state made by hand."""

from __future__ import annotations

import json
import shutil
from types import SimpleNamespace

import pytest

from benchmark.tests.conftest import REPO, cell_result

SEED = 2**31 + 4242
CELL = "tinyx264.decode"


@pytest.fixture(scope="module")
def x264_root(tiny_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("x264") / "copy"
    shutil.copytree(tiny_root, root, symlinks=True)
    bdir = root / "benchmark"
    src = REPO / "tests" / "data" / "x264_high_320x192_pyramid"
    shutil.copy(src.with_suffix(".264"), bdir / "streams" / "tinyx264.264")
    shutil.copy(src.with_suffix(".json"), bdir / "streams" / "tinyx264.json")
    cfg = json.loads((bdir / "configs" / "hls_1080p30_high.json").read_text())
    cfg.update(name="tinyx264", width=320, height=192, stream="tinyx264")
    (bdir / "configs" / "tinyx264.json").write_text(json.dumps(cfg))
    (bdir / "traffic" / "tiny_laps_reorder.json").write_text(json.dumps(
        {"entry": "decode_reorder", "warmup_aus": 4,
         "trace": {"staged_share": 0.5, "profile_s": 0.5,
                   "profile_min_frames": 2}}))
    (bdir / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"max_abs_diff": 0, "chain_pictures": 12}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyx264", "source": "test",
                             "file": "benchmark/configs/tinyx264.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tinyx264",
                               "traffic": "tiny_laps_reorder", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hls_1080p30_high.decode" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_reorder_cell_is_correct(x264_root):
    r = cell_result(x264_root, CELL, SEED, 4.0)
    assert r["correct"], r["checks"]
    assert r["checks"]["pictures_checked"]["value"] >= 4
    assert set(r["metrics"]) == {"decode_fps", "setup_s"}


def test_reorder_control_and_fault_are_not_correct(x264_root):
    r = cell_result(x264_root, CELL, SEED + 1, 3.0, control=True)
    assert not r["correct"] and r["checks"]["max_abs_diff"]["value"] > 0
    for fault in ("decode_altered", "decode_stale"):
        r = cell_result(x264_root, CELL, SEED + 2, 3.0, fault=fault)
        assert not r["correct"], (fault, r["checks"])


def test_reorder_traced_run_reads_the_span_metrics(x264_root):
    r = cell_result(x264_root, CELL, SEED + 3, 6.0, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert {"decoder.b_parse_ms_per_frame", "decoder.python_parse_us_per_mb",
            "decoder.parse_ms_per_frame"} <= set(m), m
    assert all(v["value"] > 0 for v in m.values())


def _entry():
    from benchmark import run
    return run.load_module(run.HERE / "entries" / "decode_reorder.py")


def test_chains_and_matching_by_lap_gop_and_poc():
    """GOPs of 5 access units fed in laps: a chain for each GOP instance
    whose first chain_pictures access units include one fed in the
    window, cut to those fed; the program's pictures of that instance by
    POC; and the POCs the program should have returned."""
    entry = _entry()
    gops = [[bytes([g, i]) for i in range(5)] for g in range(3)]
    s = SimpleNamespace(
        gops=gops, param_sets=b"PS", warm=3, gop_of=[2, 0, 1],
        cell=SimpleNamespace(seed=SEED, limits={"chain_pictures": 4}))
    s.fed = [(0, i) for i in range(5)] + [(1, i) for i in range(5)] + \
        [(2, 0), (2, 1)]
    s.pictures = {(0, 0): "a", (0, 4): "b", (1, 2): "c", (2, 0): "d"}
    s.last_poc = {0: 8, 1: 6, 2: 0}
    todo = entry.jobs(s)
    assert [i for i, _ in todo] == [0, 1, 2]
    (aus0, got0), (aus2, got2) = todo[0][1], todo[2][1]
    assert aus0 == [b"PS" + gops[2][0]] + gops[2][1:4]
    assert aus2 == [b"PS" + gops[1][0], gops[1][1]]
    assert got0 == {0: "a", 4: "b"} and got2 == {0: "d"}
    # an instance whose first access units were all fed before the
    # window holds none of its pictures
    s.warm = 8
    assert [i for i, _ in entry.jobs(s)] == [1, 2]
    # an earlier instance is done once a later one returned pictures
    assert entry.expected(s, 1, [0, 2, 4, 6, 8]) == {0, 2, 4, 6, 8}
    assert entry.expected(s, 2, [0, 2, 4]) == {0}
    del s.last_poc[2]
    assert entry.expected(s, 2, [0, 2]) == set()
