"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric come in as new files and new entries alone; and
a run's surface: its last lines, its exit without a card or without the
program, and no JAX in its process."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO, cell_result, run_py

NEW_METRIC = '''"""decoder.calls_per_s: feed_annexb calls that returned a
picture, per second of the window (a metric added as a new file)."""


def read(rec):
    if rec["side"] != "decode":
        return None
    return len(rec["latencies"]) / rec["window_s"]
'''


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_new_cell_config_mix_and_metric_from_new_files_only(tiny_root,
                                                            tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root, symlinks=True)
    (root / "benchmark" / "layers" / "decoder.calls_per_s.py").write_text(
        NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "decoder.calls_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "decoder parse",
        "moves": "decode_fps", "workloads": ["tinycabac.decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # every file the benchmark already has is as in the repository
    for p in (REPO / "benchmark").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            q = root / p.relative_to(REPO)
            assert digest(q) == digest(p), p
    orig = json.loads((REPO / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = {e["name"] for e in bench[key]}
        assert {e["name"] for e in orig[key]} <= names
    r = cell_result(root, "tinycabac.decode", 2**31 + 7, 2.0, trace=True)
    assert r["correct"], r["checks"]
    assert "decoder.calls_per_s" in r["metrics"]
    assert "decoder.parse_ms_per_frame" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_encode_cell_reports_its_metrics(tiny_root):
    r = cell_result(tiny_root, "tiny.encode", 99, 2.0)
    assert set(r["metrics"]) == {"encode_fps", "setup_s"}
    assert r["metrics"]["encode_fps"]["unit"] == "frames/s"
    assert r["attempted"] > 0 and r["failed"] == 0


def test_run_exits_without_a_card_and_prints_no_result():
    if _has_card():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cbp_720p30.decode", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    root = tmp_path / "bare"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = dict(os.environ, PYTHONPATH=str(root))
    code = ("from benchmark import run\n"
            "print(run.run('cbp_720p30.decode', 5, 1.0, False, "
            "device='cpu'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "openh264_tpu_torch" in res.stderr


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys, json\n"
            "from benchmark import run, checks\n"
            "r = run.run('tiny.decode', 3, 1.0, False, device='cpu')\n"
            "print(json.dumps(checks.forbidden_loaded(sys.modules)))\n")
    res = run_py(tiny_root, code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cbp_720p30.encode", "cbp_720p30.decode",
                                  "main_720p30_cabac.decode"])
def test_cell_runs_correct_on_the_card(cell):
    if not _has_card():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA path")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    r = json.loads(res.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
