"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with tiny cells (128x96 frames, GOPs of 8) added by
new files and entries only, as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
W, H = 128, 96
TINY = {"tiny": (False, 200_000), "tinycabac": (True, 300_000)}


def run_py(root: Path, code: str,
           timeout: int = 600) -> subprocess.CompletedProcess:
    """Runs `code` in a fresh interpreter whose `benchmark` package is
    the copy under root (the program comes from the repository)."""
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)


def cell_result(root: Path, cell: str, seed: int, seconds: float,
                trace: bool = False, control: bool = False,
                fault: str = "") -> dict:
    """One run of `cell` on the CPU in the copy under root, with an
    optional fault from faults.py planted in the program first."""
    code = (
        "import json, sys\n"
        "from benchmark.tests import faults\n"
        f"faults.plant({fault!r})\n"
        "from benchmark import run\n"
        f"r = run.run({cell!r}, {seed}, {seconds}, {trace}, device='cpu', "
        f"control={control})\n"
        "print(json.dumps(r))\n")
    res = run_py(root, code)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def add_tiny_cells(root: Path) -> None:
    """New configurations, streams, cells and limits for 128x96 frames,
    added beside the benchmark's own; no existing file is edited, and
    BENCHMARK.json only gains entries."""
    bdir = root / "benchmark"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((bdir / "configs" / "cbp_720p30.json").read_text())
    for name, (cabac, rate) in TINY.items():
        cfg = json.loads(json.dumps(base))
        cfg.update(name=name, width=W, height=H, stream=name)
        cfg["encoder"].update(entropy_cabac=cabac, target_bitrate=rate,
                              idr_interval=8,
                              profile_idc=77 if cabac else 66)
        (bdir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
    (bdir / "traffic" / "tiny_session.json").write_text(json.dumps(
        {"entry": "session_stream", "pool_frames": 8, "warmup_frames": 2,
         "trace": {"profile_from": 2, "profile_frames": 2}}))
    (bdir / "traffic" / "tiny_laps.json").write_text(json.dumps(
        {"entry": "decode_feed", "warmup_aus": 4,
         "trace": {"staged_share": 0.5, "profile_s": 0.5,
                   "profile_min_frames": 2}}))
    cells = {"tiny.encode": ("tiny", "tiny_session",
                             {"recon_max_abs_diff": 0,
                              "chain_pictures": 4}),
             "tiny.decode": ("tiny", "tiny_laps",
                             {"max_abs_diff": 0, "chain_pictures": 4,
                              "sample_pictures": 3}),
             "tinycabac.decode": ("tinycabac", "tiny_laps",
                                  {"max_abs_diff": 0, "chain_pictures": 3,
                                   "sample_pictures": 2}),
             "tiny.encode_api": ("tiny", "api_live",
                                 {"recon_max_abs_diff": 0,
                                  "chain_pictures": 4})}
    for name, (cfg, mix, lim) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1, "why": "t"})
        (bdir / "limits" / f"{name}.json").write_text(json.dumps(lim))
        for m in bench["end_to_end"] + bench["per_layer"]:
            side = "encode" if "encode" in name else "decode"
            moves = m.get("moves", m["name"])
            if "workloads" in m and side in moves.split("_")[0]:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    code = ("import sys\n"
            "from benchmark import make_streams\n"
            "make_streams.FRAMES = 24\n"
            "for n in ('tiny', 'tinycabac'):\n"
            "    sys.argv = ['make_streams', '--only', n]\n"
            "    make_streams.main()\n")
    res = run_py(root, code)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.264"))
    for p in (REPO / "benchmark" / "streams").glob("*.264"):
        os.symlink(p, root / "benchmark" / "streams" / p.name)
    add_tiny_cells(root)
    return root
