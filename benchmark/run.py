#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once, on the card it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Everything is found by name. The cell (BENCHMARK.json "workloads")
names a configuration, benchmark/configs/<config>.json, and a traffic
mix, benchmark/traffic/<mix>.json, whose "entry" names the driver of the
program's entry point, benchmark/entries/<entry>.py. The cell's limits
are in benchmark/limits/<cell>.json, each end-to-end metric's reader in
benchmark/end_to_end/<metric>.py and each per-layer metric's in
benchmark/layers/<metric>.py; each reader takes the window's record and
returns a number, or None when it finds nothing to read. An entry
driver has setup(cell), window(state, seconds, trace), close(state),
which takes what the check needs from the program's state and drops it,
and check(state, record).

A run: set-up (imports, the card, the inputs made from the seed, the
warm-up of the cell's shapes), the window of --seconds, the import
check, then the comparison with the plain reference (benchmark/compare,
benchmark/reference). It prints the comparison's numbers as its last
lines on standard error and, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics (the end-to-end
metrics, or with --trace 1 the per-layer ones read from the traced
run), device, with --trace 1 breakdown, and last checks. Without a
CUDA card, or with fewer than the cell asks for, it exits 3 and prints
no result; with JAX or the JAX package loaded, 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path):
    """The Python module at `path`, loaded under a name of its own."""
    name = "bench_" + "_".join(path.relative_to(HERE).with_suffix("").parts
                               ).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration, mix and
    limits loaded."""

    def __init__(self, bench: dict, name: str, seed: int, device: str,
                 control: bool = False):
        spec = {w["name"]: w for w in bench["workloads"]}[name]
        cfg_file = {c["name"]: c["file"] for c in bench["configs"]
                    }[spec["config"]]
        self.name = name
        self.chips = spec["chips"]
        self.config = json.loads((ROOT / cfg_file).read_text())
        self.mix = json.loads((HERE / "traffic" / f"{spec['traffic']}.json"
                               ).read_text())
        self.limits = json.loads((HERE / "limits" / f"{name}.json"
                                  ).read_text())
        self.seed = seed
        self.device = device
        self.control = control

    def sync(self):
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.synchronize()


def metrics_of(bench: dict, key: str, cell: str) -> list[dict]:
    """The metrics of BENCHMARK.json[key] that `cell` reports: those
    whose "workloads" name it, and those without "workloads"."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def read_metrics(specs, folder: str, rec: dict) -> dict:
    out = {}
    for m in specs:
        v = load_module(HERE / folder / f"{m['name']}.py").read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(cell: Cell) -> dict:
    import torch
    if not cell.device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(cell.chips))}


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False) -> dict | None:
    """One run of a cell; returns the result object (None when the card
    is missing). device="cpu" skips the look for a card (CPU tests);
    control=True puts the cell's control in the program's place
    (benchmark/control.py)."""
    from benchmark import checks, profiling
    # every build and kernel cache of the program inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, name, seed, device, control)
    import torch
    if device.startswith("cuda") and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"benchmark: cell {name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return None
    entry = load_module(HERE / "entries" / f"{cell.mix['entry']}.py")
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    state = entry.setup(cell)
    setup_s = time.perf_counter() - T_START
    rec = entry.window(state, seconds, trace)
    cell.sync()
    if callable(rec.get("trace")):          # reduced after the window
        rec["trace"] = rec["trace"]()
    dev = device_info(cell)
    rec.update(setup_s=setup_s, mb_w=(cell.config["width"] + 15) // 16,
               mb_h=(cell.config["height"] + 15) // 16)
    key, folder = (("per_layer", "layers") if trace
                   else ("end_to_end", "end_to_end"))
    metrics = read_metrics(metrics_of(bench, key, name), folder, rec)
    # the program's state goes before the reference runs
    entry.close(state)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, errors, bad = entry.check(state, rec)
    print(f"reference seconds {time.perf_counter() - t_ref:.3f}",
          file=sys.stderr)
    loaded = checks.forbidden_loaded(sys.modules)
    if loaded:
        print("benchmark: the run loaded JAX or the JAX package: "
              + ", ".join(loaded), file=sys.stderr)
        sys.exit(4)
    correct = all(ok for *_, ok in numbers)
    result = {"correct": correct,
              "attempted": rec.get("frames_in", len(rec.get("latencies",
                                                            []))),
              "failed": bad,
              "metrics": metrics, "device": dev}
    if trace and rec.get("trace") is not None:
        t = rec["trace"]
        result["device"].update(busy_s=profiling.busy_s(t),
                                window_s=t.window_s)
        result["breakdown"] = {"device_ops": profiling.top_device_ops(t),
                               "idle_gaps": profiling.idle_gaps(t)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim, _ in numbers}
    for k, v in rec.get("diagnostics", {}).items():
        print(f"diagnostic {k} {v}", file=sys.stderr)
    for e in errors[:5]:
        print(f"reference: {e}", file=sys.stderr)
    for n, v, lim, ok in numbers:
        print(f"check {n} {v} limit {lim} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Runs one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
