#!/usr/bin/env python3
"""Runs one cell once with its control in the program's place, on the
card; the control has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

The controls break one guarantee that the configurations state:
- decode cells: the plain reference without its deblocking filter
  (the configurations state the in-loop filter on) puts its pictures
  in the program's place, from the same reference pictures;
- encode cells: the encoder's in-loop deblocking filter made the
  identity while its slices still say the filter is on.
Prints the run's result object like run.py; the benchmark's own runs
never run a control.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Runs one cell's control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from benchmark import run
    result = run.run(args.workload, args.seed, args.seconds, trace=False,
                     control=True)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
