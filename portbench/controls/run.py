"""Read the control of a cell at its own size, on several seeds.

    python3 -m portbench.controls.run --workload <cell> --seeds 1 2 3 \
        [--device cuda]

Prints one JSON line a seed: the numbers that decide `correct`, as the
control gives them (each has the limit 0 in a run). Not part of a
benchmark run. A cell's control is ``portbench/controls/<entry>.py``,
found by the name of its configuration's entry: ``numbers(config,
traffic, data, device) -> {name: value}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    gen = bench.load("gen", cell.traffic["generator"])
    control = bench.load("controls", cell.config["entry"])
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="portbench-ctl-") as wd:
            t = time.perf_counter()
            data = gen.generate(cell.config, cell.traffic, seed, Path(wd))
            nums = control.numbers(cell.config, cell.traffic, data,
                                   args.device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": nums,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
