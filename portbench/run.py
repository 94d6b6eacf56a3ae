"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>
    python3 -m portbench.run ...            (the same, from the repo root)

The cell's configuration, traffic mix, generator, entry and metric readers
are found by name (``portbench/harness.py``). The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each compared number with its limit). Without a card, or with
fewer cards than the cell asks for, it prints no result and exits 2.
"""

import time

_T0 = time.perf_counter()  # set-up is counted from here, before any import

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __package__ in (None, ""):
    # run as a script: import from the checkout's root, not portbench/
    sys.path[0] = str(ROOT)

# every build and kernel cache at a fixed path inside the checkout
_CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), t0=_T0)


if __name__ == "__main__":
    sys.exit(main())
