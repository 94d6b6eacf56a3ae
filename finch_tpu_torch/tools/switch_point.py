"""Where `--backend auto`'s host fold stops paying: auto against torch on
the first N reads of a FASTQ, in fresh processes (a cold card) or in one
warm process (`--warm`).

    python -m finch_tpu_torch.tools.switch_point FASTQ [-k K]
        [--reads N,N,...] [--repeat R] [--warm]

For each N, the first N reads of FASTQ (copied into a temporary
directory) are sketched unfiltered (`--no-filter`, the CLI defaults
otherwise). A run's wall is that of the one sketch_stream call: the
imports are left out, a synchronize at the end is in.

Fresh processes (the default; HybridEngine's cold switch point): auto
and torch, each in a fresh process, R times in turns (auto, torch, torch,
auto, ...). So torch's wall holds the card's cold start, and auto's the
host fold for as long as HybridEngine keeps the stream on the host.
Prints one JSON line a run (reads, k-mers, backend, wall, whether the
engine stayed on the host, the first 16 hex digits of the .sk bytes'
SHA-256) and then one line an N with each backend's mean wall and auto
over torch.

`--warm` (HybridEngine's warm switch point): everything in this process,
after one torch sketch of the largest head has warmed the card; then R
rounds an N of three runs in turns: `auto_cold` (auto with the card taken
as cold, so the host fold up to 4M k-mers), `torch` and `auto` (the
rule in force). One JSON line a run as above (`host` false where the
engine stepped on the card), one an N with each one's median wall and
torch over auto_cold, and last the smallest N at which torch's median
beat auto_cold's.

Prints the card (nvidia-smi's name and power limit) first. Exits
non-zero unless every run of an N gives the same bytes.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = """
import hashlib, json, sys, time
from finch_tpu_torch.core.sketching import sketch_stream
from finch_tpu_torch.serialization.json_sk import multisketch_to_json_bytes
from finch_tpu_torch.tools.switch_point import cli_params
import torch
path, k, backend = sys.argv[1], sys.argv[2], sys.argv[3]
params, filters = cli_params(path, k, sys.argv[4:])
engines = []
t = time.perf_counter()
sk = sketch_stream(path, path, params, filters, backend=backend,
                   device="cuda", engine_out=engines)
if torch.cuda.is_initialized():  # a host fold leaves the card untouched
    torch.cuda.synchronize()
secs = time.perf_counter() - t
e = engines[0] if engines else None  # none: the fused host fold
host = type(e).__name__ != "TorchEngine" and getattr(e, "_dev", None) is None
print(json.dumps({"s": secs, "kmers": sk.num_valid_kmers, "host": host,
                  "sha": hashlib.sha256(
                      multisketch_to_json_bytes([sk])).hexdigest()}))
"""


def cli_params(path: str, k, extra=()):
    """(SketchParams, FilterParams) of `finch sketch -k K *extra path`."""
    from finch_tpu_torch import cli

    args = cli.build_cli().parse_args(["sketch", "-k", str(k), *extra, path,
                                       "-o", "unused"])
    k = cli.get_kmer_length(args)
    filters = cli.parse_filter_options(args, k)
    return cli.parse_sketch_options(args, k, filters.filter_on), filters


def cold_wall(path: str, k: int, backend: str, extra=()) -> dict:
    """One sketch_stream call at the CLI's parameters (`extra` its further
    flags) in a fresh process: its wall `s` (imports left out, the card's
    first use and a final synchronize in), `kmers`, `host` (the engine
    never folded on the device) and the .sk bytes' SHA-256 `sha`."""
    res = subprocess.run([sys.executable, "-c", _CHILD, path, str(k),
                          backend, *extra], cwd=CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise AssertionError(f"fresh {backend} process failed: "
                             f"{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def cold_card():
    """HybridEngine as on a card this process has not stepped on: the
    host fold up to its cold switch point, whatever the card has run.

    It swaps the module function engine.card_is_warm for the whole
    process, so it is for tools and chip_smoke.py, around one sketch at a
    time: it must not wrap sketches that run beside others (sketch_files'
    pool, other threads), which would all take the cold rule."""
    from finch_tpu_torch.models import engine

    warm = engine.card_is_warm
    engine.card_is_warm = lambda dev: False
    try:
        yield
    finally:
        engine.card_is_warm = warm


def warm_wall(path: str, params, filters, backend: str,
              cold: bool = False) -> dict:
    """One sketch_stream call in this process, as cold_wall's row; with
    `cold`, under cold_card()."""
    import torch

    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    engines = []
    with cold_card() if cold else contextlib.nullcontext():
        t = time.perf_counter()
        sk = sketch_stream(path, path, params, filters, backend=backend,
                           device="cuda", engine_out=engines)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    e = engines[0]
    host = type(e).__name__ != "TorchEngine" and e._dev is None
    return {"s": secs, "kmers": sk.num_valid_kmers, "host": host,
            "sha": hashlib.sha256(
                multisketch_to_json_bytes([sk])).hexdigest()}


def fastq_head(src: str, dst: str, reads: int) -> str:
    """The first `reads` records of a 4-line FASTQ."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.writelines(itertools.islice(f, 4 * reads))
    return dst


def _print_run(k, n: int, label: str, row: dict) -> None:
    print(json.dumps({"k": k, "reads": n, "kmers": row["kmers"],
                      "backend": label, "s": row["s"], "host": row["host"],
                      "sk_sha256": row["sha"][:16]}), flush=True)


# the warm mode's three runs: label -> (backend, under cold_card())
WARM_RUNS = {"auto_cold": ("auto", True), "torch": ("torch", False),
             "auto": ("auto", False)}


def _warm(opts, heads) -> bool:
    """The warm mode's runs and lines; True when every N's bytes agree."""
    ok, point = True, None
    params, filters = cli_params(heads[-1][1], opts.k, ["--no-filter"])
    warm_wall(heads[-1][1], params, filters, "torch")  # the card warms
    for n, path in heads:
        walls = {label: [] for label in WARM_RUNS}
        shas = set()
        for i in range(opts.repeat):
            for label in list(WARM_RUNS)[::1 if i % 2 == 0 else -1]:
                backend, cold = WARM_RUNS[label]
                row = warm_wall(path, params, filters, backend, cold)
                walls[label].append(row["s"])
                shas.add(row["sha"])
                _print_run(opts.k, n, label, row)
        med = {b: statistics.median(w) for b, w in walls.items()}
        ok &= len(shas) == 1
        if point is None and med["torch"] < med["auto_cold"]:
            point = {"reads": n, "kmers": row["kmers"]}
        print(json.dumps({"k": opts.k, "reads": n, "kmers": row["kmers"],
                          **{f"{b}_s": v for b, v in med.items()},
                          "torch_over_auto_cold":
                          med["torch"] / med["auto_cold"],
                          "sk_equal": len(shas) == 1}), flush=True)
    print(json.dumps({"k": opts.k, "torch_wins_from": point}), flush=True)
    return ok


def _cold(opts, heads) -> bool:
    """The fresh-process mode's runs and lines; True when every N's bytes
    agree."""
    ok = True
    for n, path in heads:
        walls = {"auto": [], "torch": []}
        shas = set()
        for i in range(opts.repeat):
            for backend in ("auto", "torch")[::1 if i % 2 == 0 else -1]:
                row = cold_wall(path, opts.k, backend, ["--no-filter"])
                walls[backend].append(row["s"])
                shas.add(row["sha"])
                _print_run(opts.k, n, backend, row)
        auto, torch_ = (statistics.mean(walls[b]) for b in walls)
        ok &= len(shas) == 1
        print(json.dumps({"k": opts.k, "reads": n, "auto_s": auto,
                          "torch_s": torch_, "auto_over_torch":
                          auto / torch_, "sk_equal": len(shas) == 1}),
              flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("-k", type=int, default=51)
    ap.add_argument("--reads", default="2000,5000,10000,20000,40000",
                    help="comma-separated read counts")
    ap.add_argument("--repeat", type=int, default=2,
                    help="runs a backend and read count")
    ap.add_argument("--warm", action="store_true",
                    help="time in this process, on a warm card")
    opts = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        heads = [(n, fastq_head(opts.fastq, os.path.join(tmp, f"{n}.fq"), n))
                 for n in sorted(int(x) for x in opts.reads.split(","))]
        ok = (_warm if opts.warm else _cold)(opts, heads)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
