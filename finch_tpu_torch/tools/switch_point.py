"""Where `--backend auto`'s host fold stops paying: auto against torch on
the first N reads of a FASTQ, each run in a fresh process.

    python -m finch_tpu_torch.tools.switch_point FASTQ [-k K]
        [--reads N,N,...] [--repeat R]

For each N, the first N reads of FASTQ (copied into a temporary
directory) are sketched unfiltered (`--no-filter`, the CLI
defaults otherwise) by auto and by torch, each in a fresh process, R
times in turns (auto, torch, torch, auto, ...). A run's wall is that of
the one sketch_stream call: the imports are left out, the card's first
use in the process and a synchronize at the end are in. So torch's wall
holds the card's cold start, and auto's the host fold for as long as
HybridEngine keeps the stream on the host.

Prints the card (nvidia-smi's name and power limit), one JSON line a run
(reads, k-mers, backend, wall, whether the engine stayed on the host, the
first 16 hex digits of the .sk bytes' SHA-256) and then one line an N
with each backend's mean wall and auto over torch. Exits non-zero unless
both backends give the same bytes at every N.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = """
import hashlib, json, sys, time
from finch_tpu_torch import cli
from finch_tpu_torch.core.sketching import sketch_stream
from finch_tpu_torch.serialization.json_sk import multisketch_to_json_bytes
import torch
path, k, backend = sys.argv[1], sys.argv[2], sys.argv[3]
args = cli.build_cli().parse_args(["sketch", "-k", k, *sys.argv[4:], path,
                                   "-o", "unused"])
k = cli.get_kmer_length(args)
filters = cli.parse_filter_options(args, k)
params = cli.parse_sketch_options(args, k, filters.filter_on)
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


def fastq_head(src: str, dst: str, reads: int) -> str:
    """The first `reads` records of a 4-line FASTQ."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.writelines(itertools.islice(f, 4 * reads))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("-k", type=int, default=51)
    ap.add_argument("--reads", default="2000,5000,10000,20000,40000",
                    help="comma-separated read counts")
    ap.add_argument("--repeat", type=int, default=2,
                    help="fresh processes a backend and read count")
    opts = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for n in (int(x) for x in opts.reads.split(",")):
            path = fastq_head(opts.fastq, os.path.join(tmp, f"{n}.fq"), n)
            walls = {"auto": [], "torch": []}
            shas = set()
            for i in range(opts.repeat):
                for backend in ("auto", "torch")[::1 if i % 2 == 0 else -1]:
                    row = cold_wall(path, opts.k, backend, ["--no-filter"])
                    walls[backend].append(row["s"])
                    shas.add(row["sha"])
                    print(json.dumps({
                        "k": opts.k, "reads": n, "kmers": row["kmers"],
                        "backend": backend, "s": row["s"],
                        "host": row["host"], "sk_sha256": row["sha"][:16]}),
                        flush=True)
            auto, torch_ = (statistics.mean(walls[b]) for b in walls)
            ok &= len(shas) == 1
            print(json.dumps({"k": opts.k, "reads": n, "auto_s": auto,
                              "torch_s": torch_, "auto_over_torch":
                              auto / torch_, "sk_equal": len(shas) == 1}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
