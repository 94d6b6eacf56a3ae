"""`finch sketch` over every card of the machine against one card.

    python finch_tpu_torch/tools/mesh_cards.py FASTQ [--pairs N]
        [--backends B,B,...] [--fresh] [--no-trace] [--against DIR]

Sketches FASTQ at the CLI defaults with the torch backend (TorchEngine on
cuda:0), the mesh backend (as `--backend mesh` takes it: over several
cards the process mesh, one worker process a card; the lockstep
ShardedSketchEngine in checkouts before it) and the auto backend (what
`finch sketch` takes by default: the mesh where several cards are
present, HybridEngine on cuda:0 where one is; so on several cards it
times the route again), after one warm-up run of each, in turns: torch,
mesh, auto, auto, mesh, torch, ... for N rounds (`--backends` picks
which). Every run ends with a synchronize of every card.
Prints the cards (nvidia-smi's name and power limit), then the parse
alone (`parse_alone`: the file through the fill-in-place reader into two
reused buffers, no engine), then one JSON line a run: the
backend, its wall in seconds, the engine's host syncs and, where the
engine counts them, the values its shards asked the host for
(`shard_reads`), its steps by tier, the process mesh's pool start-up
(`pool_startup_s`, the same pool for every run after the first), and the
first 16 hex digits of the .sk bytes' SHA-256;
then one more mesh run, traced: the process mesh's workers each record
their device work under torch.profiler on time.monotonic_ns, which every
process of the host shares (the parent's profiler cannot see them); the
lockstep runs under the parent's torch.profiler (`profile_mesh`). Either
way: each card's busy time and the time two or more cards were busy at
once (`--no-trace` leaves this run out). Last, one JSON line a backend
with the median wall of the timed runs.

--fresh times `python -m finch_tpu_torch.cli sketch FASTQ -o OUT
--backend B` in a new process a run, start-up included (what a user
waits for): backends torch, mesh and auto1 (auto with only cuda:0
visible: HybridEngine on one card, what auto runs where the mesh is not
taken) by default, N rounds in turns; each run's wall is the child's
from start to exit.

--against DIR compares this checkout with another one (DIR, the root of
an unpacked checkout): the script runs itself in four processes, DIR's
package, this one's, this one's, DIR's (PYTHONPATH picks the package),
labels each line with the checkout and ends with each checkout's and
backend's median over both of its processes. Exits non-zero unless every
run's .sk bytes are the same.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def parse_alone(path: str, k: int = 21, batch_size: int = 1 << 21) -> dict:
    """The parse alone: `path` through the reader sketch_stream would
    choose (composite planes, every core) into two reused buffers by its
    fill in place, no engine. Its wall `s`, `kmers` and `batches`. A
    checkout whose readers cannot fill in place (`fill` false) iterates
    them, fresh arrays a batch."""
    import numpy as np

    from finch_tpu_torch.core.sketching import _choose_reader

    lo = np.empty(batch_size, dtype=np.uint32)
    hi = np.empty(batch_size, dtype=np.uint32)
    t = time.perf_counter()
    reader = _choose_reader(path, k, True, batch_size, composite=True)
    fill = hasattr(reader, "fill")
    sizes = (iter(lambda: reader.fill(lo, hi), 0) if fill
             else (len(a) for a, _ in reader))
    kmers = batches = 0
    for n in sizes:
        kmers += n
        batches += 1
    reader.close()
    return {"s": time.perf_counter() - t, "kmers": kmers,
            "batches": batches, "reader": type(reader).__name__,
            "fill": fill}


def medians(rows, keys) -> list:
    """One line for each group of timed runs (warm-ups left out)."""
    groups = {}
    for r in rows:
        if r["run"] != "warm-up":
            groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    return [{**dict(zip(keys, key)),
             "median_s": statistics.median(r["s"] for r in rs),
             "runs_s": [r["s"] for r in rs],
             "syncs": sorted({str(r.get("syncs")) for r in rs}),
             "shard_reads": sorted({str(r.get("shard_reads")) for r in rs})}
            for key, rs in groups.items()]


def busy_overlap(interval_lists) -> tuple[float, float]:
    """(busy, overlap): the time any of the lists' (start, end) intervals
    covered, and the time two or more lists did at once (each list is
    first merged into disjoint intervals), in the intervals' unit."""
    edges = []
    for intervals in interval_lists:
        merged = []
        for a, b in sorted(intervals):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges += [e for a, b in merged for e in ((a, 1), (b, -1))]
    active, last, busy, two = 0, None, 0, 0
    for t, d in sorted(edges):
        if last is not None:
            busy += (t - last) * (active >= 1)
            two += (t - last) * (active >= 2)
        active, last = active + d, t
    return busy, two


def profile_mesh(fn, kernels=()) -> dict:
    """fn() once under torch.profiler. Returns, in seconds of the
    profiled run: `streams`, each device stream's busy time (the
    union of its kernels, copies and sets; `cuda:<card>/<trace stream
    id>`; the record_function ranges the trace mirrors onto the card
    are left out);
    `kernel_streams`, the streams that ran a kernel whose name holds one
    of `kernels`; `busy_s`, the time any stream was busy, and
    `overlap_s`, the time two or more were; `top`, the six names of
    device work that took the most time ([name, ms, count]; summed over
    every card and stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_stream, kernel_streams, by_name = {}, set(), {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            if e.is_user_annotation:
                # a record_function range mirrored onto the card's
                # timeline, from its first kernel to its last: no work
                continue
            sid = f"cuda:{e.device_index}/{e.device_resource_id}"
            by_stream.setdefault(sid, []).append(
                (e.time_range.start, e.time_range.end))
            if any(k in e.name for k in kernels):
                kernel_streams.add(sid)
            ms, count = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3,
                                    count + 1)
    any_us, two_us = busy_overlap(by_stream.values())
    return {"streams": {sid: busy_overlap([iv])[0] / 1e6
                        for sid, iv in sorted(by_stream.items())},
            "kernel_streams": sorted(kernel_streams),
            "busy_s": any_us / 1e6, "overlap_s": two_us / 1e6,
            "top": sorted(([n, ms, c] for n, (ms, c) in by_name.items()),
                          key=lambda r: -r[1])[:6]}


def trace_mesh(fastq: str, params, filters, cards: int) -> dict:
    """One mesh run, traced. The process mesh (this checkout, several
    cards): every worker's device work from its own torch.profiler, on
    time.monotonic_ns; `busy_s` the time any card was busy, `overlap_s`
    the time two or more were, `cards` each worker's busy time, `wall_s`
    the traced run's wall. Otherwise the lockstep under this process's
    profiler (profile_mesh)."""
    from finch_tpu_torch.core import sketching

    try:
        from finch_tpu_torch.parallel.process_mesh import ProcessMeshEngine
    except ImportError:  # a checkout before the process mesh
        ProcessMeshEngine = None
    if ProcessMeshEngine is None or cards < 2:
        return profile_mesh(lambda: sketching.sketch_stream(
            fastq, fastq, params, filters, backend="mesh",
            device="cuda"), ("extract_", "dedup_"))
    import torch

    made = []
    make = sketching._make_engine
    sketching._make_engine = lambda p, *a, **kw: made.append(
        ProcessMeshEngine(p, [torch.device("cuda", i) for i in
                              range(cards)], trace=True)) or made[-1]
    try:
        t = time.perf_counter()
        sketching.sketch_stream(fastq, fastq, params, filters,
                                backend="mesh", device="cuda")
        wall = time.perf_counter() - t
    finally:
        sketching._make_engine = make
    intervals = made[0].stats["intervals"]
    busy, two = busy_overlap(intervals)
    return {"wall_s": wall, "busy_s": busy / 1e9, "overlap_s": two / 1e9,
            "cards": [busy_overlap([iv])[0] / 1e9 for iv in intervals],
            "worker_steps": made[0].stats["worker_steps"]}


def against(opts) -> int:
    rows = []
    for label in ("against", "this", "this", "against"):
        root = opts.against if label == "against" else CHECKOUT
        env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), opts.fastq,
             "--pairs", str(opts.pairs), *(["--fresh"] if opts.fresh
                                           else []),
             *(["--backends", opts.backends] if opts.backends else []),
             *(["--no-trace"] if opts.no_trace else [])],
            env=env, capture_output=True, text=True)
        sys.stderr.write(out.stderr)
        for line in out.stdout.splitlines():
            if line.startswith('{"run"'):
                row = {"checkout": label, **json.loads(line)}
                rows.append(row)
                print(json.dumps(row), flush=True)
            else:
                print(f"[{label}] {line}", flush=True)
        if out.returncode:
            print(f"{label} ({root}) exited {out.returncode}")
            return out.returncode
    for m in medians(rows, ("checkout", "backend")):
        print(json.dumps(m))
    shas = {r["sk_sha256"] for r in rows}
    print(json.dumps({"sk_sha256": sorted(shas), "sk_equal": len(shas) == 1}))
    return 0 if len(shas) == 1 else 1


def fresh(opts, smi: str) -> int:
    """--fresh: each run a new `python -m finch_tpu_torch.cli sketch`
    process, its wall from start to exit."""
    import tempfile

    backends = (opts.backends or "torch,mesh,auto1").split(",")
    shas = set()
    with tempfile.TemporaryDirectory() as tmp:
        rows = []
        for i in range(opts.pairs):
            for backend in (backends if i % 2 == 0 else backends[::-1]):
                env = dict(os.environ)
                if backend == "auto1":
                    env["CUDA_VISIBLE_DEVICES"] = "0"
                out = os.path.join(tmp, backend)
                t = time.perf_counter()
                subprocess.run(
                    [sys.executable, "-m", "finch_tpu_torch.cli", "sketch",
                     opts.fastq, "-o", out, "--backend",
                     "auto" if backend == "auto1" else backend],
                    env=env, check=True, capture_output=True)
                secs = time.perf_counter() - t
                with open(f"{out}.sk", "rb") as f:
                    sha = hashlib.sha256(f.read()).hexdigest()[:16]
                shas.add(sha)
                rows.append({"run": f"round {i}", "backend": backend,
                             "fresh": True, "s": secs, "sk_sha256": sha})
                print(json.dumps(rows[-1]), flush=True)
    print(smi)
    for m in medians(rows, ("backend",)):
        print(json.dumps(m))
    return 0 if len(shas) == 1 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("--pairs", type=int, default=3,
                    help="timed rounds of the backends after the warm-up")
    ap.add_argument("--backends", help="comma-separated backends (default "
                    "torch,mesh,auto; with --fresh torch,mesh,auto1)")
    ap.add_argument("--fresh", action="store_true",
                    help="each run in a new CLI process, start-up included")
    ap.add_argument("--no-trace", action="store_true",
                    help="leave out the traced mesh run")
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout to run in turns with this one")
    opts = ap.parse_args(argv)
    if opts.against:
        return against(opts)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if opts.fresh:
        return fresh(opts, smi)

    import torch

    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 2
    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    cards = torch.cuda.device_count()
    print(f"{cards} cards; finch_tpu_torch from "
          f"{sys.modules['finch_tpu_torch'].__file__}")
    print(smi)
    args = cli.build_cli().parse_args(["sketch", opts.fastq, "-o", "unused"])
    k = cli.get_kmer_length(args)
    filters = cli.parse_filter_options(args, k)
    params = cli.parse_sketch_options(args, k, filters.filter_on)

    def sync():
        for i in range(cards):
            torch.cuda.synchronize(i)

    print(json.dumps({"parse_alone": 0, **parse_alone(opts.fastq, k)}),
          flush=True)
    rows = []

    def run(backend: str, label: str) -> None:
        engines = []
        sync()
        t = time.perf_counter()
        sk = sketch_stream(opts.fastq, opts.fastq, params, filters,
                           backend=backend, device="cuda",
                           engine_out=engines)
        sync()
        secs = time.perf_counter() - t
        got = multisketch_to_json_bytes([sk])
        stats = engines[0].stats
        rows.append({
            "run": label, "backend": backend, "cards": cards,
            "shards": getattr(engines[0], "n", 1), "s": secs,
            "kmers": sk.num_valid_kmers, "syncs": stats.get("syncs"),
            "shard_reads": stats.get("shard_reads"),
            "tiers": {n: c for n, c in sorted(stats.items())
                      if n.startswith("tier_")},
            "worker_steps": stats.get("worker_steps"),
            "times": stats.get("times"),
            "pool_startup_s": getattr(getattr(engines[0], "pool", None),
                                      "startup_s", None),
            "pool_startup_phases": getattr(getattr(
                engines[0], "pool", None), "startup_phases", None),
            "sk_sha256": hashlib.sha256(got).hexdigest()[:16]})
        print(json.dumps(rows[-1]), flush=True)
        if rows[-1]["sk_sha256"] != rows[0]["sk_sha256"]:
            raise AssertionError(f"{backend}: .sk differs from the first "
                                 "run's")

    backends = tuple((opts.backends or "torch,mesh,auto").split(","))
    for backend in backends:
        run(backend, "warm-up")
    for i in range(opts.pairs):
        for backend in (backends if i % 2 == 0 else backends[::-1]):
            run(backend, f"round {i}")
    # the mesh once more, traced and untimed: how long its cards were busy
    # at once
    if not opts.no_trace:
        print(json.dumps({"profile": "mesh", **trace_mesh(
            opts.fastq, params, filters, cards)}), flush=True)
    for m in medians(rows, ("backend",)):
        print(json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
