"""`finch sketch` over every card of the machine against one card.

    python finch_tpu_torch/tools/mesh_cards.py FASTQ [--pairs N]
        [--against DIR]

Sketches FASTQ at the CLI defaults with the torch backend (TorchEngine on
cuda:0), the mesh backend (ShardedSketchEngine over every card, one shard
a card, as `--backend mesh` takes it) and the auto backend (what `finch
sketch` takes by default: the mesh where several cards are present,
HybridEngine on cuda:0 where one is; so on several cards it times the
route again), after one warm-up run of each, in turns: torch, mesh, auto,
auto, mesh, torch, ... for N rounds. Every run ends with a synchronize of
every card.
Prints the cards (nvidia-smi's name and power limit), then one JSON line
a run: the backend, its wall in seconds, the engine's host syncs and,
where the engine counts them, the values its shards asked the host for
(`shard_reads`), its steps by tier, and the first 16 hex digits of the
.sk bytes' SHA-256;
then one more mesh run under torch.profiler (`profile_mesh`: each
stream's busy time and the time two or more streams, so two or more
cards, were busy at once); last, one JSON line a backend with the median
wall of the timed runs.

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


def medians(rows, keys) -> list:
    """One line for each group of timed runs (warm-ups left out)."""
    groups = {}
    for r in rows:
        if r["run"] != "warm-up":
            groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    return [{**dict(zip(keys, key)),
             "median_s": statistics.median(r["s"] for r in rs),
             "runs_s": [r["s"] for r in rs],
             "syncs": sorted({r["syncs"] for r in rs}),
             "shard_reads": sorted({str(r["shard_reads"]) for r in rs})}
            for key, rs in groups.items()]


def _busy(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


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
    busy = {sid: _busy(iv) for sid, iv in by_stream.items()}
    edges = sorted((t, d) for iv in busy.values() for a, b in iv
                   for t, d in ((a, 1), (b, -1)))
    active, last, any_s, two_s = 0, None, 0.0, 0.0
    for t, d in edges:
        if last is not None:
            any_s += (t - last) * (active >= 1)
            two_s += (t - last) * (active >= 2)
        active, last = active + d, t
    return {"streams": {sid: sum(b - a for a, b in iv) / 1e6
                        for sid, iv in sorted(busy.items())},
            "kernel_streams": sorted(kernel_streams),
            "busy_s": any_s / 1e6, "overlap_s": two_s / 1e6,
            "top": sorted(([n, ms, c] for n, (ms, c) in by_name.items()),
                          key=lambda r: -r[1])[:6]}


def against(opts) -> int:
    rows = []
    for label in ("against", "this", "this", "against"):
        root = opts.against if label == "against" else CHECKOUT
        env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), opts.fastq,
             "--pairs", str(opts.pairs)], env=env, capture_output=True,
            text=True)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("--pairs", type=int, default=3,
                    help="timed rounds of (torch, mesh, auto) after the "
                         "warm-up")
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout to run in turns with this one")
    opts = ap.parse_args(argv)
    if opts.against:
        return against(opts)

    import torch

    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 2
    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
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
            "sk_sha256": hashlib.sha256(got).hexdigest()[:16]})
        print(json.dumps(rows[-1]), flush=True)
        if rows[-1]["sk_sha256"] != rows[0]["sk_sha256"]:
            raise AssertionError(f"{backend}: .sk differs from the first "
                                 "run's")

    backends = ("torch", "mesh", "auto")
    for backend in backends:
        run(backend, "warm-up")
    for i in range(opts.pairs):
        for backend in (backends if i % 2 == 0 else backends[::-1]):
            run(backend, f"round {i}")
    # the mesh once more under torch.profiler, untimed: how long its cards
    # were busy at once
    prof = profile_mesh(lambda: sketch_stream(
        opts.fastq, opts.fastq, params, filters, backend="mesh",
        device="cuda"), ("extract_", "dedup_"))
    print(json.dumps({"profile": "mesh", **prof}), flush=True)
    for m in medians(rows, ("backend",)):
        print(json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
