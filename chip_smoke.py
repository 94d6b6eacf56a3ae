#!/usr/bin/env python3
"""Smoke run of finch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card. It builds
every kernel of the port from the sources in the checkout (one nvcc per
source, all at once), holds each kernel against its plain PyTorch version
at the engines' 2M-lane batch, at 4M and at the [mesh] shards' 128k to 1M
(exact equality: the outputs are integers), reproduces the frozen goldens
through the port's CLI on the card, and then drives these paths:

* [main] sketches a simulated bacterial-isolate sequencing run (a 5 Mbp
  random genome, 150 bp reads at 30x coverage, 0.5% substitutions, half
  the reads reverse-complemented: about 1M reads and 130M 21-mers) at the
  CLI defaults four ways: the native host fold, an independent
  implementation; the auto backend as on a cold card
  (switch_point.cold_card(), as a fresh `finch sketch` runs it: the host
  fold of the first 4M k-mers, then one migration of that state to the
  card); the torch backend on the card; and auto again, on the now warm
  card, which must start there from an empty state and fold nothing on
  the host. The four .sk byte strings must be identical. The parse alone (the
  file through the fill-in-place reader into two reused buffers, no
  engine) is timed three times. Then an A/B of the torch backend against
  the A/B/C-only configuration (sketch_step absorb=False,
  dedup_tier=False), five pairs in turns.
* [dup] folds the two duplicate-burst streams of bench.py, 64 batches of
  2M lanes each, from a cold state and from a warmed one, at the
  CLI-default sketch parameters: a 64x tile of 32768 random composites
  (copies share a column) and the same multiset permuted across lanes.
  TorchEngine on the card, in the default configuration and in the
  A/B/C-only one (five pairs in turns), and NativeEngine must give
  identical sketches.

* [dist] runs `finch dist` at DB scale through calc_sketch_distances on
  the card: all-vs-all over 10,000 sketches of 1,000 hashes, clustered
  (benchmarks/bench_dist10k.py's recipe, --max-dist 0.3, about 1M
  surviving pairs: the Gram engine and the survivors pass) and disjoint
  (the bandwidth-bound control), and 64 queries against the clustered DB
  (the tile engine). Each cell is held against an independent host Gram
  (scipy.sparse), the host below counts and the serial distance() on
  2,000 sampled pairs, and prints pairs/s and each phase's device time
  from torch.profiler. Then the full-matrix path at 4,000 sketches, and
  the CLI's `dist -p` over a 128-sketch file against --backend numpy.
  [dist] launches none of the kernels below: the distance path has none.
* [wide] sketches [main]'s isolate at k = 51 (sourmash's largest standard
  k; about 100M 51-mers) at the CLI defaults otherwise: the torch
  backend on the card (the two-word wide step, ops/bottomk_wide.py), the
  native host fold and auto twice, as on a cold card (cold_card(): the
  host fold of the first 4M k-mers, then one migration of that state) and
  on the warm card (the same wide step from the first batch). The four
  .sk byte strings must be identical; auto's walls are printed over
  torch's. The first 20,000 reads (about 2M 51-mers, below the cold
  switch point) go through auto, which in this process (a warm card)
  must move to the card before its first batch, and in fresh processes
  (a cold card) must stay on the host, each equal to native's bytes;
  auto and torch are timed on that file in fresh processes, where torch
  pays the card's cold start. auto's first three batches under the cold
  rule and a TorchEngine's are timed one by one. One more torch run under
  the port's profiler hook (utils.trace) gives the card's busy share and each
  wide.<phase> range's device time. Then the first 8 batches of 2M lanes
  fold with TorchEngine on the card and on the CPU, mash and scaled (the
  scaled state grows): the raw states must be bit-equal after every
  batch. Last, k = 101 over the first 20,000 reads: torch (a host fold by
  design) and native must give the same bytes. The wide path reaches no
  TPU kernel, so it has no hand kernel and launches none of the four.
* [mesh] drives the mesh layer (finch_tpu_torch.parallel) on the one
  card, over 4 logical shards of cuda:0: the isolate through
  ShardedSketchEngine in 512k-lane shards (the .sk must equal [main]'s
  native bytes; the extract and D launch), the CLI's `--backend mesh`
  (a one-card mesh here), a scaled run over the first 100,000 reads that
  grows every shard, dup64 steady (16 batches of 2M lanes after a warm
  fold that takes each shard to [dup]'s steady threshold: the weighted
  extract and D2 launch; == NativeEngine), the process-local mode over a
  real NCCL group of world size 1 (2 shards of 512k lanes, the first
  200,000 reads), the distance mesh forms on [dist]'s clustered DB
  (sharded_common == all_pairs_common, all_vs_all_arrays(mesh=) == the
  unsharded tiles). Each sketch path's launches are counted on their own,
  and every shard width a kernel ran at must be one [kernels] held it at.
  The mesh steps its shards in lockstep, one host wait a round for every
  shard's read: the isolate must make at most half as many host syncs as
  its shards made reads, and its wall is printed over the torch
  backend's on the same file just after. The shards share one card, so
  no traffic between cards and no concurrency of cards is measured.
  Then the process mesh (parallel/process_mesh.py): 4 worker processes
  on cuda:0 (logical cards), its pool's start-up printed, the isolate
  through sketch_stream (.sk == native's; the workers' summed launches
  held to their summed tiers; its wall over the torch backend's just
  after), and a worker killed mid-stream, which must make the parent
  raise within 60 s and leave no process and no shared memory.

Each kernel's launch counter is zeroed just before each run and read just
after, and must equal the steps that by the tier switch's rules launch
that kernel. Every phase raises on failure and the script exits non-zero.
Without a card, or without the finch_tpu_torch package beside it, it fails
before printing any result. The last lines are the card (nvidia-smi), one
JSON line with each kernel's numbers, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM figures. Memory: NVIDIA's data sheet. Integer
# instructions: an SM issues at most one warp instruction per scheduler per
# clock, 4 x 32 = 128 thread-instructions; the integer ALU pipe takes 64 of
# them per clock and integer multiply-adds issue on the FMA pipes beside it
# (CUDA C Programming Guide, throughput table for compute capability 9.0),
# so 128 per clock per SM is the ceiling for a mix of integer ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLK_PER_SM = 128

B_MAIN = 1 << 22  # the main path's extract shape: 4M lanes
K_MAIN = 21
GENOME_BP = 5_000_000  # a bacterial isolate
COVERAGE = 30


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

def extract_int_ops(k: int, b: int, kept: int, slab_real: int) -> int:
    """The fewest INT32 instructions the extract function needs for this
    input, whatever csrc/extract.cu happens to issue. 64-bit values in
    32-bit halves: a multiply by a constant 3 (IMAD.WIDE.U32 + 2 IMAD),
    `* 5 + c` 2, an add, xor, rotate or compare 2, `x ^= x >> 33` 2 (the
    high half is unchanged), `^= k` 1.

    per lane: ASCII word assembly 6 per 4 bases (extract their 8 code
      bits, spread them into 4 byte-permute selector nibbles, one PRMT
      from the "ACGT" byte table) + murmur (32 per 16-byte block, 10 per
      tail half, 32 finalization) + 4 (padding and threshold tests);
    per surviving lane: 4 (row encode, and the one compare any selection
      of the 8 smallest needs at least);
    per slab row written: 2 (the + 1);
    per real slab entry: 2 (at least one compare in the column merge)."""
    nb, t = divmod(k, 16)
    murmur = 32 * nb + (10 if t > 8 else 0) + (10 if t > 0 else 0) + 32
    per_lane = 6 * -(-k // 4) + murmur + 4
    return b * per_lane + kept * 4 + (b // 4) * 2 + slab_real * 2


def extract_bytes(b: int) -> int:
    """Each input read once, each output written once: the u32 lo/hi
    planes (8 B/lane), the u32 hash planes (8 B/lane), the slab
    (b/4 x 8 B), cand (65536 x 8 B), the threshold and the flags."""
    return 8 * b + 8 * b + (b // 4) * 8 + 32 * 2048 * 8 + 8 + 8


def extract_weighted_int_ops(k: int, b: int, kept: int, slab_real: int,
                             heads: int) -> int:
    """The weighted extract's fewest INT32 instructions: the unweighted
    function's (extract_int_ops; its one compare per real slab entry also
    finds the entry's equal, since the distinct values are kept sorted)
    plus 4 per real cand entry (the (count - 1) << (2k+2) fold: a 64-bit
    shift in halves and an add with carry). Bytes as extract_bytes."""
    return extract_int_ops(k, b, kept, slab_real) + 4 * heads


def dedup_int_ops(b: int, kept: int, heads: int) -> int:
    """Tier D's fewest INT32 instructions, counted as extract_int_ops does:
    per lane 6 (the padding test, the threshold compare, the + 1); per
    survivor 2 (one 64-bit compare, the least any grouping of equal values
    needs); per real cand row 4 (the weight fold)."""
    return 6 * b + 2 * kept + 4 * heads


def dedup_bytes(b: int) -> int:
    """Tier D: the lo/hi and hash planes read once (16 B/lane), the
    threshold, cand (96 x 2048 x 8 B) and the flag written once."""
    return 16 * b + 8 + 96 * 2048 * 8 + 4


def dedup_slab_int_ops(b: int, slab_real: int, heads: int) -> int:
    """Tier D2's fewest INT32 instructions: per slab entry 2 (the padding
    test); per real entry 2 (one 64-bit compare); per real cand row 4."""
    return 2 * (b // 4) + 2 * slab_real + 4 * heads


def dedup_slab_bytes(b: int) -> int:
    """Tier D2: the slab read once (b/4 x 8 B), cand and the flag written
    once."""
    return (b // 4) * 8 + 96 * 2048 * 8 + 4


def bound(ops: int, nbytes: int, card: dict) -> tuple[float, str, float,
                                                      float]:
    """(bound ms, bound_by, operations ms, bytes ms) on this card."""
    t_ops = ops / (card["sms"] * INT32_OPS_PER_CLK_PER_SM * card["clock_hz"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            t_ops * 1e3, t_bytes * 1e3)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    """Build every kernel library (one nvcc per source) and the host
    parser (g++) at once."""
    from finch_tpu_torch import native
    from finch_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    errors = []
    result = {}

    def run(name, fn, *args):
        try:
            result[name] = fn(*args)
        except Exception as err:  # re-raised below, after all joined
            errors.append(err)

    threads = [threading.Thread(target=run, args=(n, cuda_lib.build, n))
               for n in cuda_lib.SOURCES]
    threads.append(threading.Thread(target=run, args=("native", native.lib)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    secs = time.perf_counter() - t0
    cached = [n for n in cuda_lib.SOURCES if not result[n][1]]
    log(f"[build] {', '.join(f'{n}.cu' for n in cuda_lib.SOURCES)} (nvcc) "
        f"+ finch_native.cpp (g++) in {secs:.2f} s"
        f"{f' (cached: {cached})' if cached else ''}")
    for n in cuda_lib.SOURCES:
        lines = result[n][1].splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and i + 2 < len(lines):
                fn = ln.split("'")[1] if "'" in ln else ln
                regs = [x.strip() for x in lines[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                if "extract_select" in fn and "Li21E" not in fn:
                    continue  # one of the 28 k-specialisations is enough
                name = next((x for x in LAUNCH_NAMES if x in fn), fn[:60])
                log(f"[build] {n}: {name} | {' | '.join(regs)}")


def _planes(v, device):
    import numpy as np

    from finch_tpu_torch import u64

    lo = u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), device)
    hi = u64.from_numpy((v >> np.uint64(32)).astype(np.uint32), device)
    return lo, hi


def _time_ms(fn, runs: int, per_run: int) -> float:
    """Median over `runs` of the CUDA-event time of `per_run` back-to-back
    calls, per call (after the caller's warm-up)."""
    import statistics

    import torch

    times = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per_run):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / per_run)
    return statistics.median(times)


def _host_us(fn, calls: int = 200) -> float:
    """Host time per wrapper call, enqueueing `calls` back-to-back calls
    (fewer launches than the launch queue holds, so none waits for the
    device): what a call costs the host, whatever the device does."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    return secs / calls * 1e6


# the kernels' names as the profiler reports them; no name is a substring
# of another, so each profiler event matches at most one
LAUNCH_NAMES = ("extract_select", "extract_warp_merge",
                "extract_weighted_merge", "dedup_lanes_warp",
                "dedup_slab_warp")


def launch_grids(kernel: str, b: int) -> str:
    """Each launch's grid x block, as csrc/extract.cu and csrc/dedup.cu
    configure them for b lanes."""
    nch = b // (32 * 2048)
    select = f"extract_select ({2048 // 128}, {nch}) x 128"
    return {"extract": f"{select}; extract_warp_merge 256 x 256",
            "extract_weighted": f"{select}; extract_weighted_merge 256 x 256",
            "dedup": "dedup_lanes_warp 256 x 256",
            "dedup_slab": "dedup_slab_warp 256 x 256"}[kernel]


def _device_us_per_call(fn, calls: int) -> dict:
    """Device time per call of each kernel launch, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in LAUNCH_NAMES:
            if name in e.key:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                out[name] = out.get(name, 0.0) + us / calls
    return out


def _measure(kernel: str, case: str, launch, plain, ops: int, nbytes: int,
             card: dict, note: str) -> dict:
    """Time the kernel (after a warm-up) and its plain version, price the
    bound, log one line; returns the kernel's row numbers."""
    for _ in range(3):
        launch()
    ms = _time_ms(launch, 20, 10)
    plain_ms = _time_ms(plain, 5, 1)
    host_us = _host_us(launch)  # before the profiler, which slows launches
    split = _device_us_per_call(launch, 20)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes, card)
    log(f"[kernels] {kernel} {case}: equal=yes {note} kernel {ms:.4f} ms "
        f"(median of 20 x 10 launches; device "
        f"{ {n: round(v, 2) for n, v in split.items()} } us; host "
        f"{host_us:.1f} us a call) plain "
        f"{plain_ms:.3f} ms bound {bound_ms * 1e3:.2f} us ({bound_by}: ops "
        f"{ops_ms * 1e3:.2f} us, bytes {bytes_ms * 1e3:.2f} us)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, device_us=sum(split.values()),
                host_us=host_us)


def _require_equal(kernel: str, case: str, got, want, what) -> None:
    import torch

    for g, w, name in zip(got, want, what):
        if not torch.equal(g, w):
            raise AssertionError(f"{kernel} kernel != plain on {case}: "
                                 f"{name}")


def _require_flags(kernel: str, case: str, flags, want) -> None:
    if tuple(flags) != tuple(want):
        raise AssertionError(f"{kernel} case {case} missed its regime: flags "
                             f"{tuple(flags)}, wanted {tuple(want)}")


def _low_high(rng, k: int, th: int, n: int):
    """Random packed k-mers split by murmur3 at the threshold."""
    import numpy as np

    from finch_tpu_torch import native

    pool = np.unique(rng.integers(0, 4 ** k, size=n, dtype=np.uint64))
    h = native.murmur3_packed(pool, k, 0)
    return pool[h <= np.uint64(th)], pool[h > np.uint64(th)]


def _column_flood(rng, b: int, th: int):
    """No survivor but in columns 0..7, where rows 0..7 of every chunk hold
    8 distinct survivors: 8 x nchunks distinct per column (more than 96),
    no chunk column over 8."""
    import numpy as np

    from finch_tpu_torch.ops import extract

    nch = b // extract.CHUNK
    low, high = _low_high(rng, K_MAIN, th, 1 << 18)
    packed = high[rng.integers(0, len(high), size=b)]
    lanes = packed.reshape(nch, extract.COLH, extract.CHUNK_W)
    lanes[:, :8, :8] = low[:nch * 64].reshape(nch, 8, 8)
    return packed << np.uint64(1)


# survivors per chunk of the edge column: 32 real slab entries over 5
# chunks (aovf 0) and 33 (aovf 1)
EDGE_COUNTS = {"exactly_32": (8, 8, 8, 4, 4), "just_33": (8, 8, 8, 8, 1)}


def _edge_column(rng, b: int, counts):
    """Lanes with no survivor at threshold 2**63 but in column 5 of the
    first len(counts) chunks: counts[c] of them in chunk c. Chunks 3 and
    4 repeat chunk 0's first k-mers, so equal slab values sit within one
    merge step (chunks 0-3) and across two (chunk 4)."""
    import numpy as np

    from finch_tpu_torch.ops import extract

    low, high = _low_high(rng, K_MAIN, 2**63, 1 << 14)
    lanes = high[rng.integers(0, len(high), size=b)].reshape(
        b // extract.CHUNK, extract.COLH, extract.CHUNK_W)
    for c, n in enumerate(counts):
        lanes[c, :n, 5] = low[:n] if c >= 3 else low[8 * c:8 * c + n]
    return lanes.reshape(-1) << np.uint64(1)


def _synthetic_slab(rng, groups):
    """A D2 input slab built 32 rows (one step) at a time: a group is None
    (every row u64::MAX), ("pool", n, p) (n rows per column drawn in turn
    from the column's p pool values) or ("fresh", n) (n new distinct values
    per column, below every pool value). Values carry their column in bits
    40 and up, so each column has its own pool. ("copies", n) is n copies
    of one new value, below every pool value."""
    import numpy as np

    w = 2048
    colbits = np.arange(w, dtype=np.uint64)[None, :] << np.uint64(40)
    out = np.full((len(groups) * 32, w), np.uint64(2**64 - 1),
                  dtype=np.uint64)
    drawn = fresh = 0
    for g, spec in enumerate(groups):
        if spec is None:
            continue
        n = spec[1]
        if spec[0] == "pool":
            idx = (drawn + np.arange(n)) % spec[2]
            vals = np.uint64(1 << 20) + idx.astype(np.uint64)
            drawn += n
        elif spec[0] == "fresh":
            vals = np.uint64(1 + fresh) + np.arange(n, dtype=np.uint64)
            fresh += n
        else:
            vals = np.full(n, np.uint64(1 + fresh), dtype=np.uint64)
            fresh += 1
        pick = np.argsort(rng.random((32, w)), axis=0)[:n]
        block = out[g * 32:(g + 1) * 32]
        np.put_along_axis(block, pick, colbits + vals[:, None], axis=0)
    return out.reshape(-1).view(np.int64)


def _d2_synthetic(ngroups: int) -> dict:
    """The D2 edge cases over ngroups steps: (groups, d2ovf)."""
    return {
        # u64::MAX groups between real ones, the last step empty; every
        # fourth step holds 3 copies of each of 8 values already held
        "max_groups": ([("pool", 12, 30), None, None, ("pool", 24, 8)]
                       * (ngroups // 4 - 1) + [("pool", 8, 30), None,
                                               ("pool", 4, 30), None], 0),
        # 70 heads early, no step past row 95; the last step's 32 fresh
        # values push the largest heads out
        "ovf_last": ([("pool", 20, 70)] * (ngroups - 1) + [("fresh", 32)],
                     1),
        # 96 heads after three steps: the fourth, the earliest step that
        # can, overflows, and every later one
        "ovf_earliest": ([("fresh", 32)] * ngroups, 1),
        # 85 heads, then two steps of 8 copies: neither step reaches row
        # 96, though one pass over both would
        "near_full": ([("pool", 30, 85)] * 3 + [None] * (ngroups - 8)
                      + [("copies", 8)] * 2 + [None] * 3, 0),
    }


def _lanes_from_slab(rng, slab, th: int):
    """Tier D lanes whose survivors are a synthetic slab's real entries
    (one slab group of 32 rows per chunk): a lane is the slab value - 1
    with a hash at or below th (a tenth of them exactly th). Any other lane
    is padding (both planes all-ones; a third of them, half of those with
    hashes at or below th) or a random value hashing above th (a tenth of
    them exactly th + 1). Returns the value and hash planes as u64."""
    import numpy as np

    real = slab != np.uint64(2**64 - 1)
    n = slab.size
    low_h = rng.integers(0, th, size=n, dtype=np.uint64, endpoint=True)
    low_h[rng.random(n) < 0.1] = np.uint64(th)
    high_h = rng.integers(th + 1, 2**64 - 1, size=n, dtype=np.uint64,
                          endpoint=True)
    high_h[rng.random(n) < 0.1] = np.uint64(th + 1)
    pad = ~real & (rng.random(n) < 0.3)
    v = np.where(real, slab - np.uint64(1),
                 rng.integers(0, 2**62, size=n, dtype=np.uint64))
    v[pad] = np.uint64(2**64 - 1)
    h = np.where(real | (pad & (rng.random(n) < 0.5)), low_h, high_h)
    return v, h


# the weighted extract's edge columns: per chunk, the survivors of column
# 5 as indices into a sorted pool of survivors; 16 chunks (4 merge steps),
# 8 a chunk, copies within a step and across steps: (chunks, aovf)
WEIGHTED_EDGES = {
    "distinct_32": ([[(5 * i + j) % 32 + 1 for j in range(8)]
                     for i in range(16)], 0),
    # a 33rd value, below the others, in the last chunk: the largest held
    # value drops out with its count
    "distinct_33": ([[(5 * i + j) % 32 + 1 for j in range(8)]
                     for i in range(15)] + [[0] + list(range(12, 19))], 1),
}


def _weighted_edge(rng, b: int, chunks):
    """Lanes with no survivor at threshold 2**63 but in column 5 of the
    first len(chunks) chunks, as WEIGHTED_EDGES lists them."""
    import numpy as np

    from finch_tpu_torch.ops import extract

    low, high = _low_high(rng, K_MAIN, 2**63, 1 << 14)
    low = np.sort(low)
    lanes = high[rng.integers(0, len(high), size=b)].reshape(
        b // extract.CHUNK, extract.COLH, extract.CHUNK_W)
    for c, idx in enumerate(chunks):
        lanes[c, :len(idx), 5] = low[idx]
    return lanes.reshape(-1) << np.uint64(1)


# the lane widths at which [kernels] held each kernel against its plain
# version; [mesh] requires every width its shards launched a kernel at to
# be among them
HELD_WIDTHS = {"extract": set(), "extract_weighted": set(), "dedup": set(),
               "dedup_slab": set()}
# the [mesh] shards' widths below the 2M and 4M of the main path: bpd
# (512k) and the powers of two a shorter last batch pads a shard to
MESH_WIDTHS = (1 << 17, 1 << 18, 1 << 19, 1 << 20)


def phase_kernels(seed: int, card: dict) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from finch_tpu_torch import u64
    from finch_tpu_torch.ops import dedup, extract

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    b = B_MAIN
    pk = rng.integers(0, 4 ** K_MAIN, size=b, dtype=np.uint64)
    rc = rng.integers(0, 2, size=b, dtype=np.uint64)
    v = (pk << np.uint64(1)) | rc
    v[-1000:] = np.uint64(2**64 - 1)  # padding lanes past nvalid
    # the admission threshold of a 200k-entry state after 8 uniform 4M
    # batches (the steady state the main path reaches)
    warm = (200_000 << 64) // (8 * b)
    # a duplicate stream's steady state: 64x fewer distinct values per
    # batch keep its threshold about 64x higher (bench.py:115-119); about
    # 2.4% of the hash space after 128 batches of 4M
    dup_warm = int(0.024 * 2**64)
    dup64 = np.tile(v[:b // 64], 64)
    shuffled = dup64[rng.permutation(b)]
    rows = {}

    # ---- extract, unweighted and weighted ----
    def kmers(k, n):  # uniform lanes of k-mers, padding at the end
        out = ((pk[:n] % np.uint64(4 ** k)) << np.uint64(1)) | rc[:n]
        out[-1000:] = np.uint64(2**64 - 1)
        return out

    b32 = 1 << 25  # sketch_step's largest batch: 512 chunks
    ex_cases = [
        ("uniform_warm", K_MAIN, 0, v, warm, False, None),
        # the engines' default batch (sketch_stream batch_size=2M)
        ("uniform_warm_2M", K_MAIN, 0, v[:b // 2], warm, False, None),
        ("cold", K_MAIN, 0, v, 2**64 - 1, False, (1, 1)),
        ("dup64_stride", K_MAIN, 0, dup64, warm, False, (0, 1)),
        ("one_chunk_k28", 28, 42,
         (rng.integers(0, 4 ** 28, size=extract.CHUNK, dtype=np.uint64)
          << np.uint64(1)) | rc[:extract.CHUNK], int(0.3 * 2**64), False,
         None),
    ]
    # the [mesh] shard widths: a 2M batch over 4 shards is 512k; a last,
    # shorter batch pads each shard to a power of two
    ex_cases += [(f"uniform_warm_{w >> 10}k", K_MAIN, 0, v[:w], warm, False,
                  None) for w in MESH_WIDTHS]
    # the 4-base word assembly and the murmur tail (K mod 16 = 4, 5, 0, 1,
    # 9), at 4M and 2M
    for kk in (4, 5, 16, 17, 25):
        ex_cases += [(f"uniform_warm_k{kk}", kk, 0, kmers(kk, b), warm,
                      False, None),
                     (f"uniform_warm_k{kk}_2M", kk, 0, kmers(kk, b // 2),
                      warm, False, None)]
    # 1, 3 and 5 chunks: a merge step past the slab's end
    for nch in (1, 3, 5):
        ex_cases.append((f"chunks_{nch}", K_MAIN, 0,
                         v[:nch * extract.CHUNK], int(0.3 * 2**64), False,
                         None))
    # one column with exactly 32 / 33 real slab entries over 5 chunks,
    # equal values within and across merge steps
    for case, counts in EDGE_COUNTS.items():
        aovf = int(sum(counts) > 32)
        for n, tag in ((b, ""), (b // 2, "_2M")):
            ex_cases.append((f"{case}{tag}", K_MAIN, 0,
                             _edge_column(rng, n, counts), 2**63, False,
                             (0, aovf)))
    ex_cases += [
        ("uniform_warm_32M", K_MAIN, 0, None, warm, False, None),
        ("uniform_warm", K_MAIN, 0, v, warm, True, (0, 0)),
        ("uniform_warm_2M", K_MAIN, 0, v[:b // 2], warm, True, (0, 0)),
        # the weighted accumulator absorbs the stride-aligned copies:
        # aovf 0 where the unweighted one is 1
        ("dup64_stride", K_MAIN, 0, dup64, warm, True, (0, 0)),
        ("dup64_stride_2M", K_MAIN, 0, np.tile(v[:b // 128], 64), warm,
         True, (0, 0)),
        # more than 32 distinct survivors in some column
        ("distinct_flood", K_MAIN, 0, v, dup_warm, True, (0, 1)),
        ("distinct_flood_2M", K_MAIN, 0, v[:b // 2], dup_warm, True,
         (0, 1)),
        ("uniform_warm_32M", K_MAIN, 0, None, warm, True, None),
    ]
    # [mesh] dup64 shards: 16 copies of w/16 composites
    ex_cases += [(f"dup64_stride_{w >> 10}k", K_MAIN, 0,
                  np.tile(v[:w // 16], 16), warm, True, None)
                 for w in MESH_WIDTHS]
    # one column with exactly 32 / 33 distinct values over 16 chunks
    for case, (chunks, aovf) in WEIGHTED_EDGES.items():
        for n, tag in ((b, ""), (b // 2, "_2M")):
            ex_cases.append((f"{case}{tag}", K_MAIN, 0,
                             _weighted_edge(rng, n, chunks), 2**63, True,
                             (0, aovf)))
    for name, k, s, lanes, th, weighted, flags_want in ex_cases:
        kernel = "extract_weighted" if weighted else "extract"
        if lanes is None:  # 32M lanes, made when needed
            lanes = ((rng.integers(0, 4 ** K_MAIN, size=b32, dtype=np.uint64)
                      << np.uint64(1)) | np.uint64(1))
        vlo, vhi = _planes(lanes, dev)
        tt = torch.tensor([u64.to_i64(th)], device=dev)
        got = extract.extract_candidates(vlo, vhi, tt, k=k, seed=s,
                                         weighted=weighted)
        torch.cuda.synchronize()
        want = extract.extract_candidates_plain(vlo, vhi, tt, k=k, seed=s,
                                                weighted=weighted)
        _require_equal(kernel, name, got, want, ("cand", "slab", "hash_lo",
                                                 "hash_hi", "covf", "aovf"))
        HELD_WIDTHS[kernel].add(lanes.shape[0])
        flags = (int(got[4]), int(got[5]))
        if flags_want is not None:
            _require_flags(kernel, name, flags, flags_want)
        pad = (vlo == -1) & (vhi == -1)
        h = u64.join(want[2], want[3])
        kept = int((~pad & u64.le(h, tt.reshape(()))).sum())
        slab_real = int((want[1] != u64.MAX).sum())
        heads = int((want[0] != u64.MAX).sum())
        n = lanes.shape[0]
        ops = (extract_weighted_int_ops(k, n, kept, slab_real, heads)
               if weighted else extract_int_ops(k, n, kept, slab_real))
        row = _measure(
            kernel, name,
            lambda: extract.extract_candidates(vlo, vhi, tt, k=k, seed=s,
                                               weighted=weighted),
            lambda: extract.extract_candidates_plain(
                vlo, vhi, tt, k=k, seed=s, weighted=weighted),
            ops, extract_bytes(n), card,
            f"b={n} k={k} seed={s} covf,aovf={flags} kept={kept} grids "
            f"[{launch_grids(kernel, n)}]")
        if (kernel, name) in (("extract", "uniform_warm"),
                              ("extract_weighted", "dup64_stride")):
            rows[kernel] = row

    # ---- tier D: re-selection from the saved hash planes ----
    # about 50 survivors per column in a 2M batch (1024 lanes a column):
    # what tier D sees on the isolate run's warm steps
    sparse = int(50 / 1024 * 2**64)
    d_cases = [
        # a cold stride-aligned burst: chunk columns overflow, D holds it
        ("cold_dup64_stride", dup64, 2**64 - 1, (1, 0)),
        ("cold_dup64_stride_2M", np.tile(v[:b // 128], 64), 2**64 - 1,
         (1, 0)),
        # a cold uniform batch: more than 96 distinct per column
        ("cold_uniform", v, 2**64 - 1, (1, 1)),
        ("cold_uniform_2M", v[:b // 2], 2**64 - 1, (1, 1)),
        ("sparse_warm", v, sparse, None),
        ("sparse_warm_2M", v[:b // 2], sparse, None),
        # 512 chunks, far past the ring's 16: each chunk the same 32
        # values a column, 512 copies each
        ("cold_dup_stride_32M", None, 2**64 - 1, (1, 0)),
    ]
    d_cases += [(f"cold_uniform_{w >> 10}k", v[:w], 2**64 - 1, None)
                for w in MESH_WIDTHS]
    # synthetic lanes, one D2 edge-case group a chunk: u64::MAX chunks
    # between real ones, an overflow on the last step only and from the
    # earliest step that can, 85 heads then two 8-copy steps
    for n, tag in ((b, ""), (b // 2, "_2M")):
        for case, (groups, ovf) in _d2_synthetic(n // extract.CHUNK).items():
            d_cases.append((f"{case}{tag}", groups, 2**63 + 12345, (ovf,)))
    for name, lanes, th, flags_want in d_cases:
        tt = torch.tensor([u64.to_i64(th)], device=dev)
        if isinstance(lanes, list):  # synthetic: the hash planes set directly
            vv, hh = _lanes_from_slab(
                rng, _synthetic_slab(rng, lanes).view(np.uint64), th)
            vlo, vhi = _planes(vv, dev)
            hlo, hhi = _planes(hh, dev)
            flags_pre = ()
        else:
            if lanes is None:  # 32M lanes, made when needed
                lanes = np.tile(v[:b // 64], 512)
            vlo, vhi = _planes(lanes, dev)
            ex = extract.extract_candidates(vlo, vhi, tt, k=K_MAIN, seed=0)
            hlo, hhi = ex[2], ex[3]
            flags_pre = (int(ex[4]),)
        got = dedup.dedup_candidates(vlo, vhi, hlo, hhi, tt, k=K_MAIN)
        torch.cuda.synchronize()
        want = dedup.dedup_candidates_plain(vlo, vhi, hlo, hhi, tt, k=K_MAIN)
        _require_equal("dedup", name, got, want, ("cand", "dovf"))
        HELD_WIDTHS["dedup"].add(vlo.shape[0])
        flags = (*flags_pre, int(got[1]))
        if flags_want is not None:
            _require_flags("dedup", name, flags, flags_want)
        pad = (vlo == -1) & (vhi == -1)
        kept = int((~pad & u64.le(u64.join(hlo, hhi),
                                  tt.reshape(()))).sum())
        heads = int((want[0] != u64.MAX).sum())
        n = vlo.shape[0]
        row = _measure(
            "dedup", name,
            lambda: dedup.dedup_candidates(vlo, vhi, hlo, hhi, tt, k=K_MAIN),
            lambda: dedup.dedup_candidates_plain(vlo, vhi, hlo, hhi, tt,
                                                 k=K_MAIN),
            dedup_int_ops(n, kept, heads), dedup_bytes(n), card,
            f"b={n} flags={flags} kept={kept} heads={heads} grid "
            f"[{launch_grids('dedup', n)}]")
        if name == "cold_dup64_stride":
            rows["dedup"] = row

    # ---- tier D2: dedup straight from the slab ----
    d2_cases = [
        # the shuffled burst at the dup stream's steady state: a complete
        # slab (covf 0), the unweighted accumulator overflows (aovf 1)
        ("dup_shuffle", shuffled, dup_warm, (0, 1, 0)),
        ("dup_shuffle_2M", shuffled[:b // 2], dup_warm, (0, 1, 0)),
        ("column_flood", _column_flood(rng, b, dup_warm), dup_warm,
         (0, 1, 1)),
        ("column_flood_2M", _column_flood(rng, b // 2, dup_warm), dup_warm,
         (0, 1, 1)),
        # 128 steps, far past the shared-memory ring's 16
        ("dup_shuffle_32M", None, dup_warm, None),
    ]
    # (sketch_step takes D2 only where it can: 128k is 2 chunks, not 4)
    d2_cases += [(f"dup_shuffle_{w >> 10}k", shuffled[:w], dup_warm, None)
                 for w in MESH_WIDTHS if dedup.supports_dedup_slab(K_MAIN, w)]
    # synthetic slabs: u64::MAX groups between real ones, an overflow on
    # the last step only, and one from the earliest step that can
    for n, tag in ((b, ""), (b // 2, "_2M")):
        for case, (groups, ovf) in _d2_synthetic(n // (4 * extract.CHUNK)
                                                 ).items():
            d2_cases.append((f"{case}{tag}", groups, None, (ovf,)))
    for name, lanes, th, flags_want in d2_cases:
        if isinstance(lanes, list):  # a synthetic slab, no extract
            slab = torch.from_numpy(_synthetic_slab(rng, lanes)).to(dev)
            n = slab.shape[0] * 4
            flags_pre = ()
        else:
            if lanes is None:  # the shuffled burst at 32M, made when needed
                lanes = np.tile(v[:b // 64], 8 * 64)
                lanes = lanes[rng.permutation(lanes.shape[0])]
            vlo, vhi = _planes(lanes, dev)
            tt = torch.tensor([u64.to_i64(th)], device=dev)
            ex = extract.extract_candidates(vlo, vhi, tt, k=K_MAIN, seed=0)
            slab = ex[1]
            n = lanes.shape[0]
            flags_pre = (int(ex[4]), int(ex[5]))
        got = dedup.dedup_slab_candidates(slab, k=K_MAIN)
        torch.cuda.synchronize()
        want = dedup.dedup_slab_candidates_plain(slab, k=K_MAIN)
        _require_equal("dedup_slab", name, got, want, ("cand", "d2ovf"))
        HELD_WIDTHS["dedup_slab"].add(n)
        flags = (*flags_pre, int(got[1]))
        if flags_want is not None:
            _require_flags("dedup_slab", name, flags, flags_want)
        slab_real = int((slab != u64.MAX).sum())
        heads = int((want[0] != u64.MAX).sum())
        row = _measure(
            "dedup_slab", name,
            lambda: dedup.dedup_slab_candidates(slab, k=K_MAIN),
            lambda: dedup.dedup_slab_candidates_plain(slab, k=K_MAIN),
            dedup_slab_int_ops(n, slab_real, heads), dedup_slab_bytes(n),
            card, f"b={n} flags={flags} slab_real={slab_real} "
            f"heads={heads} grid [{launch_grids('dedup_slab', n)}]")
        if name == "dup_shuffle":
            rows["dedup_slab"] = row
    for row in rows.values():
        row["max_abs_err"] = 0  # every case above required exact equality
    return rows


GOLDENS = [
    ("query_mash_n10.sk", ["--n-hashes", "10", "tests/data/query.fa"]),
    ("query_scaled_n10.sk", ["-s", "scaled", "--n-hashes", "10",
                             "tests/data/query.fa"]),
    ("reads_filtered.sk", ["--n-hashes", "100", "tests/data/reads.fastq"]),
    ("query_mash_n10.bsk", ["--n-hashes", "10", "-b",
                            "tests/data/query.fa"]),
    ("query_mash_n10.msh", ["--n-hashes", "10", "-B",
                            "tests/data/query.fa"]),
]


# `hist` and `info` of tests/data/query.fa at --n-hashes 10, as the JAX
# package's CLI prints them (tests/test_torch_dist_cli.py holds the port's
# CLI to the same bytes on the CPU)
HIST_QUERY = b'{"tests/data/query.fa":[8,2]}'
INFO_QUERY = ("tests/data/query.fa (from 405bp)\n"
              "  Estimated # of Unique Kmers: 646\n"
              "  Estimated Average Depth: 1.2x\n"
              "  Estimated % GC: 48.015873%\n")


def phase_goldens(tmp: str) -> float:
    """The port's CLI on the card reproduces the frozen goldens: the five
    sketch files, `finch dist` between a sketch file and a FASTQ, and
    `hist` and `info`."""
    import io

    from finch_tpu_torch import cli

    t0 = time.perf_counter()
    out = os.path.join(tmp, "golden_out")
    runs = [(golden, ["sketch", "--backend", "torch", *args])
            for golden, args in GOLDENS]
    runs.append(("dist_query_reads.json",
                 ["dist", "-N", "tests/data/goldens/query_mash_n10.sk",
                  "tests/data/reads.fastq"]))
    for golden, args in runs:
        ext = golden.rsplit(".", 1)[1]
        cli.run([*args, "--device", "cuda", "-o", out])
        with open(f"{out}.{ext}", "rb") as f:
            got = f.read()
        with open(os.path.join(REPO, "tests", "data", "goldens", golden),
                  "rb") as f:
            if got != f.read():
                raise AssertionError(f"golden {golden} differs on the card")
    cli.run(["hist", "--n-hashes", "10", "--device", "cuda",
             "tests/data/query.fa", "-o", out])
    with open(f"{out}.json", "rb") as f:
        if f.read() != HIST_QUERY:
            raise AssertionError("hist differs on the card")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.run(["info", "--n-hashes", "10", "--device", "cuda",
                 "tests/data/query.fa"])
    if text.getvalue() != INFO_QUERY:
        raise AssertionError(f"info differs on the card: {text.getvalue()!r}")
    secs = time.perf_counter() - t0
    log(f"[goldens] {len(runs)}/{len(runs)} byte-equal (5 sketches, dist) "
        f"and hist, info equal through the CLI on cuda in {secs:.2f} s")
    return secs


def make_fastq(path: str, seed: int, genome_len: int, coverage: int,
               read_len: int = 150, err: float = 0.005) -> int:
    """Simulated isolate run: reads of a random genome with substitution
    errors, half reverse-complemented, fixed-width names. Returns reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    n = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len + 1, size=n)
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = read_len
    rec_len = 10 + L + 3 + L + 1  # "@r0000000\n" seq "\n+\n" qual "\n"
    with open(path, "wb") as f:
        for lo in range(0, n, 100_000):
            m = min(100_000, n - lo)
            reads = genome[starts[lo:lo + m, None] + np.arange(L)]
            errs = rng.random((m, L)) < err
            reads[errs] = (reads[errs] + rng.integers(
                1, 4, size=int(errs.sum()), dtype=np.uint8)) % 4
            rev = rng.random(m) < 0.5
            reads[rev] = 3 - reads[rev, ::-1]
            rec = np.empty((m, rec_len), dtype=np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            ids = lo + np.arange(m)
            for d in range(7):
                rec[:, 2 + d] = ord("0") + (ids // 10 ** (6 - d)) % 10
            rec[:, 9] = ord("\n")
            rec[:, 10:10 + L] = ascii_[reads]
            rec[:, 10 + L] = ord("\n")
            rec[:, 11 + L] = ord("+")
            rec[:, 12 + L] = ord("\n")
            rec[:, 13 + L:13 + 2 * L] = ord("I")
            rec[:, 13 + 2 * L] = ord("\n")
            f.write(rec.tobytes())
    return n


KERNELS = ("extract", "extract_weighted", "dedup", "dedup_slab")


def reset_launches() -> None:
    from finch_tpu_torch.ops import dedup, extract

    extract.extract_candidates.launches = 0
    extract.extract_candidates.launches_weighted = 0
    dedup.dedup_candidates.launches = 0
    dedup.dedup_slab_candidates.launches = 0


def read_launches() -> dict:
    from finch_tpu_torch.parallel import process_mesh

    return process_mesh.read_launches()


TIERS = ("A", "D2", "B", "D", "C")


def check_launches(run: str, stats: dict, launches: dict) -> None:
    """Each kernel's launches must equal the steps that, by the tier
    switch's rules and the engine's own tallies, launch it: one extract
    per kernel-path step (weighted when the hint was on), one D2 per step
    that took D2 or fell from it to B, one D per step that took D or fell
    from it."""
    steps = sum(stats.get(f"tier_{t}", 0) for t in TIERS)
    weighted = stats.get("extract_weighted", 0)
    want = {"extract": steps - weighted, "extract_weighted": weighted,
            "dedup": stats.get("tier_D", 0) + stats.get("D_overflow", 0),
            "dedup_slab": (stats.get("tier_D2", 0)
                           + stats.get("D2_overflow", 0))}
    if steps < 1 or launches != want:
        raise AssertionError(f"{run}: launches {launches} != the tier "
                             f"switch's {want} (stats {stats})")


def _tier_line(stats: dict) -> str:
    tiers = "/".join(str(stats.get(f"tier_{t}", 0)) for t in TIERS)
    return (f"tiers A/D2/B/D/C {tiers}, weighted extracts "
            f"{stats.get('extract_weighted', 0)}, D2/D overflows "
            f"{stats.get('D2_overflow', 0)}/{stats.get('D_overflow', 0)}, "
            f"host syncs {stats.get('syncs', 0)}"
            + (f" for {stats['shard_reads']} shard reads"
               if "shard_reads" in stats else ""))


# the A/B's runs: five pairs of the default configuration and the
# A/B/C-only one (absorb=False, dedup_tier=False), each pair in the
# other order than the last, so that drift on the host favours neither
AB_ORDER = ("default", "abc", "abc", "default", "default", "abc", "abc",
            "default", "default", "abc")


def ab_summary(label: str, ab: dict, kmers: int) -> str:
    """One line for an A/B: each configuration's median rate, the pairs
    the default configuration won, the interquartile range of the
    A/B/C-only runs (a difference of medians under it is unresolved) and
    every time."""
    import statistics

    med = {c: statistics.median(t) for c, t in ab.items()}
    won = sum(d < p for d, p in zip(ab["default"], ab["abc"]))
    q1, _, q3 = statistics.quantiles(ab["abc"], n=4)
    return (f"{label} A/B, {len(ab['abc'])} pairs in turns: default median "
            f"{med['default']:.4f} s ({kmers / med['default']:.4g} "
            f"k-mers/s), A/B/C-only {med['abc']:.4f} s "
            f"({kmers / med['abc']:.4g} k-mers/s), ratio "
            f"{med['abc'] / med['default']:.3f}x; default faster in {won} "
            f"pairs; A/B/C-only IQR {q3 - q1:.4f} s; times default "
            f"{[round(t, 4) for t in ab['default']]} abc "
            f"{[round(t, 4) for t in ab['abc']]}")


def phase_main_path(tmp: str, seed: int) -> dict:
    """The main path at real scale: CLI-default sketches three ways."""
    import torch

    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.models.engine import card_is_warm
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes
    from finch_tpu_torch.tools.switch_point import cold_card
    from finch_tpu_torch.utils import get_meter

    fq = os.path.join(tmp, "isolate.fastq")
    t0 = time.perf_counter()
    n_reads = make_fastq(fq, seed, GENOME_BP, COVERAGE)
    gen_s = time.perf_counter() - t0
    log(f"[main] generated {n_reads} reads, {os.path.getsize(fq)} bytes "
        f"in {gen_s:.2f} s")

    args = cli.build_cli().parse_args(["sketch", fq, "-o", "unused"])
    k = cli.get_kmer_length(args)
    filters = cli.parse_filter_options(args, k)
    params = cli.parse_sketch_options(args, k, filters.filter_on)

    def run(backend: str, device: str):
        engines = []
        t = time.perf_counter()
        sk = sketch_stream(fq, fq, params, filters, backend=backend,
                           device=device, engine_out=engines)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        stats = dict(engines[0].stats) if engines and hasattr(
            engines[0], "stats") else {}
        return multisketch_to_json_bytes([sk]), sk, secs, stats

    ref, sk, native_s, _ = run("native", "cuda")
    kmers = sk.num_valid_kmers
    log(f"[main] native host fold: {kmers} k-mers in {native_s:.2f} s "
        f"({kmers / native_s:.4g} k-mers/s)")
    if len(sk.hashes) != params.expected_size():
        raise AssertionError(f"expected {params.expected_size()} hashes, "
                             f"got {len(sk.hashes)}")

    # the parse alone: the floor of every engine, the mesh's included
    from finch_tpu_torch.tools.mesh_cards import parse_alone

    parses = [parse_alone(fq, k) for _ in range(3)]
    if any(p["kmers"] != kmers for p in parses):
        raise AssertionError(f"[main] parse alone: {parses} != {kmers}")
    parse_s = sorted(p["s"] for p in parses)[1]
    log(f"[main] parse alone ({parses[0]['reader']}, {os.cpu_count()} "
        f"cores, filled in place into two reused buffers, no engine): "
        f"{kmers} k-mers in {parses[0]['batches']} batches; "
        f"{[round(p['s'], 4) for p in parses]} s, median {parse_s:.4f} s "
        f"({kmers / parse_s:.4g} k-mers/s, "
        f"{os.path.getsize(fq) / parse_s / 1e6:.1f} MB/s)")
    out = {"native_s": native_s, "kmers": kmers, "launches": {},
           "fastq": fq, "ref": ref}
    # auto twice: under cold_card(), as a fresh `finch sketch` runs it (the
    # host fold of the first 4M k-mers, then one migration of that state),
    # and after torch, on the warm card (on the card from its first batch)
    spans = ("engine.host_fold", "engine.migrate", "engine.warm_start")
    for name, backend in (("auto_cold", "auto"), ("torch", "torch"),
                          ("auto", "auto")):
        if name == "auto" and not card_is_warm(torch.device("cuda")):
            raise AssertionError("[main] the card is not warm after torch")
        before = {n: (get_meter(n).calls, get_meter(n).items) for n in spans}
        reset_launches()
        with cold_card() if name == "auto_cold" else contextlib.nullcontext():
            got, _, secs, stats = run(backend, "cuda")
        launches = read_launches()
        opened = {n: (get_meter(n).calls - before[n][0],
                      get_meter(n).items - before[n][1]) for n in spans}
        if got != ref:
            raise AssertionError(f"{name} sketch differs from native")
        if name == "auto_cold" and (
                opened["engine.host_fold"][0] < 1
                or opened["engine.warm_start"][0]
                or opened["engine.migrate"][0] != 1
                or opened["engine.migrate"][1] < 1):
            raise AssertionError(f"[main] auto on a cold card did not fold on "
                                 f"the host and migrate its state: {opened}")
        if name == "auto" and (opened["engine.host_fold"][0]
                               or opened["engine.warm_start"][0] != 1
                               or opened["engine.migrate"] != (1, 0)):
            raise AssertionError(f"[main] auto on the warm card did not start "
                                 f"on it from an empty state: {opened}")
        check_launches(f"[main] {name}", stats, launches)
        log(f"[main] {name} on cuda: {kmers} k-mers in {secs:.2f} s "
            f"({kmers / secs:.4g} k-mers/s); {_tier_line(stats)}; other "
            f"steps {[t for t in ('two_stage', 'small') if t in stats]}; "
            f"launches {launches}; spans (calls, items) {opened}; .sk "
            f"identical to native")
        out[name] = {"s": secs, "stats": stats, "spans": opened}
        out["launches"][name] = launches
    # A/B on the same card: the torch backend in the default configuration
    # and in the A/B/C-only one, in turns
    ab = {"default": [], "abc": []}
    for config in AB_ORDER:
        with (abc_configuration() if config == "abc"
              else contextlib.nullcontext()):
            got, _, secs, stats = run("torch", "cuda")
        if got != ref:
            raise AssertionError(f"torch ({config}) sketch differs")
        ab[config].append(secs)
        if len(ab[config]) == 1:
            log(f"[main] A/B torch {config}: {_tier_line(stats)}")
    log(ab_summary("[main] torch", ab, kmers))
    out["ab"] = ab
    profile_torch_run(lambda: run("torch", "cuda"))
    return out


def _dup_batches(seed: int, shuffle: bool, nbatch: int, b: int):
    """bench.py's duplicate-burst stream as composite u32 planes: a 64x
    tile of b/64 random composites (copies one b/64 stride apart, so in
    one lane column), optionally permuted across lanes; batch i XORs the
    packed bits with (i * 0x9E3779B97F4A7C15) mod 4**k (fresh k-mers
    every batch, copies stay equal)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 4 ** K_MAIN, size=b // 64, dtype=np.uint64)
    rc = rng.integers(0, 2, size=b // 64, dtype=np.uint64)
    comp = np.tile((pk << np.uint64(1)) | rc, 64)
    if shuffle:
        comp = comp[rng.permutation(b)]
    out = []
    for i in range(nbatch):
        m = ((i * 0x9E3779B97F4A7C15) % 2**64) & (4 ** K_MAIN - 1)
        c = comp ^ np.uint64(m << 1)
        out.append(((c & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                    (c >> np.uint64(32)).astype(np.uint32)))
    return out


@contextlib.contextmanager
def abc_configuration():
    """While inside, every engine's sketch_step runs in the A/B/C-only
    configuration (absorb=False, dedup_tier=False): the A/B."""
    from finch_tpu_torch.ops import bottomk

    step = bottomk.sketch_step
    bottomk.sketch_step = functools.partial(step, absorb=False,
                                            dedup_tier=False)
    try:
        yield
    finally:
        bottomk.sketch_step = step


def _sorted_distinct(x):
    """np.unique(x) for a 1-D array, by a sort: numpy 2.3's hash-based
    np.unique can take minutes on tens of millions of uint64 where a sort
    takes about a second."""
    import numpy as np

    x = np.sort(x)
    return x[np.concatenate([[True], x[1:] != x[:-1]])] if len(x) else x


def _warm_kmers(seed: int, n: int, frac: float):
    """n distinct random k-mers hashing below frac of the hash space, as
    composite u32 planes: one batch that takes a cold state to the
    threshold a long run of the duplicate stream reaches."""
    import numpy as np

    from finch_tpu_torch import native

    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 4 ** K_MAIN, size=int(1.5 * n / frac),
                      dtype=np.uint64)
    pk = _sorted_distinct(pk[native.murmur3_packed(pk, K_MAIN, 0)
                             <= np.uint64(int(frac * 2**64))])[:n]
    comp = (pk << np.uint64(1)) | rng.integers(0, 2, size=len(pk),
                                               dtype=np.uint64)
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def _flush_engine(eng) -> None:
    """Merge the engine's spill into its state: the admission threshold
    then reflects every k-mer folded so far (a flush is exact at any time;
    the engine flushes when its spill fills and at finalize)."""
    eng.state, _ = eng._bottomk.flush_state(
        eng.state, eng._mh, k=eng.params.k, seed=eng.params.hash_seed)


def phase_dup(seed: int, b: int = 1 << 21, nbatch: int = 64,
              device: str = "cuda") -> dict:
    """The duplicate-burst path: bench.py's two dup streams, `nbatch`
    batches of b lanes at the CLI-default sketch parameters, from a cold
    state and from the steady state of a long run of the stream (a first
    batch of capacity-many k-mers below 2.4% of the hash space; bench.py
    warms 128 batches of 4M to reach it). Each run through NativeEngine,
    the reference, and through TorchEngine in the default configuration
    and in the A/B/C-only one, in turns (AB_ORDER); every TorchEngine
    sketch must equal NativeEngine's."""
    import numpy as np
    import torch

    from finch_tpu_torch import cli
    from finch_tpu_torch.models.engine import NativeEngine, TorchEngine

    args = cli.build_cli().parse_args(["sketch", "unused.fa"])
    k = cli.get_kmer_length(args)
    params = cli.parse_sketch_options(
        args, k, cli.parse_filter_options(args, k).filter_on)
    warm = _warm_kmers(seed + 2, params.kmers_to_sketch, 0.024)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {"launches": {}}
    for stream, shuffle in (("dup64", False), ("dup_shuffle", True)):
        batches = _dup_batches(seed + 1, shuffle, nbatch, b)
        kmers = nbatch * b
        for start, pre in (("cold", []), ("steady", [warm])):
            name = f"{stream}_{start}"
            nat = NativeEngine(params)
            t = time.perf_counter()
            for lo, hi in pre + batches:
                comp = (hi.astype(np.uint64) << np.uint64(32)) | lo
                nat.update(comp >> np.uint64(1),
                           (comp & np.uint64(1)).astype(np.uint8))
            ref = nat.finalize_arrays()
            native_s = time.perf_counter() - t
            ab = {"default": [], "abc": []}
            first = {}
            for config in AB_ORDER:
                eng = TorchEngine(params, batch_size=b, device=device)
                reset_launches()
                with (abc_configuration() if config == "abc"
                      else contextlib.nullcontext()):
                    for lo, hi in pre:
                        eng.update(lo, hi)
                        _flush_engine(eng)
                    sync()
                    t = time.perf_counter()
                    for lo, hi in batches:
                        eng.update(lo, hi)
                    sync()
                    secs = time.perf_counter() - t
                launches = read_launches()
                got = eng.finalize_arrays()
                if not all(np.array_equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(f"[dup] {name} {config}: the "
                                         f"sketch differs from "
                                         f"NativeEngine's")
                check_launches(f"[dup] {name} {config}", eng.stats,
                               launches)
                ab[config].append(secs)
                if config not in first:
                    first[config] = launches
                    log(f"[dup] {name} {config}: {kmers} k-mers in "
                        f"{secs:.3f} s ({kmers / secs:.4g} k-mers/s); "
                        f"{_tier_line(eng.stats)}; launches {launches}; "
                        f"sketch identical to NativeEngine ({native_s:.2f} "
                        f"s)")
            log(ab_summary(f"[dup] {name}", ab, kmers))
            out[name] = ab
            out["launches"][name] = first["default"]
    return out


# ---------------------------------------------------------------------------
# [dist]: `finch dist` at DB scale
# ---------------------------------------------------------------------------

DIST_N = 10_000        # sketches in each all-pairs DB
DIST_K = 1_000         # hashes a sketch: the CLI's default sketch size
DIST_MAX = 0.3         # --max-dist
DIST_Q = 64            # queries of the query-vs-DB cell
DIST_FULL_N = 4_000    # sketches of the full-matrix path's check
DIST_SAMPLES = 2_000   # pairs a cell holds against the serial distance()
DIST_CLI_N = 128       # sketches in the file of the CLI's `dist -p`
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor peak (data sheet)
# the PyTorch calls that do the distance phases' device work, timed alone
DIST_LIBRARY_CALLS = ("aten::sort", "aten::nonzero", "aten::index_put_",
                      "aten::_int_mm", "aten::addmm_", "aten::searchsorted",
                      "aten::gather")


def clustered_db(rng, n: int, k: int, n_clusters: int = 100,
                 share: float = 0.2):
    """benchmarks/bench_dist10k.py's recipe: each member of a cluster
    draws `share` of its hashes from a per-cluster pool of 4k hashes and
    the rest at random below 2^62. Rows ascending."""
    import numpy as np

    per = n // n_clusters
    out = np.empty((n, k), dtype=np.uint64)
    n_shared = int(k * share)
    for c in range(n_clusters):
        pool = rng.choice(1 << 62, size=k * 4, replace=False).astype(
            np.uint64)
        for m in range(per):
            shared = rng.choice(pool, size=n_shared, replace=False)
            priv = rng.choice(1 << 62, size=k - n_shared,
                              replace=False).astype(np.uint64)
            out[c * per + m] = np.sort(
                np.unique(np.concatenate([shared, priv]))[:k])
    return out


def disjoint_db(rng, n: int, k: int):
    """n x k distinct hashes over the whole u64 range, none shared (half of
    them >= 2^63, which only u64-ordered compares handle). Rows
    ascending."""
    import numpy as np

    while True:
        flat = rng.integers(0, 2**64 - 1, size=n * k, dtype=np.uint64)
        if len(_sorted_distinct(flat)) == n * k:
            return np.sort(flat.reshape(n, k), axis=1)


def dist_sketches(H, names):
    """The port's Sketch objects over the rows of H: mash, k=21, sized as
    the rows, as a sketch file would load them."""
    import numpy as np

    from finch_tpu_torch.core.sketch import LazyKmerCounts, Sketch
    from finch_tpu_torch.models.params import FilterParams, SketchParams

    k = H.shape[1]
    params = SketchParams.mash(kmers_to_sketch=k, final_size=k,
                               kmer_length=21)
    kmers = [b""] * k
    ones = np.ones(k, dtype=np.uint32)
    return [Sketch(name=nm, seq_length=0, num_valid_kmers=0, comment="",
                   hashes=LazyKmerCounts(H[i], kmers, ones, ones),
                   filter_params=FilterParams(filter_on=False),
                   sketch_params=params)
            for i, nm in enumerate(names)]


def host_gram(H, L):
    """An independent common-count matrix: E (distinct hash x sketch) from
    a numpy sort, E^T E by scipy.sparse. (N, N) CSR, int64; the diagonal
    is the sketch sizes."""
    import numpy as np
    import scipy.sparse as sp

    n, k = H.shape
    real = np.arange(k)[None, :] < np.asarray(L)[:, None]
    _, d = np.unique(H[real], return_inverse=True)
    e = sp.csr_matrix((np.ones(d.size, dtype=np.int64),
                       (d.reshape(-1), np.nonzero(real)[0])),
                      shape=(int(d.max()) + 1, n))
    return (e.T @ e).tocsr()


def expected_rows(q, r, c, i, j, k: float):
    """The rows the distance engines must return for the pairs (q, r)
    with integer stats (c, i, j), c > 0: finch's f64 formulas
    (distance.rs:29-47) written out here, the cut at DIST_MAX, ref-major."""
    import numpy as np

    total = i + j - c
    jac = c / np.where(total == 0, 1, total)
    jac[total == 0] = 1.0
    cont = c / np.where(j == 0, 1, j)
    cont[j == 0] = 0.0
    mash = np.clip(-np.log(2.0 * jac / (1.0 + jac)) / k, 0.0, 1.0)
    keep = mash <= DIST_MAX
    q, r = q[keep], r[keep]
    o = np.lexsort((q, r))
    return {"iq": q[o], "jr": r[o], "common": c[keep][o],
            "total": total[keep][o], "containment": cont[keep][o],
            "jaccard": jac[keep][o], "mash": mash[keep][o]}


def require_rows(cell: str, rows, want: dict) -> None:
    import numpy as np

    got = {"iq": rows._iq, "jr": rows._jr, "common": rows._common,
           "total": rows._total, "containment": rows._containment,
           "jaccard": rows._jaccard, "mash": rows._mash}
    for f, w in want.items():
        if not np.array_equal(np.asarray(got[f]), w):
            raise AssertionError(f"[dist] {cell}: rows' {f} differ from the "
                                 f"host's ({len(got[f])} vs {len(w)} rows)")


def require_samples(cell: str, rows, queries, refs, seed: int,
                    self_pairs: bool) -> None:
    """DIST_SAMPLES pairs, half from the rows and half uniform, against the
    serial distance(): a pair is a row iff its mash distance passes the
    cut, and then every field is equal."""
    import numpy as np

    from finch_tpu_torch.core.distance import distance

    nq = len(queries)
    keys = rows._jr.astype(np.int64) * nq + rows._iq
    if len(keys) and not (np.diff(keys) > 0).all():
        raise AssertionError(f"[dist] {cell}: rows not in ref-major order")
    rng = np.random.default_rng(seed)
    half = DIST_SAMPLES // 2
    pick = rng.integers(0, max(1, len(keys)), size=half)
    pairs = [(int(rows._iq[x]), int(rows._jr[x])) for x in pick
             if len(keys)]
    pairs += list(zip(rng.integers(0, nq, size=DIST_SAMPLES - len(pairs)),
                      rng.integers(0, len(refs),
                                   size=DIST_SAMPLES - len(pairs))))
    hits = 0
    for qi, ri in pairs:
        if self_pairs and qi == ri:
            continue
        d = distance(queries[qi], refs[ri])
        key = ri * nq + qi
        pos = int(np.searchsorted(keys, key))
        found = pos < len(keys) and keys[pos] == key
        if found != (d.mash_distance <= DIST_MAX):
            raise AssertionError(f"[dist] {cell}: pair ({qi}, {ri}) row "
                                 f"{found} but mash {d.mash_distance}")
        if found:
            hits += 1
            if rows[pos].to_json_dict() != d.to_json_dict():
                raise AssertionError(f"[dist] {cell}: pair ({qi}, {ri}) "
                                     f"differs from distance()")
    if hits == 0 and len(keys):
        raise AssertionError(f"[dist] {cell}: no sampled row")


@contextlib.contextmanager
def count_calls(mod, names):
    """While inside, the calls of mod's functions `names` are counted."""
    calls = {n: 0 for n in names}
    saved = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def f(*a, **k):
            calls[n] += 1
            return saved[n](*a, **k)
        return f
    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


def dist_profile(fn) -> dict:
    """One more run of fn under torch.profiler: each `dist.<phase>`
    range's calls, host ms and device ms (the kernels launched inside it),
    the int8 products (count and operations), and the card's busy share
    of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    phases, mm = {}, [0, 0]
    calls = {n: [0, 0.0] for n in DIST_LIBRARY_CALLS}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in calls:
            calls[e.name][0] += 1
            calls[e.name][1] += e.device_time_total / 1e3
        if e.name.startswith("dist."):
            p = phases.setdefault(e.name[5:], [0, 0.0, 0.0])
            p[0] += 1
            p[1] += e.cpu_time_total / 1e3
            p[2] += e.device_time_total / 1e3
        elif e.name == "aten::_int_mm" and e.input_shapes:
            (m, kk), (_, nn) = e.input_shapes[0][:2], e.input_shapes[1][:2]
            mm[0] += 1
            mm[1] += 2 * m * kk * nn

    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not e.key.startswith("dist."))
    return {"wall_s": wall, "busy_s": busy / 1e6, "phases": phases,
            "int_mm": mm[0], "int8_ops": mm[1], "library": calls}


def _phase_line(prof: dict) -> str:
    parts = [f"{n} {v[2]:.3f} ms dev / {v[1]:.3f} ms host / {v[0]} calls"
             for n, v in prof["phases"].items()]
    gram = prof["phases"].get("gram")
    if gram and gram[2] > 0:
        tops = prof["int8_ops"] / (gram[2] / 1e3) / 1e12
        parts.append(f"Gram products {prof['int_mm']}, {prof['int8_ops']:.4g}"
                     f" int8 ops, {tops:.1f} TOPS = "
                     f"{100 * tops * 1e12 / INT8_OPS_PER_S:.2f}% of the "
                     f"1979 TOPS peak")
    parts.append("library calls " + ", ".join(
        f"{n[6:]} {c[1]:.3f} ms dev / {c[0]}" for n, c in
        prof["library"].items() if c[0]))
    if not prof["busy_s"]:
        return "; ".join(parts) + "; card busy: not measured (no device time)"
    share = 100 * prof["busy_s"] / prof["wall_s"]
    return "; ".join(parts) + (f"; card busy {prof['busy_s']:.3f} s of the "
                               f"profiled wall {prof['wall_s']:.3f} s "
                               f"({share:.1f}%)")


def dist_cell(cell: str, fn, pairs: int) -> tuple:
    """fn() -> rows of calc_sketch_distances. A warm run, a timed run
    (calc, then the JSON bytes), a profiled run. Returns (rows, numbers)."""
    import torch

    from finch_tpu_torch import cli

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = fn()
    t1 = time.perf_counter()
    payload = cli._dist_json_bytes(rows)
    t2 = time.perf_counter()
    prof = dist_profile(fn)
    out = {"pairs": pairs, "rows": len(rows), "calc_s": t1 - t0,
           "json_s": t2 - t1, "json_bytes": len(payload),
           "pairs_per_s": pairs / (t2 - t0), "profile": prof}
    log(f"[dist] {cell}: {pairs} pairs, {len(rows)} rows <= {DIST_MAX}: "
        f"calc {t1 - t0:.4f} s + JSON {t2 - t1:.4f} s ({len(payload)} B) = "
        f"{pairs / (t2 - t0):.4g} pairs/s end to end")
    log(f"[dist] {cell} phases: {_phase_line(prof)}")
    return rows, out


def phase_dist(tmp: str, seed: int) -> dict:
    """`finch dist` at DB scale through calc_sketch_distances on the card,
    three cells, each held against independent host code; then the
    full-matrix path and the CLI's `dist -p`."""
    import numpy as np

    from finch_tpu_torch import cli, parallel
    from finch_tpu_torch.parallel import mxu_dist, sharded_dist
    from finch_tpu_torch.serialization.finch_bsk import write_finch_file

    rng = np.random.default_rng(seed + 5)
    k = 21.0
    L = np.full(DIST_N, DIST_K, dtype=np.int32)
    out = {}
    for cell, H in (("dist_allpairs_clustered",
                     clustered_db(rng, DIST_N, DIST_K)),
                    ("dist_allpairs_disjoint",
                     disjoint_db(rng, DIST_N, DIST_K))):
        t = time.perf_counter()
        sks = dist_sketches(H, [f"g{i:05d}" for i in range(DIST_N)])
        with count_calls(mxu_dist, ["all_pairs_survivors"]) as calls:
            rows, out[cell] = dist_cell(
                cell, lambda: cli.calc_sketch_distances(
                    sks, sks, False, DIST_MAX, device="cuda"),
                DIST_N * (DIST_N - 1))
        if calls["all_pairs_survivors"] != 3:
            raise AssertionError(f"[dist] {cell}: the survivors path ran "
                                 f"{calls} times in 3 runs")
        t_host = time.perf_counter()
        G = host_gram(H, L)
        maxima = mxu_dist._sketch_maxima(H, L)
        below = mxu_dist._below_counts(H, L, maxima)
        host_s = time.perf_counter() - t_host
        # common of every pair, and the i/j counts, against the host's
        common = mxu_dist.all_pairs_common(H, L, device="cuda")
        coo = G.tocoo()
        gr, gc = coo.row, coo.col
        if (np.count_nonzero(common) != G.nnz
                or not np.array_equal(common[gr, gc], coo.data)):
            raise AssertionError(f"[dist] {cell}: common != host Gram")
        del common
        if not np.array_equal(mxu_dist.below_counts_device(
                H, L, maxima, device="cuda"), below):
            raise AssertionError(f"[dist] {cell}: below counts != host")
        off = gr != gc
        q, r, c = gr[off], gc[off], coo.data[off]
        want = expected_rows(q, r, c, np.minimum(below[q, r], L[q]),
                             np.minimum(below[r, q], L[r]), k)
        require_rows(cell, rows, want)
        require_samples(cell, rows, sks, sks, seed, self_pairs=True)
        log(f"[dist] {cell}: common == host Gram ({G.nnz} nonzeros), i/j "
            f"== host below counts, {len(rows)} rows == the host's, "
            f"{DIST_SAMPLES} sampled pairs == distance() (host reference "
            f"{host_s:.1f} s, cell {time.perf_counter() - t:.1f} s)")
        if cell == "dist_allpairs_clustered":
            out["full_matrix"] = dist_full_matrix(H, sks, G)
            db_H, db_sks, db_G, db_below = H, sks, G, below
            out["clustered_db"] = H
            out["clustered_rows"] = len(rows)
        del rows, G, below

    # query-vs-DB: 64 of the clustered DB's sketches, renamed, spread over
    # the clusters, against all 10k: the tile engine
    cell = "dist_query_db"
    t = time.perf_counter()
    idx = np.arange(DIST_Q) * (DIST_N // DIST_Q)
    out["query_idx"] = idx
    queries = dist_sketches(db_H[idx], [f"q{i:02d}" for i in range(DIST_Q)])
    with count_calls(parallel, ["all_vs_all_arrays"]) as calls:
        rows, out[cell] = dist_cell(
            cell, lambda: cli.calc_sketch_distances(
                queries, db_sks, False, DIST_MAX, device="cuda"),
            DIST_Q * DIST_N)
    if calls["all_vs_all_arrays"] != 3:
        raise AssertionError(f"[dist] {cell}: the tile engine ran {calls}")
    c_d, i_d, j_d = (m.astype(np.int64) for m in sharded_dist.
                     all_vs_all_arrays([db_H[x] for x in idx], list(db_H),
                                       device="cuda"))
    Lq = L[idx]
    want_c = db_G[idx].toarray()
    want_i = np.minimum(db_below[idx, :], Lq[:, None])
    want_j = np.minimum(db_below[:, idx].T, L[None, :])
    for name, g, w in (("common", c_d, want_c), ("i", i_d, want_i),
                       ("j", j_d, want_j)):
        if not np.array_equal(g, w):
            raise AssertionError(f"[dist] {cell}: {name} != the host's")
    q, r = np.nonzero(want_c)
    want = expected_rows(q, r, want_c[q, r], want_i[q, r], want_j[q, r], k)
    require_rows(cell, rows, want)
    require_samples(cell, rows, queries, db_sks, seed + 1, self_pairs=False)
    log(f"[dist] {cell}: common, i, j of all {DIST_Q * DIST_N} pairs == "
        f"the host's, {len(rows)} rows == the host's, {DIST_SAMPLES} "
        f"sampled pairs == distance() (cell {time.perf_counter() - t:.1f} "
        f"s)")

    # the CLI: `dist -p` over one multi-sketch file (the Gram route), its
    # JSON bytes against the serial loop's (--backend numpy)
    t = time.perf_counter()
    bsk = os.path.join(tmp, "dist_db.bsk")
    with open(bsk, "wb") as f:
        f.write(write_finch_file(db_sks[:DIST_CLI_N]))
    for extra in ([], ["--max-dist", str(DIST_MAX)]):
        got = {}
        for backend in ("cuda", "numpy"):
            o = os.path.join(tmp, f"dist_{backend}")
            flags = (["--device", "cuda"] if backend == "cuda"
                     else ["--backend", "numpy"])
            with count_calls(mxu_dist, ["all_pairs_survivors",
                                        "all_pairs_stats"]) as calls:
                cli.run(["dist", "-p", bsk, *extra, *flags, "-o", o])
            if (backend == "cuda") != any(calls.values()):
                raise AssertionError(f"[dist] CLI {backend}: Gram calls "
                                     f"{calls}")
            with open(f"{o}.json", "rb") as f:
                got[backend] = f.read()
        if got["cuda"] != got["numpy"]:
            raise AssertionError(f"[dist] CLI dist -p {extra}: bytes differ "
                                 "from --backend numpy")
        log(f"[dist] CLI dist -p {' '.join(extra) or '(max-dist 1.0)'} over "
            f"{DIST_CLI_N} sketches: {len(got['cuda'])} B, byte-equal to "
            f"--backend numpy")
    log(f"[dist] CLI checks {time.perf_counter() - t:.1f} s")
    return out


def dist_full_matrix(H, sks, G) -> dict:
    """The full-matrix path (all_pairs_stats) at DIST_FULL_N sketches:
    every matrix against the host's, and the rows it gives when the
    survivors pass is out of contract against the survivors path's."""
    import numpy as np

    from finch_tpu_torch import cli
    from finch_tpu_torch.parallel import mxu_dist

    n = DIST_FULL_N
    H4 = H[:n]
    L4 = np.full(n, H.shape[1], dtype=np.int32)
    G4 = G[:n, :n].toarray()
    below = mxu_dist._below_counts(H4, L4, mxu_dist._sketch_maxima(H4, L4))
    i4 = np.minimum(below, L4[:, None].astype(np.int64))
    for run in ("cold", "warm"):
        t = time.perf_counter()
        c, i, j = mxu_dist.all_pairs_stats(H4, L4, device="cuda")
        secs = time.perf_counter() - t
        if not (np.array_equal(c, G4) and np.array_equal(i, i4)
                and np.array_equal(j, i4.T)):
            raise AssertionError(f"[dist] full matrix ({run}): differs "
                                 "from the host's")
        log(f"[dist] full matrix at {n}: all_pairs_stats ({run}) "
            f"{secs:.4f} s, common/i/j == the host's")
    surv = cli._calc_distances_gram(sks[:n], 0.0, 21.0, DIST_MAX,
                                    device="cuda")
    # survivors past their cap: _calc_distances_gram takes the full matrix
    saved = mxu_dist.all_pairs_survivors
    mxu_dist.all_pairs_survivors = lambda *a, **kw: None
    try:
        full = cli._calc_distances_gram(sks[:n], 0.0, 21.0, DIST_MAX,
                                        device="cuda")
    finally:
        mxu_dist.all_pairs_survivors = saved
    want = {f: getattr(surv, f"_{f}") for f in (
        "iq", "jr", "common", "total", "containment", "jaccard", "mash")}
    require_rows("full matrix", full, want)
    log(f"[dist] full matrix at {n}: {len(full)} rows == the survivors "
        f"path's")
    return {"n": n, "rows": len(full)}


WIDE_K = 51              # sourmash's standard k: 21, 31 and 51
XWIDE_K = 101
XWIDE_READS = 20_000
WIDE_SMALL_READS = 20_000  # about 2M 51-mers: cold auto stays on the host
WIDE_HOLD_BATCHES = 8    # 2M-lane batches folded on the card and the CPU
WIDE_PHASES = ("hash", "select", "batch_sort", "batch_runs", "merge_sort",
               "merge_runs")
WIDE_LIBRARY_CALLS = ("aten::sort", "aten::cumsum", "aten::searchsorted",
                      "aten::index", "aten::cat", "aten::where")


def wide_profile(fn, log_dir: str) -> dict:
    """One more run of fn under the port's profiler hook (utils.trace):
    each `wide.<phase>` range's calls, host ms and device ms, the named
    PyTorch calls' device ms, and the card's busy share of the wall."""
    from torch.autograd import DeviceType

    from finch_tpu_torch.utils import trace

    with trace(log_dir) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    phases = {n: [0, 0.0, 0.0] for n in WIDE_PHASES}
    calls = {n: [0, 0.0] for n in WIDE_LIBRARY_CALLS}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("wide."):
            p = phases.setdefault(e.name[5:], [0, 0.0, 0.0])
            p[0] += 1
            p[1] += e.cpu_time_total / 1e3
            p[2] += e.device_time_total / 1e3
        elif e.name in calls:
            calls[e.name][0] += 1
            calls[e.name][1] += e.device_time_total / 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and not e.key.startswith("wide."))
    traces = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"[wide] trace() wrote {traces}")
    return {"wall_s": wall, "busy_s": busy / 1e6, "phases": phases,
            "library": calls, "trace_bytes": os.path.getsize(
                os.path.join(log_dir, traces[0]))}


def _wide_states_equal(what: str, engines) -> None:
    from finch_tpu_torch.ops import bottomk_wide

    card, cpu = (bottomk_wide.state_to_numpy(e.state) for e in engines)
    if engines[0].capacity != engines[1].capacity or any(
            a.shape != b.shape or (a != b).any() for a, b in zip(card, cpu)):
        raise AssertionError(f"[wide] {what}: the card's state differs "
                             "from the CPU's")


def phase_wide(fq: str, tmp: str) -> dict:
    """Wide and xwide k through the port's entry points on [main]'s
    isolate: .sk bytes across backends, the wide step's device phases,
    the card's states against the CPU's, and the xwide route."""
    import torch

    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.models.engine import (HybridEngine, NumpyEngine,
                                               TorchEngine)
    from finch_tpu_torch.models.params import SketchParams
    from finch_tpu_torch.native import KmerReader
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes
    from finch_tpu_torch.tools.switch_point import (cold_card, cold_wall,
                                                    fastq_head)
    from finch_tpu_torch.utils import get_meter

    def cli_params(path: str, k: int, extra=()):
        args = cli.build_cli().parse_args(
            ["sketch", "-k", str(k), *extra, path, "-o", "unused"])
        k = cli.get_kmer_length(args)
        filters = cli.parse_filter_options(args, k)
        return cli.parse_sketch_options(args, k, filters.filter_on), filters

    def run(path, params, filters, backend: str):
        engines = []
        t = time.perf_counter()
        sk = sketch_stream(path, path, params, filters, backend=backend,
                           device="cuda", engine_out=engines)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        stats = dict(getattr(engines[0], "stats", {})) if engines else {}
        return multisketch_to_json_bytes([sk]), sk, secs, stats, engines

    t_phase = time.perf_counter()
    params, filters = cli_params(fq, WIDE_K)
    out = {"launches": {}}
    reset_launches()
    ref, sk, secs, _, _ = run(fq, params, filters, "native")
    kmers = sk.num_valid_kmers
    if len(sk.hashes) != params.expected_size():
        raise AssertionError(f"[wide] expected {params.expected_size()} "
                             f"hashes, got {len(sk.hashes)}")
    out["native"] = {"s": secs}
    log(f"[wide] k={WIDE_K} native host fold: {kmers} k-mers in {secs:.2f} "
        f"s ({kmers / secs:.4g} k-mers/s)")
    # torch, auto as on a cold card (cold_card(): the host fold of the
    # first 4M k-mers, then one migration of that state), auto on the warm
    # card (from its first batch), torch; torch's wall is the mean of two
    spans = ("engine.host_fold", "engine.migrate", "engine.warm_start")
    for name in ("torch", "auto_cold", "auto", "torch"):
        backend = name.split("_")[0]
        before = {n: (get_meter(n).calls, get_meter(n).items) for n in spans}
        with cold_card() if name == "auto_cold" else contextlib.nullcontext():
            got, _, secs, stats, engines = run(fq, params, filters, backend)
        opened = {n: (get_meter(n).calls - before[n][0],
                      get_meter(n).items - before[n][1]) for n in spans}
        if got != ref:
            raise AssertionError(f"[wide] {name} sketch differs from native")
        if name == "torch" and (stats.get("wide", 0) < 1
                                or stats.get("syncs", 0)):
            raise AssertionError(f"[wide] torch took no wide step or "
                                 f"synced on a mash run: {stats}")
        if backend == "auto" and (engines[0]._dev is None
                                  or stats.get("wide", 0) < 1):
            raise AssertionError(f"[wide] {name} did not reach the card: "
                                 f"{stats}")
        if name == "auto_cold" and (
                opened["engine.host_fold"][0] < 1
                or opened["engine.warm_start"][0]
                or opened["engine.migrate"][0] != 1
                or opened["engine.migrate"][1] < 1):
            raise AssertionError(f"[wide] auto on a cold card did not fold "
                                 f"on the host and migrate its state: "
                                 f"{opened}")
        if name == "auto" and (opened["engine.host_fold"][0]
                               or opened["engine.warm_start"][0] != 1
                               or opened["engine.migrate"] != (1, 0)):
            raise AssertionError(f"[wide] auto on the warm card did not "
                                 f"start on it empty: {opened}")
        o = out.setdefault(name, {"runs_s": [], "stats": stats})
        o["runs_s"].append(secs)
        log(f"[wide] k={WIDE_K} {name} on cuda: {kmers} k-mers in "
            f"{secs:.2f} s ({kmers / secs:.4g} k-mers/s); wide steps "
            f"{stats.get('wide', 0)}, host syncs {stats.get('syncs', 0)}"
            + (f"; spans (calls, items) {opened}" if backend == "auto"
               else "") + "; .sk identical to native")
    for o in (out["torch"], out["auto_cold"], out["auto"]):
        o["s"] = sum(o["runs_s"]) / len(o["runs_s"])
    log(f"[wide] k={WIDE_K} auto cold {out['auto_cold']['s']:.3f} s, warm "
        f"{out['auto']['s']:.3f} s / torch {out['torch']['s']:.3f} s (the "
        f"mean of 2 runs) = {out['auto_cold']['s'] / out['torch']['s']:.3f}"
        f", {out['auto']['s'] / out['torch']['s']:.3f} (native "
        f"{out['native']['s']:.3f} s)")

    # a small file, below the cold switch point: on this warm card auto
    # moves to it before the first batch; then auto and torch each in two
    # fresh processes (auto, torch, torch, auto), where auto stays on the
    # host and torch's wall holds the card's cold start
    small = fastq_head(fq, os.path.join(tmp, "isolate_small.fastq"),
                       WIDE_SMALL_READS)
    # unfiltered: at 0.6x of the genome, the error filter leaves too few
    sparams, sfilters = cli_params(small, WIDE_K, ["--no-filter"])
    sref, ssk, s_native, _, _ = run(small, sparams, sfilters, "native")
    folds = get_meter("engine.host_fold").calls
    sgot, _, s_auto, sstats, engines = run(small, sparams, sfilters, "auto")
    if (sgot != sref or engines[0]._dev is None or not sstats.get("wide")
            or get_meter("engine.host_fold").calls != folds):
        raise AssertionError("[wide] auto on the small file did not start "
                             "on the warm card or differs from native")
    cold = {"auto": [], "torch": []}
    for backend in ("auto", "torch", "torch", "auto"):
        row = cold_wall(small, WIDE_K, backend, ["--no-filter"])
        if row["sha"] != hashlib.sha256(sref).hexdigest():
            raise AssertionError(f"[wide] {backend} in a fresh process "
                                 "differs from native on the small file")
        if row["host"] != (backend == "auto"):
            raise AssertionError(f"[wide] fresh {backend} process: host "
                                 f"fold {row['host']}")
        cold[backend].append(row["s"])
    out["small"] = {"kmers": ssk.num_valid_kmers, "native_s": s_native,
                    "auto_s": s_auto, "cold_s": cold}
    log(f"[wide] k={WIDE_K} small file ({WIDE_SMALL_READS} reads, "
        f"{ssk.num_valid_kmers} k-mers): auto started on the warm card, == "
        f"native ({s_auto:.3f} s in process, native {s_native:.3f} s); "
        f"fresh processes, auto on the host: auto {cold['auto'][0]:.3f} "
        f"{cold['auto'][1]:.3f} s, torch {cold['torch'][0]:.3f} "
        f"{cold['torch'][1]:.3f} s")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"[wide] the wide path launched {launches}")
    prof = wide_profile(lambda: run(fq, params, filters, "torch"),
                        os.path.join(tmp, "wide_trace"))
    out["profile"] = prof
    log("[wide] torch run under utils.trace: " + "; ".join(
        f"wide.{n} {v[2]:.3f} ms dev / {v[1]:.3f} ms host / {v[0]} calls"
        for n, v in prof["phases"].items()))
    log("[wide] PyTorch calls: " + ", ".join(
        f"{n[6:]} {c[1]:.3f} ms dev / {c[0]}"
        for n, c in prof["library"].items() if c[0]))
    if prof["busy_s"]:
        log(f"[wide] card busy {prof['busy_s']:.3f} s of the profiled wall "
            f"{prof['wall_s']:.3f} s "
            f"({100 * prof['busy_s'] / prof['wall_s']:.1f}%); Chrome trace "
            f"{prof['trace_bytes']} B")
    else:
        log("[wide] card busy: not measured (no device time)")

    # the card against the CPU: the first batches of 2M lanes, mash (the
    # CLI's parameters) and scaled with growth, raw states after each
    t = time.perf_counter()
    batches = []
    for packed, rc in KmerReader(fq, k=WIDE_K, canonical=True,
                                 batch_size=1 << 21):
        batches.append((packed, rc))
        if len(batches) == WIDE_HOLD_BATCHES:
            break
    # where auto's time goes under the cold rule: its first batches one by
    # one (the host fold, the fold and the migration, a card step) beside
    # a TorchEngine's
    per_batch = {}
    for name, eng in (("auto", HybridEngine(params, device="cuda")),
                      ("torch", TorchEngine(params, device="cuda"))):
        per_batch[name] = []
        for packed, rc in batches[:3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with cold_card():
                eng.update(packed, rc)
            torch.cuda.synchronize()
            per_batch[name].append(time.perf_counter() - t0)
        if name == "auto" and (eng._dev is None or eng.stats != {"wide": 1}):
            raise AssertionError(f"[wide] auto did not migrate after two "
                                 f"batches: {eng.stats}")
    out["per_batch_s"] = per_batch
    log("[wide] first 3 batches of 2M lanes, s: auto (cold rule: host, "
        "host + migration, card) "
        + " ".join(f"{x:.4f}" for x in per_batch["auto"]) + "; torch "
        + " ".join(f"{x:.4f}" for x in per_batch["torch"]))

    scaled = SketchParams.scaled(kmers_to_sketch=1000, scale=0.001,
                                 kmer_length=WIDE_K)
    for name, p in (("mash", params), ("scaled", scaled)):
        engines = [TorchEngine(p, device=d) for d in ("cuda", "cpu")]
        cap0 = engines[0].capacity
        for i, (packed, rc) in enumerate(batches):
            for e in engines:
                e.update(packed, rc)
            _wide_states_equal(f"{name} batch {i}", engines)
        if name == "scaled" and engines[0].capacity <= cap0:
            raise AssertionError("[wide] the scaled state did not grow")
        log(f"[wide] {name}: {len(batches)} batches of 2M lanes, card == "
            f"CPU raw state after each (capacity {cap0} -> "
            f"{engines[0].capacity}, steps {engines[0].stats})")
    log(f"[wide] card vs CPU {time.perf_counter() - t:.1f} s")

    # xwide: k = 101 over the first reads, on the host by design
    t = time.perf_counter()
    head = os.path.join(tmp, "isolate_head.fastq")
    with open(fq, "rb") as f:
        data = f.read(XWIDE_READS * (10 + 150 + 3 + 150 + 1))
    with open(head, "wb") as f:
        f.write(data)
    xparams, xfilters = cli_params(head, XWIDE_K,
                                   ["--no-filter", "--err-filter", "0.5"])
    xref, xsk, _, _, _ = run(head, xparams, xfilters, "native")
    xgot, _, _, _, engines = run(head, xparams, xfilters, "torch")
    if xgot != xref or not isinstance(engines[0], NumpyEngine):
        raise AssertionError("[wide] xwide torch differs from native or "
                             "left the host fold")
    if any(len(h.kmer) != XWIDE_K for h in xsk.hashes):
        raise AssertionError("[wide] xwide k-mers are not 101 bases")
    log(f"[wide] k={XWIDE_K} over {XWIDE_READS} reads "
        f"({xsk.num_valid_kmers} k-mers): torch (host fold) == native, "
        f"{len(xref)} B, {time.perf_counter() - t:.1f} s")
    log(f"[wide] phase {time.perf_counter() - t_phase:.1f} s")
    out["kmers"] = kmers
    return out


# ---------------------------------------------------------------------------
# [mesh]: the sharded engine and the distance mesh forms
# ---------------------------------------------------------------------------

MESH_SHARDS = 4            # logical shards, all on cuda:0
MESH_BPD = 1 << 19         # a 2M-lane CLI batch in 4 shards of 512k lanes
MESH_SCALED_READS = 100_000
MESH_PL_READS = 200_000    # the process-local (NCCL) run's reads
MESH_DUP_BATCHES = 16
MESH_WORKERS = 4           # the process mesh's workers, all on cuda:0
MESH_KILL_BOUND_S = 60.0   # a killed worker must surface within this
# the dup64 warm fold: 4 x 262,144 distinct k-mers below 3.15% of the hash
# space, so that each shard's 200k-entry state reaches about 2.4%, the
# threshold of [dup]'s steady state
MESH_WARM = (1 << 20, 0.0315)


@contextlib.contextmanager
def engine_override(make):
    """While inside, sketch_stream folds with the engine make(params)."""
    from finch_tpu_torch.core import sketching

    orig = sketching._make_engine
    sketching._make_engine = lambda params, *a, **kw: make(params)
    try:
        yield
    finally:
        sketching._make_engine = orig


@contextlib.contextmanager
def record_widths():
    """While inside, the lane width of each step (bottomk.sketch_step_gen,
    which sketch_step and the mesh's lockstep rounds both run) is added to
    the yielded {kernel: widths} for every kernel that the step launched.
    The mesh resumes one shard's step at a time, so the launch counts read
    around each resume are that shard's (and stay as they are)."""
    from finch_tpu_torch.ops import bottomk

    seen = {n: set() for n in KERNELS}
    step_gen = bottomk.sketch_step_gen

    def spy(state, comp_lo, *a, **kw):
        gen = step_gen(state, comp_lo, *a, **kw)
        answer = None
        while True:
            before = read_launches()
            try:
                ask = gen.send(answer)
            except StopIteration as stop:
                ask, out = None, stop.value
            after = read_launches()
            for n in KERNELS:
                if after[n] > before[n]:
                    seen[n].add(comp_lo.shape[0])
            if ask is None:
                return out
            answer = yield ask

    bottomk.sketch_step_gen = spy
    try:
        yield seen
    finally:
        bottomk.sketch_step_gen = step_gen


@contextlib.contextmanager
def count_device_syncs(on_card: bool):
    """While inside, each call in which PyTorch makes the host wait for a
    card (a blocking copy, .item(), .tolist(), a stream or device
    synchronize: torch.cuda.set_sync_debug_mode) adds one to the yielded
    list. Off the card nothing is counted."""
    import warnings

    import torch

    waits = []
    if not on_card:
        yield waits
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield waits
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits.extend(w for w in caught
                 if "synchronizing CUDA operation" in str(w.message))


@contextlib.contextmanager
def record_sharded():
    """While inside, every ShardedSketchEngine built is appended to the
    list yielded."""
    from finch_tpu_torch.parallel import ShardedSketchEngine

    made = []
    init = ShardedSketchEngine.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    ShardedSketchEngine.__init__ = spy
    try:
        yield made
    finally:
        ShardedSketchEngine.__init__ = init


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh(fq: str, ref_sk: bytes, tmp: str, seed: int, dist: dict,
               smi: str, device: str = "cuda") -> dict:
    """The mesh layer on one card: ShardedSketchEngine over 4 logical
    shards on the isolate (== [main]'s native .sk, every kernel launched,
    at most half as many host syncs as shard reads, its wall over the
    torch backend's),
    the CLI's --backend mesh, a scaled run that grows, dup64 steady (the
    weighted extract), the process-local mode over a real NCCL group of
    world size 1, and the distance mesh forms on [dist]'s clustered DB.
    Each sketch path's launches are zeroed before it, read after it and
    held to its tier tallies; every shard width a kernel launched at must
    be one that [kernels] held it at. device="cpu" rehearses it on CPU
    shards, with gloo for NCCL."""
    with record_widths() as widths:
        out = _mesh_runs(fq, ref_sk, tmp, seed, dist, smi, device)
    for n, ws in out.pop("process_widths").items():
        widths[n].update(ws)  # the workers' own steps, which no spy sees
    for n, ws in widths.items():
        if ws - HELD_WIDTHS[n]:
            raise AssertionError(
                f"[mesh] {n} launched at widths {sorted(ws - HELD_WIDTHS[n])}"
                f" that [kernels] never held against its plain version")
    log(f"[mesh] shard widths launched, each held in [kernels]: "
        f"{ {n: sorted(ws) for n, ws in widths.items()} }")
    return out


def _mesh_runs(fq: str, ref_sk: bytes, tmp: str, seed: int, dist: dict,
               smi: str, device: str) -> dict:
    import numpy as np
    import torch
    import torch.distributed as tdist

    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.models.engine import NativeEngine
    from finch_tpu_torch.ops import bottomk
    from finch_tpu_torch.parallel import (Mesh, ShardedSketchEngine,
                                          distributed, mxu_dist,
                                          sharded_dist)
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes
    from finch_tpu_torch.tools.switch_point import fastq_head

    t_phase = time.perf_counter()

    def mlog(msg: str) -> None:
        log(f"[mesh] {msg} [{time.perf_counter() - t_phase:.1f} s into "
            f"the phase]")

    on_card = device == "cuda"
    card0 = torch.device("cuda", 0) if on_card else torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    mesh = Mesh([card0] * MESH_SHARDS)
    mlog(f"{mesh} on {smi}: the {MESH_SHARDS} shards share one card, "
        f"so no run here moves data between cards (a shard's .to(device) "
        f"is a no-op) and none measures traffic between them")

    def cli_params(path: str, extra=()):
        args = cli.build_cli().parse_args(["sketch", *extra, path, "-o",
                                           "unused"])
        k = cli.get_kmer_length(args)
        filters = cli.parse_filter_options(args, k)
        return cli.parse_sketch_options(args, k, filters.filter_on), filters

    def sketch(path, params, filters, make=None):
        """The .sk bytes, engine and wall of one sketch_stream run: the
        engine make(params), or the native host fold."""
        engines = []
        with (engine_override(make) if make is not None
              else contextlib.nullcontext()):
            t = time.perf_counter()
            sk = sketch_stream(path, path, params, filters,
                               backend="mesh" if make else "native",
                               device=device, engine_out=engines)
            sync()
            secs = time.perf_counter() - t
        # the native fold of a path is the fused C++ pipeline: no engine
        return (multisketch_to_json_bytes([sk]), sk,
                engines[0] if engines else None, secs)

    def sharded(bpd, m=mesh, **kw):
        return lambda p: ShardedSketchEngine(p, m, batch_size_per_device=bpd,
                                             **kw)

    out = {"launches": {}}
    params, filters = cli_params(fq)

    # isolate_30x over 4 shards of 512k lanes. A shard's column spans 8
    # chunks, not a 2M step's 32, so once a shard's state fills its steps
    # overflow no column and stay in tier A: D2 (a dirty step without a
    # chunk-column overflow) has no work here, and dup64 below launches it
    reset_launches()
    got, sk, eng, secs = sketch(fq, params, filters, sharded(MESH_BPD))
    launches = read_launches()
    kmers = sk.num_valid_kmers
    mlog(f"isolate_30x over {MESH_SHARDS} shards of {MESH_BPD} lanes: "
        f"{kmers} k-mers in {secs:.3f} s ({kmers / secs:.4g} k-mers/s); "
        f"{_tier_line(eng.stats)}; launches {launches}; .sk identical to "
        f"native: {got == ref_sk}")
    if got != ref_sk:
        raise AssertionError("[mesh] isolate_30x: .sk differs from native")
    check_launches("[mesh] isolate_30x", eng.stats, launches)
    for n in ("extract", "dedup"):
        if launches[n] < 1:
            raise AssertionError(f"[mesh] isolate_30x: {n} never launched")
    out["launches"]["mesh_isolate"] = launches
    # the lockstep step: one host wait a round answers every shard's read,
    # where a serial loop of shards waits once a read (syncs == shard_reads)
    syncs, reads = eng.stats["syncs"], eng.stats["shard_reads"]
    mlog(f"isolate_30x lockstep: {syncs} host syncs for {reads} shard "
        f"reads ({syncs / reads:.4f})")
    if syncs > 0.5 * reads:
        raise AssertionError(f"[mesh] isolate_30x: {syncs} host syncs for "
                             f"{reads} shard reads, more than half")
    # --backend torch on the same file just after: the wall the mesh's is
    # held against, in the same run
    t = time.perf_counter()
    sketch_stream(fq, fq, params, filters, backend="torch", device=device)
    sync()
    torch_s = time.perf_counter() - t
    mlog(f"isolate_30x wall: mesh {secs:.3f} s over --backend torch "
        f"{torch_s:.3f} s = {secs / torch_s:.4f}x on {smi}")

    launches, out["process_widths"] = _process_mesh_runs(
        fq, ref_sk, params, filters, card0, device, smi, mlog, sync)
    out["launches"]["mesh_process"] = launches

    # the user's entry point: `finch sketch --backend mesh`, every card
    o = os.path.join(tmp, "mesh_cli")
    reset_launches()
    with record_sharded() as made:
        t = time.perf_counter()
        cli.run(["sketch", fq, "--backend", "mesh", "--device", device,
                 "-o", o])
        secs = time.perf_counter() - t
    launches = read_launches()
    with open(f"{o}.sk", "rb") as f:
        if f.read() != ref_sk:
            raise AssertionError("[mesh] CLI --backend mesh: .sk differs "
                                 "from native")
    cards = torch.cuda.device_count() if on_card else 1
    if len(made) != 1 or made[0].mesh.size != cards:
        raise AssertionError(f"[mesh] CLI: built {made}")
    check_launches("[mesh] CLI", made[0].stats, launches)
    out["launches"]["mesh_cli"] = launches
    mlog(f"CLI sketch --backend mesh: {made[0].mesh}, "
        f"{made[0].bpd}-lane shards, {secs:.3f} s; "
        f"{_tier_line(made[0].stats)}; launches {launches}; .sk identical "
        f"to native")

    # scaled over the first reads: the 4 shards grow together
    head = fastq_head(fq, os.path.join(tmp, "head_scaled.fastq"),
                      MESH_SCALED_READS)
    sparams, sfilters = cli_params(head, ["-s", "scaled"])
    want, _, _, nat_s = sketch(head, sparams, sfilters)
    reset_launches()
    got, ssk, eng, secs = sketch(head, sparams, sfilters, sharded(MESH_BPD))
    launches = read_launches()
    first_cap = max(2 * sparams.kmers_to_sketch, 1 << 12)
    mlog(f"scaled, first {MESH_SCALED_READS} reads "
        f"({ssk.num_valid_kmers} k-mers): capacity {first_cap} -> "
        f"{eng.capacity} on every shard, {secs:.3f} s (native {nat_s:.3f} "
        f"s); {_tier_line(eng.stats)}; launches {launches}; .sk identical "
        f"to native: {got == want}")
    if got != want or eng.capacity <= first_cap:
        raise AssertionError("[mesh] scaled: the sketch differs from "
                             "native, or no shard grew")
    check_launches("[mesh] scaled", eng.stats, launches)
    out["launches"]["mesh_scaled"] = launches

    # dup64 steady: a warm fold that takes each shard to [dup]'s steady
    # threshold, then 16 batches of 2M lanes
    wlo, whi = _warm_kmers(seed + 2, *MESH_WARM)
    batches = _dup_batches(seed + 1, False, MESH_DUP_BATCHES, 1 << 21)
    nat = NativeEngine(params)
    for lo, hi in [(wlo, whi)] + batches:
        comp = (hi.astype(np.uint64) << np.uint64(32)) | lo
        nat.update(comp >> np.uint64(1),
                   (comp & np.uint64(1)).astype(np.uint8))
    want = nat.finalize_arrays()
    eng = ShardedSketchEngine(params, mesh, batch_size_per_device=MESH_BPD)
    eng.update(wlo, whi)
    eng.state = [bottomk.flush_state(st, eng._mh, k=params.k,
                                     seed=params.hash_seed)[0]
                 for st in eng.state]
    sync()
    reset_launches()
    eng.stats = {}
    t = time.perf_counter()
    with count_device_syncs(on_card) as waits:
        for lo, hi in batches:
            eng.update(lo, hi)
    sync()
    secs = time.perf_counter() - t
    launches = read_launches()
    # the lockstep's claim on the card: the host waits for it once a round
    # and at nothing else (no hidden .item()). PyTorch's count does not see
    # an event's wait, so the waits for an upload buffer's copies that had
    # not finished are the engine's own count (`upload_waits`, also in
    # `syncs`), printed beside it
    uploads = eng.stats.get("upload_waits", 0)
    mlog(f"dup64 steady: PyTorch made the host wait {len(waits)} times "
        f"in the updates; the engine counted {eng.stats['syncs']} syncs "
        f"({uploads} of them for an upload buffer) for "
        f"{eng.stats['shard_reads']} shard reads")
    if on_card and len(waits) != eng.stats["syncs"] - uploads:
        raise AssertionError(f"[mesh] dup64 steady: {len(waits)} host waits "
                             f"!= {eng.stats['syncs'] - uploads} lockstep "
                             f"rounds")
    got = eng.finalize_arrays()
    equal = all(np.array_equal(x, y) for x, y in zip(got, want))
    dk = MESH_DUP_BATCHES << 21
    mlog(f"dup64 steady, {MESH_DUP_BATCHES} batches of 2M lanes in "
        f"shards of {MESH_BPD}: {dk} k-mers in {secs:.3f} s "
        f"({dk / secs:.4g} k-mers/s); {_tier_line(eng.stats)}; launches "
        f"{launches}; sketch identical to NativeEngine: {equal}")
    if not equal:
        raise AssertionError("[mesh] dup64 steady: sketch differs from "
                             "NativeEngine's")
    check_launches("[mesh] dup64 steady", eng.stats, launches)
    for n in ("extract_weighted", "dedup_slab"):
        if launches[n] < 1:
            raise AssertionError(f"[mesh] dup64 steady: {n} never launched")
    out["launches"]["mesh_dup64"] = launches

    # process-local mode over a real NCCL group of world size 1
    head = fastq_head(fq, os.path.join(tmp, "head_pl.fastq"), MESH_PL_READS)
    want, _, _, _ = sketch(head, params, filters)
    distributed.initialize(f"127.0.0.1:{free_port()}", num_processes=1,
                           process_id=0, device=device)
    try:
        backend = tdist.get_backend()
        if backend != ("nccl" if on_card else "gloo"):
            raise AssertionError(f"[mesh] process group on {backend}")
        pl_mesh = Mesh([card0] * 2, group=tdist.group.WORLD)
        reset_launches()
        got, psk, eng, secs = sketch(head, params, filters,
                                     sharded(MESH_BPD, pl_mesh,
                                             process_local=True))
        launches = read_launches()
    finally:
        tdist.destroy_process_group()
    if got != want:
        raise AssertionError("[mesh] process-local: .sk differs from native")
    check_launches("[mesh] process-local", eng.stats, launches)
    out["launches"]["mesh_process_local"] = launches
    mlog(f"process-local over {backend} (world size 1, {pl_mesh}), "
        f"first {MESH_PL_READS} reads ({psk.num_valid_kmers} k-mers) in "
        f"shards of {MESH_BPD}: {secs:.3f} s; {_tier_line(eng.stats)}; "
        f"launches {launches}; the finalize's all_gather ran on {backend}; "
        f".sk identical to native")

    # the distance mesh forms on [dist]'s clustered DB
    H = dist["clustered_db"]
    L = np.full(H.shape[0], H.shape[1], dtype=np.int32)

    def timed(fn):
        sync()
        t = time.perf_counter()
        r = fn()
        sync()
        return r, time.perf_counter() - t

    want, flat_s = timed(lambda: mxu_dist.all_pairs_common(H, L,
                                                           device=device))
    got, mesh_s = timed(lambda: mxu_dist.sharded_common(H, L, mesh))
    if not np.array_equal(got, want):
        raise AssertionError("[mesh] sharded_common != all_pairs_common")
    del want, got
    mlog(f"sharded_common over {MESH_SHARDS} shards, {H.shape[0]} x "
        f"{H.shape[1]} clustered: {mesh_s:.3f} s, all_pairs_common "
        f"{flat_s:.3f} s; equal integer for integer")
    qs = [H[i] for i in dist["query_idx"]]
    rs = list(H)
    want, flat_s = timed(lambda: sharded_dist.all_vs_all_arrays(
        qs, rs, device=device))
    got, mesh_s = timed(lambda: sharded_dist.all_vs_all_arrays(
        qs, rs, mesh=mesh))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("[mesh] all_vs_all_arrays(mesh=) != unsharded")
    mlog(f"all_vs_all_arrays over {MESH_SHARDS} shards, {len(qs)} x "
        f"{len(rs)}: {mesh_s:.3f} s, unsharded {flat_s:.3f} s; equal")
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _process_mesh_runs(fq: str, ref_sk: bytes, params, filters, card0,
                       device: str, smi: str, mlog, sync):
    """The process mesh (one worker process a card) over MESH_WORKERS
    logical cards of cuda:0: its pool's start-up, the isolate through
    sketch_stream (== native's .sk; the workers' summed launches held to
    their summed tiers; its wall over the torch backend's just after),
    then a worker killed mid-stream, which must make the parent raise
    within MESH_KILL_BOUND_S and leave no process and no shared memory.
    The workers' launches are their own counters, zero at the stream's
    open: this process's stay 0. Returns the isolate's summed launches
    and the lane widths each kernel ran at in the workers."""
    import numpy as np

    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.errors import FinchError
    from finch_tpu_torch.parallel.process_mesh import (ProcessMeshEngine,
                                                       get_pool)
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    devices = [card0] * MESH_WORKERS
    batch = 1 << 21
    t = time.perf_counter()
    pool = get_pool(devices, batch)
    startup = pool.wait_ready()
    phases = [{n: round(v, 3) for n, v in p.items()}
              for p in pool.startup_phases]
    mlog(f"process mesh: {MESH_WORKERS} worker processes on {card0} "
         f"(pids {pool.worker_pids}) started in {startup:.3f} s (spawn to "
         f"the last worker's ready; {time.perf_counter() - t:.3f} s in "
         f"this process); each worker's marks, s after the spawn: "
         f"{phases}")
    made = []
    reset_launches()
    with engine_override(lambda p: made.append(ProcessMeshEngine(
            p, devices, batch_size=batch)) or made[-1]):
        t = time.perf_counter()
        sk = sketch_stream(fq, fq, params, filters, backend="mesh",
                           device=device)
        secs = time.perf_counter() - t
    mine = read_launches()
    got = multisketch_to_json_bytes([sk])
    eng = made[0]
    launches = eng.stats["launches"]
    mlog(f"process mesh isolate_30x: {sk.num_valid_kmers} k-mers in "
         f"{secs:.3f} s; {_tier_line(eng.stats)}; worker steps "
         f"{eng.stats['worker_steps']}; the workers' launches {launches} "
         f"(this process's {mine}); .sk identical to native: "
         f"{got == ref_sk}")
    if got != ref_sk:
        raise AssertionError("[mesh] process mesh: .sk differs from native")
    if eng.pool is not pool or any(mine.values()):
        raise AssertionError(f"[mesh] process mesh: another pool, or "
                             f"launches in this process {mine}")
    check_launches("[mesh] process mesh", eng.stats, launches)
    t = time.perf_counter()
    sketch_stream(fq, fq, params, filters, backend="torch", device=device)
    sync()
    torch_s = time.perf_counter() - t
    mlog(f"process mesh wall: {secs:.3f} s over --backend torch "
         f"{torch_s:.3f} s = {secs / torch_s:.4f}x on {smi} (start-up "
         f"{startup:.3f} s apart); {MESH_WORKERS} processes share one card")

    # a worker killed mid-stream: the parent raises within its bound
    pids, names = list(pool.worker_pids), pool.shm_names()
    eng = ProcessMeshEngine(params, devices, batch_size=batch)
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 4 ** 21, size=batch, dtype=np.uint64)
    rc = np.zeros(batch, dtype=np.uint8)
    for _ in range(3):
        eng.update(pk, rc)
    os.kill(pids[1], signal.SIGKILL)
    t = time.perf_counter()
    try:
        for _ in range(4 * MESH_WORKERS):
            eng.update(pk, rc)
        eng.finalize_arrays()
    except FinchError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0]}"
    else:
        raise AssertionError("[mesh] killed worker: the parent went on")
    secs = time.perf_counter() - t
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    left = [n for n in names
            if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]
    mlog(f"process mesh, worker {pids[1]} killed after 3 batches: raised "
         f"in {secs:.3f} s ({raised}); processes left {alive}, shared "
         f"memory left {left}")
    if secs > MESH_KILL_BOUND_S or alive or left or not pool.closed:
        raise AssertionError("[mesh] killed worker: raised too late or "
                             "left a process or shared memory behind")
    return launches, made[0].stats["widths"]


def profile_torch_run(fn) -> None:
    """One more torch-backend run under torch.profiler (outside the timed
    runs; the profiler slows the host): device-busy share and the device
    time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total = sum(dev_us(e) for e in events)
    if not total:
        log("[profile] torch.profiler recorded no device time: not measured")
        return
    log(f"[profile] torch run under the profiler: wall {wall:.3f} s, device "
        f"busy {total / 1e6:.3f} s ({100 * total / 1e6 / wall:.1f}% of wall)")
    top = sorted(events, key=dev_us, reverse=True)
    for e in top[:8]:
        log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6} "
            f"{e.key[:90]}")
    # the port's own kernels, wherever they rank
    for e in top[8:]:
        if any(n in e.key for n in LAUNCH_NAMES):
            log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6} "
                f"{e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated input")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "finch_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)  # goldens name their inputs by repo-relative path

    smi = nvidia_smi("name,power.limit")
    card = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "clock_hz": float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6,
    }
    log(f"[card] {smi} | {card['kind']} | {card['sms']} SMs, max SM clock "
        f"{card['clock_hz'] / 1e6:.0f} MHz | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="finch_chip_smoke_")
    try:
        phase_build()
        rows = phase_kernels(opts.seed, card)
        phase_goldens(tmp)
        main_path = phase_main_path(tmp, opts.seed)
        dup = phase_dup(opts.seed)
        dist = phase_dist(tmp, opts.seed)
        phase_wide(main_path["fastq"], tmp)
        mesh = phase_mesh(main_path["fastq"], main_path["ref"], tmp,
                          opts.seed, dist, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    # launches: the extract's on the main path (the auto backend on a cold
    # card, the `finch sketch` of one file a user calls), the other
    # kernels' on the duplicate-burst path ([dup], both streams, default
    # configuration); every path's own count, each zeroed just before its
    # run, beside it, the mesh paths' ([mesh] isolate, CLI, scaled, dup64
    # steady and process-local) included
    by_path = {**main_path["launches"], **dup["launches"],
               **mesh["launches"]}
    dup_total = {n: sum(dup["launches"][s][n] for s in dup["launches"])
                 for n in KERNELS}
    sources = {"extract": "extract.cu", "extract_weighted": "extract.cu",
               "dedup": "dedup.cu", "dedup_slab": "dedup.cu"}
    replaces = {"extract": "finch_tpu/ops/pallas_extract.py:133",
                "extract_weighted": "finch_tpu/ops/pallas_extract.py:133",
                "dedup": "finch_tpu/ops/pallas_extract.py:602",
                "dedup_slab": "finch_tpu/ops/pallas_extract.py:772"}
    entries = []
    for n in KERNELS:
        launches = (main_path["launches"]["auto_cold"][n]
                    if n == "extract" else dup_total[n])
        if launches < 1:
            raise AssertionError(f"{n} launched no time on its path")
        row = rows[n]
        entries.append({
            "name": n, "route": "cuda",
            "source": f"finch_tpu_torch/csrc/{sources[n]}",
            "replaces": replaces[n], "launches": launches,
            "launches_by_path": {p: c[n] for p, c in by_path.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": card["kind"],
                                             "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
