#!/usr/bin/env python3
"""Smoke run of finch_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one CUDA card. It builds
every kernel of the port's main path from the sources in the checkout,
holds each kernel against its plain PyTorch version at the main path's
shapes (exact equality: the outputs are integers), reproduces the frozen
goldens through the port's CLI on the card, and sketches a simulated
bacterial-isolate sequencing run (a 5 Mbp random genome, 150 bp reads at
30x coverage, 0.5% substitutions, half the reads reverse-complemented:
about 1M reads and 130M 21-mers) at the CLI defaults three ways: the auto
backend on the card (host fold migrating to the device), the torch backend
on the card (a cold start on the device) and the native host fold, an
independent implementation. The three .sk byte strings must be identical.

Every phase raises on failure and the script exits non-zero. Without a
card, or without the finch_tpu_torch package beside it, it fails before
printing any result. The last lines are the card (nvidia-smi), one JSON
line with each kernel's numbers, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    """Build the kernel library (nvcc) and the host parser (g++) at once."""
    from finch_tpu_torch import native
    from finch_tpu_torch.ops import extract

    t0 = time.perf_counter()
    errors = []
    result = {}

    def run(name, fn):
        try:
            result[name] = fn()
        except Exception as err:  # re-raised below, after both joined
            errors.append(err)

    threads = [threading.Thread(target=run, args=("extract", extract.build)),
               threading.Thread(target=run, args=("native", native.lib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    secs = time.perf_counter() - t0
    nvcc_out = result["extract"][1]
    log(f"[build] extract.cu (nvcc) + finch_native.cpp (g++) in {secs:.2f} s"
        f"{'' if nvcc_out else ' (extract library cached)'}")
    ptxas = [ln for ln in nvcc_out.splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas[-4:]:
        log(f"[build] {ln.strip()}")


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


def _device_us_per_call(fn, calls: int) -> dict:
    """Device time per call of each extract launch, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("extract_select", "extract_merge"):
            if name in e.key:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                out[name] = out.get(name, 0.0) + us / calls
    return out


def phase_extract(seed: int, card: dict) -> dict:
    """Kernel vs plain version on the main path's inputs."""
    import numpy as np
    import torch

    from finch_tpu_torch import u64
    from finch_tpu_torch.ops import extract

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
    cases = [
        ("uniform_warm", K_MAIN, 0, v, warm),
        # the engines' default batch (sketch_stream batch_size=2M)
        ("uniform_warm_2M", K_MAIN, 0, v[:b // 2], warm),
        ("cold", K_MAIN, 0, v, 2**64 - 1),
        ("dup64_stride", K_MAIN, 0, np.tile(v[:b // 64], 64), warm),
        ("one_chunk_k28", 28, 42,
         (rng.integers(0, 4 ** 28, size=extract.CHUNK, dtype=np.uint64)
          << np.uint64(1)) | rc[:extract.CHUNK], int(0.3 * 2**64)),
    ]
    row = None
    for name, k, s, lanes, th in cases:
        vlo, vhi = _planes(lanes, dev)
        tt = torch.tensor([u64.to_i64(th)], device=dev)
        got = extract.extract_candidates(vlo, vhi, tt, k=k, seed=s)
        torch.cuda.synchronize()
        want = extract.extract_candidates_plain(vlo, vhi, tt, k=k, seed=s)
        for g, w, what in zip(got, want, ("cand", "slab", "hash_lo",
                                          "hash_hi", "covf", "aovf")):
            if not torch.equal(g, w):
                raise AssertionError(f"extract kernel != plain on {name}: "
                                     f"{what}")
        flags = (int(got[4]), int(got[5]))
        for _ in range(3):
            extract.extract_candidates(vlo, vhi, tt, k=k, seed=s)
        def launch():
            extract.extract_candidates(vlo, vhi, tt, k=k, seed=s)

        ms = _time_ms(launch, 20, 10)
        plain_ms = _time_ms(lambda: extract.extract_candidates_plain(
            vlo, vhi, tt, k=k, seed=s), 5, 1)
        split = _device_us_per_call(launch, 20)
        pad = (vlo == -1) & (vhi == -1)
        h = u64.join(want[2], want[3])
        kept = int((~pad & u64.le(h, tt.reshape(()))).sum())
        slab_real = int((want[1] != u64.MAX).sum())
        lanes_n = lanes.shape[0]
        ops = extract_int_ops(k, lanes_n, kept, slab_real)
        t_ops = ops / (card["sms"] * INT32_OPS_PER_CLK_PER_SM
                       * card["clock_hz"])
        t_bytes = extract_bytes(lanes_n) / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[extract] {name}: b={lanes_n} k={k} seed={s} equal=yes "
            f"covf,aovf={flags} kept={kept} "
            f"kernel {ms:.4f} ms (median of 20 x 10 launches; device "
            f"{ {n: round(v, 1) for n, v in split.items()} } us) plain "
            f"{plain_ms:.3f} ms bound {bound_ms * 1e3:.1f} us ({bound_by}: "
            f"ops {t_ops * 1e6:.1f} us, bytes {t_bytes * 1e6:.1f} us)")
        if name == "uniform_warm":
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        if name == "cold" and flags[0] != 1:
            raise AssertionError("cold threshold must overflow a column")
        if name == "dup64_stride" and flags[1] != 1:
            raise AssertionError("dup64 must overflow the accumulator")
    row["max_abs_err"] = 0  # every case above required exact equality
    return row


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


def phase_goldens(tmp: str) -> float:
    """The port's CLI on the card reproduces the frozen goldens."""
    from finch_tpu_torch import cli

    t0 = time.perf_counter()
    for golden, args in GOLDENS:
        ext = golden.rsplit(".", 1)[1]
        out = os.path.join(tmp, "golden_out")
        cli.run(["sketch", "--backend", "torch", "--device", "cuda", *args,
                 "-o", out])
        with open(f"{out}.{ext}", "rb") as f:
            got = f.read()
        with open(os.path.join(REPO, "tests", "data", "goldens", golden),
                  "rb") as f:
            if got != f.read():
                raise AssertionError(f"golden {golden} differs on the card")
    secs = time.perf_counter() - t0
    log(f"[goldens] 5/5 byte-equal through the CLI on cuda in {secs:.2f} s")
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


def phase_main_path(tmp: str, seed: int) -> dict:
    """The main path at real scale: CLI-default sketches three ways."""
    import torch

    from finch_tpu_torch import cli
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.ops import extract
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

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

    out = {"native_s": native_s, "kmers": kmers, "launches": {}}
    for backend in ("auto", "torch"):
        extract.extract_candidates.launches = 0
        got, _, secs, stats = run(backend, "cuda")
        launches = extract.extract_candidates.launches
        if got != ref:
            raise AssertionError(f"{backend} sketch differs from native")
        tiers = {t: stats.get(f"tier_{t}", 0) for t in "ABC"}
        steps = sum(tiers.values())
        if launches < 1 or launches != steps:
            raise AssertionError(f"{backend}: extract launched {launches} "
                                 f"times for {steps} kernel-path steps")
        log(f"[main] {backend} on cuda: {kmers} k-mers in {secs:.2f} s "
            f"({kmers / secs:.4g} k-mers/s); device steps per tier "
            f"{tiers}, other steps "
            f"{ {t: stats[t] for t in ('two_stage', 'small') if t in stats} }"
            f", host syncs {stats.get('syncs', 0)}, extract launches "
            f"{launches}; .sk identical to native")
        out[backend] = {"s": secs, "tiers": tiers,
                        "syncs": stats.get("syncs", 0)}
        out["launches"][backend] = launches
    profile_torch_run(lambda: run("torch", "cuda"))
    return out


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
    for e in sorted(events, key=dev_us, reverse=True)[:8]:
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
        row = phase_extract(opts.seed, card)
        phase_goldens(tmp)
        main_path = phase_main_path(tmp, opts.seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "extract",
        "route": "cuda",
        "source": "finch_tpu_torch/csrc/extract.cu",
        "replaces": "finch_tpu/ops/pallas_extract.py:133",
        # the default backend's run (the `finch sketch` a user calls);
        # every path's own count, each zeroed just before its run, beside it
        "launches": main_path["launches"]["auto"],
        "launches_by_path": main_path["launches"],
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": card["kind"],
                                             "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
