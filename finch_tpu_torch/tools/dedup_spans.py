"""Where a tier-D step's time goes on the card: clock64 spans.

    python -m finch_tpu_torch.tools.dedup_spans [--seed N]

Run from the root of a checkout on a machine with one CUDA card. It copies
``csrc/dedup.cu`` into a temporary directory, inserts clock64 spans into
the copy (around each accumulator pass, copies-only step and stage sort,
and each warp's whole tier-D walk),
builds the copy with nvcc and runs tier D and tier D2 once on each case
after a warm-up launch. The committed kernel carries no instrumentation.

A span counts SM cycles from a warp's start of the work to its end,
including the cycles its SM spends on other warps: what the step costs on
the column's chain. A dense pass takes more than SORT_MIN values (the
sorted path), a sparse pass fewer; a copies-only step adds the copies of
held heads to their weights. Reading clock64 adds a few cycles to each
span; compare spans with each other, not with the kernel's event time.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

SPANS = 14  # cycles and count: dense pass, sparse pass, stage sort,
#             copies-only step, the whole tier-D walk, the wait for a
#             stage's copies, the stage barrier


def instrument(src: str) -> str:
    """dedup.cu with the spans inserted: each warp sums its spans in
    registers (DupColumn::span) and lane 0 adds them to g_spans once, at
    the end. Every insertion point must exist as often as given."""
    edits = [
        ("namespace {\n", 1,
         "namespace {\n__device__ unsigned long long g_spans[14];\n"),
        ("  bool ovf = false;\n", 1,
         "  bool ovf = false;\n  long long span[14] = {};\n"),
        ("    cp_async_wait<RAW_SLOTS - 2>();", 1,
         "    const long long span4 = clock64();\n"
         "    cp_async_wait<RAW_SLOTS - 2>();\n"
         "    column.span[10] += clock64() - span4;\n"
         "    column.span[11] += 1;\n   "),
        ("    __syncthreads();\n    if (s + RAW_SLOTS - 1 < nstages)", 1,
         "    const long long span5 = clock64();\n"
         "    __syncthreads();\n"
         "    column.span[12] += clock64() - span5;\n"
         "    column.span[13] += 1;\n"
         "    if (s + RAW_SLOTS - 1 < nstages)"),
        ("  __device__ void pass(uint64_t x, bool ascending) {\n", 1,
         "  __device__ void pass(uint64_t x, bool ascending) {\n"
         "    const long long span0 = clock64();\n"),
        ("    m = kept;\n    moved = true;\n    __syncwarp();\n", 1,
         "    m = kept;\n    moved = true;\n    __syncwarp();\n"
         "    span[sorted ? 0 : 2] += clock64() - span0;\n"
         "    span[sorted ? 1 : 3] += 1;\n"),
        ("  __device__ bool add_hits(uint64_t x) {\n", 1,
         "  __device__ bool add_hits(uint64_t x) {\n"
         "    const long long span3 = clock64();\n"),
        ("    __syncwarp();\n    return true;\n", 1,
         "    __syncwarp();\n"
         "    span[6] += clock64() - span3;\n    span[7] += 1;\n"
         "    return true;\n"),
        ("    const unsigned ascending =\n", 1,
         "    const long long span1 = clock64();\n"
         "    const unsigned ascending =\n"),
        ("    for (int j = 0; j < steps; ++j) {\n", 1,
         "    if (ascending) {\n"
         "      column.span[4] += clock64() - span1;\n"
         "      column.span[5] += 1;\n"
         "    }\n"
         "    for (int j = 0; j < steps; ++j) {\n"),
        ("  const uint64_t th = *thresh;\n", 1,
         "  const uint64_t th = *thresh;\n"
         "  const long long span2 = clock64();\n"),
        ("  __syncthreads();  // the ring is idle", 1,
         "  column.span[8] += clock64() - span2;\n"
         "  column.span[9] += 1;\n"
         "  __syncthreads();  // the ring is idle"),
        ("  store_tile<DUP_ACC_H>(out, cand, col0);\n", 2,
         "  if (lane == 0)\n"
         "    for (int q = 0; q < 14; ++q)\n"
         "      atomicAdd(&g_spans[q], (unsigned long long)column.span[q]);\n"
         "  store_tile<DUP_ACC_H>(out, cand, col0);\n"),
    ]
    for old, count, new in edits:
        if src.count(old) != count:
            raise SystemExit(f"dedup_spans: insertion point found "
                             f"{src.count(old)} times, not {count}: {old!r}")
        src = src.replace(old, new)
    return src + """
extern "C" int spans_read(void* out) {
  return int(cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans)));
}
extern "C" int spans_reset() {
  unsigned long long z[14] = {};
  return int(cudaMemcpyToSymbol(g_spans, z, sizeof(z)));
}
"""


def build(tmp: str) -> ctypes.CDLL:
    from finch_tpu_torch.ops import cuda_lib

    csrc = cuda_lib.CSRC
    with open(os.path.join(csrc, "dedup.cu")) as f:
        src = instrument(f.read())
    path = os.path.join(tmp, "dedup_spans.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(tmp, "libdedup_spans.so")
    cmd = [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-I", csrc, "-o", so, path]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.finch_dedup.restype = ctypes.c_int
    lib.finch_dedup.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                ctypes.c_int, p, p, p]
    lib.finch_dedup_slab.restype = ctypes.c_int
    lib.finch_dedup_slab.argtypes = [p, ctypes.c_longlong, ctypes.c_int, p,
                                     p, p]
    lib.spans_read.argtypes = [p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    from finch_tpu_torch import u64
    from finch_tpu_torch.ops import extract

    if not torch.cuda.is_available():
        print("dedup_spans: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[spans] {smi}", flush=True)
    dev = torch.device("cuda")
    k = 21
    b = 1 << 22
    rng = np.random.default_rng(opts.seed)
    v = ((rng.integers(0, 4 ** k, size=b, dtype=np.uint64) << np.uint64(1))
         | rng.integers(0, 2, size=b, dtype=np.uint64))
    v[-1000:] = np.uint64(2**64 - 1)
    dup_warm = int(0.024 * 2**64)
    cases = [
        ("cold_dup64_stride", np.tile(v[:b // 64], 64), 2**64 - 1, "D"),
        ("cold_dup64_stride_2M", np.tile(v[:b // 128], 64), 2**64 - 1, "D"),
        ("cold_uniform_2M", v[:b // 2], 2**64 - 1, "D"),
        ("sparse_warm_2M", v[:b // 2], int(50 / 1024 * 2**64), "D"),
        ("sparse_warm", v, int(50 / 1024 * 2**64), "D"),
        ("dup_shuffle_2M", np.tile(v[:b // 128], 64)[rng.permutation(b // 2)],
         dup_warm, "D2"),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for name, lanes, th, tier in cases:
            lo = u64.from_numpy((lanes & np.uint64(0xFFFFFFFF)).astype(
                np.uint32), dev)
            hi = u64.from_numpy((lanes >> np.uint64(32)).astype(np.uint32),
                                dev)
            tt = torch.tensor([u64.to_i64(th)], device=dev)
            ex = extract.extract_candidates(lo, hi, tt, k=k, seed=0)
            cand = torch.empty(96 * 2048, dtype=torch.int64, device=dev)
            flag = torch.empty((), dtype=torch.int32, device=dev)
            nch = lanes.shape[0] // extract.CHUNK

            def launch():
                stream = torch.cuda.current_stream().cuda_stream
                if tier == "D":
                    err = lib.finch_dedup(
                        lo.data_ptr(), hi.data_ptr(), ex[2].data_ptr(),
                        ex[3].data_ptr(), tt.data_ptr(), nch, 2 * k + 2,
                        cand.data_ptr(), flag.data_ptr(), stream)
                else:
                    err = lib.finch_dedup_slab(
                        ex[1].data_ptr(), nch, 2 * k + 2, cand.data_ptr(),
                        flag.data_ptr(), stream)
                if err:
                    raise SystemExit(f"launch failed: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if lib.spans_reset():
                raise SystemExit("spans_reset failed")
            launch()
            torch.cuda.synchronize()
            s = (ctypes.c_ulonglong * SPANS)()
            if lib.spans_read(s):
                raise SystemExit("spans_read failed")
            warps = 2048

            def per(c, n):
                return f"{s[c] / s[n]:.0f}" if s[n] else "-"
            print(f"[spans] {tier} {name}: b={lanes.shape[0]} dense passes "
                  f"{s[1] / warps:.2f}/column at {per(0, 1)} cycles; sparse "
                  f"passes {s[3] / warps:.2f}/column at {per(2, 3)} cycles; "
                  f"copies-only steps {s[7] / warps:.2f}/column at "
                  f"{per(6, 7)} cycles; stage sorts {s[5] / warps:.2f}/column "
                  f"at {per(4, 5)} cycles; walk {per(8, 9)} cycles/column, "
                  f"of which waiting for copies {per(10, 11)} and at the "
                  f"barrier {per(12, 13)} cycles a stage; dovf {int(flag)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
