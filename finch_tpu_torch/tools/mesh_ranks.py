"""The mesh across processes, one a card, joined by NCCL.

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        finch_tpu_torch/tools/mesh_ranks.py FASTQ [--out DIR] [--seed S]
        [--db N] [--device cpu]

Each process (rank) takes card LOCAL_RANK and joins the group through
`distributed.initialize()` (torchrun's environment), then:

* start-up: the time initialize() took, and the time of the first
  collective, a one-word all_reduce;
* sketch: every rank parses FASTQ at the CLI defaults (its share of the
  machine's cores) and feeds `ShardedSketchEngine(process_local=True)` over
  `distributed.global_mesh()` its own batches of 2M k-mers: every N-th one,
  from its rank on. A rank with fewer batches steps on empty ones until
  every rank has stepped as often (the process-local contract). The
  finalize's all_gather gives every rank the merged sketch. Rank 0
  sketches FASTQ with the torch backend on its card alone, and the bytes
  must be equal (with --out, both .sk files are written into DIR);
* distance: every rank makes chip_smoke's [dist] clustered DB (10,000
  sketches of 1,000 hashes, the same seed; --db N cuts it) and runs
  `mxu_dist.sharded_common` and `sharded_dist.all_vs_all_arrays(mesh=)` (64
  queries spread over the DB) over the ranks; rank 0 holds both against
  `all_pairs_common` and the unsharded tiles on its card alone.

Every collective the engines call is timed between two synchronizes of
the card, and its bytes counted (an all_gather's: what each rank sends).
Rank 0 prints the card (nvidia-smi's name and power limit), one JSON line
a phase and one a collective, each rank one line of its own walls. Exits
non-zero on rank 0 when a result differs from the one-card one.
--device cpu rehearses it in CPU processes joined by gloo (no card, and
no time in it is a card's).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 1 << 21   # the CLI's batch: one step of each rank's shard
DIST_SEED = 5     # chip_smoke's phase_dist draws its DB from seed + 5


class EveryNth:
    """An engine for sketch_stream that feeds `engine` every `world`-th
    batch from `rank` on; before finalizing it steps `engine` on empty
    batches until it has stepped as often as the rank with the most."""

    wants_composite = True

    def __init__(self, engine, rank: int, world: int):
        self.engine, self.rank, self.world = engine, rank, world
        self.seen = self.fed = 0

    @property
    def stats(self) -> dict:
        return self.engine.stats

    def update(self, packed, rc) -> None:
        if self.seen % self.world == self.rank:
            self.engine.update(packed, rc)
            self.fed += 1
        self.seen += 1

    def finalize_arrays(self):
        empty = np.empty(0, dtype=np.uint32)
        for _ in range(-(-self.seen // self.world) - self.fed):
            self.engine.update(empty, empty)
        return self.engine.finalize_arrays()


def time_collectives(log: list, sync):
    """Wrap torch.distributed's all_reduce and all_gather (the engines
    look them up at each call) so that each call is timed between two
    sync()s and appended to `log`; returns the undo."""
    import torch.distributed as tdist

    orig = {n: getattr(tdist, n) for n in ("all_reduce", "all_gather")}

    def wrap(name, fn):
        def call(*a, **kw):
            sent = a[1] if name == "all_gather" else a[0]
            sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            log.append({"collective": name, "shape": list(sent.shape),
                        "dtype": str(sent.dtype).replace("torch.", ""),
                        "bytes": sent.numel() * sent.element_size(),
                        "s": time.perf_counter() - t})
            return out
        return call

    for n, f in orig.items():
        setattr(tdist, n, wrap(n, f))
    return lambda: [setattr(tdist, n, f) for n, f in orig.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("fastq")
    ap.add_argument("--out", metavar="DIR",
                    help="where rank 0 writes both .sk files (ranks.sk, "
                         "torch.sk); none are written without it")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke's --seed: the [dist] DB's")
    ap.add_argument("--db", type=int, default=None,
                    help="sketches in the distance DB (default [dist]'s)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    opts = ap.parse_args(argv)

    import torch
    import torch.distributed as tdist

    on_card = opts.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("mesh_ranks: no CUDA device", file=sys.stderr)
        return 2

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    sys.path.insert(0, CHECKOUT)
    import chip_smoke
    from finch_tpu_torch import cli
    from finch_tpu_torch.core import sketching
    from finch_tpu_torch.parallel import (ShardedSketchEngine, distributed,
                                          mxu_dist, sharded_dist)
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    t = time.perf_counter()
    distributed.initialize(device=opts.device)
    init_s = time.perf_counter() - t
    rank, world = tdist.get_rank(), tdist.get_world_size()
    card = torch.cuda.current_device() if on_card else None
    t = time.perf_counter()
    one = torch.ones(1, dtype=torch.int32, device=opts.device)
    tdist.all_reduce(one)
    sync()
    first_s = time.perf_counter() - t
    primary = rank == 0

    def say(obj) -> None:
        if primary:
            print(json.dumps(obj), flush=True)

    if primary and on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    say({"phase": "start-up", "ranks": world, "backend": tdist.get_backend(),
         "initialize_s": init_s, "first_all_reduce_s": first_s,
         "all_reduce_sum": int(one)})

    log: list = []
    undo = time_collectives(log, sync)
    mesh = distributed.global_mesh()
    args = cli.build_cli().parse_args(["sketch", opts.fastq, "-o", "unused"])
    k = cli.get_kmer_length(args)
    filters = cli.parse_filter_options(args, k)
    params = cli.parse_sketch_options(args, k, filters.filter_on)
    engines = []
    make = sketching._make_engine
    sketching._make_engine = lambda p, *a, **kw: EveryNth(
        ShardedSketchEngine(p, mesh, batch_size_per_device=BATCH,
                            process_local=True), rank, world)
    threads = max(1, (os.cpu_count() or 1) // world)
    try:
        tdist.barrier()
        t = time.perf_counter()
        sk = sketching.sketch_stream(
            opts.fastq, opts.fastq, params, filters, backend="mesh",
            device=opts.device, parser_threads=threads, engine_out=engines)
        sync()
        mesh_s = time.perf_counter() - t
    finally:
        sketching._make_engine = make
    got = multisketch_to_json_bytes([sk])
    [eng] = engines
    print(json.dumps({"rank": rank, "card": card, "batches_fed": eng.fed,
                      "batches_seen": eng.seen, "sketch_s": mesh_s,
                      "stats": eng.stats}), flush=True)
    ok = True
    if primary:
        t = time.perf_counter()
        ref = sketching.sketch_stream(opts.fastq, opts.fastq, params,
                                      filters, backend="torch",
                                      device=opts.device)
        sync()
        torch_s = time.perf_counter() - t
        want = multisketch_to_json_bytes([ref])
        if opts.out:
            os.makedirs(opts.out, exist_ok=True)
            for name, data in (("ranks.sk", got), ("torch.sk", want)):
                with open(os.path.join(opts.out, name), "wb") as f:
                    f.write(data)
        ok &= got == want
        say({"phase": "sketch", "kmers": sk.num_valid_kmers,
             "ranks_s": mesh_s, "torch_one_card_s": torch_s,
             "sk_equal": got == want,
             "sk_sha256": hashlib.sha256(got).hexdigest()[:16]})
    tdist.barrier()

    rng = np.random.default_rng(opts.seed + DIST_SEED)
    H = chip_smoke.clustered_db(rng, opts.db or chip_smoke.DIST_N,
                                chip_smoke.DIST_K)
    L = np.full(H.shape[0], H.shape[1], dtype=np.int32)
    tdist.barrier()
    t = time.perf_counter()
    common = mxu_dist.sharded_common(H, L, mesh)
    sync()
    common_s = time.perf_counter() - t
    idx = np.arange(chip_smoke.DIST_Q) * (len(H) // chip_smoke.DIST_Q)
    qs, rs = [H[i] for i in idx], list(H)
    tdist.barrier()
    t = time.perf_counter()
    tiles = sharded_dist.all_vs_all_arrays(qs, rs, mesh=mesh)
    sync()
    tiles_s = time.perf_counter() - t
    undo()
    print(json.dumps({"rank": rank, "sharded_common_s": common_s,
                      "tiles_s": tiles_s}), flush=True)
    if primary:
        t = time.perf_counter()
        want = mxu_dist.all_pairs_common(H, L, device=opts.device)
        one_common_s = time.perf_counter() - t
        common_ok = np.array_equal(common, want)
        del want
        t = time.perf_counter()
        want = sharded_dist.all_vs_all_arrays(qs, rs, device=opts.device)
        one_tiles_s = time.perf_counter() - t
        tiles_ok = all(np.array_equal(g, w) for g, w in zip(tiles, want))
        ok &= common_ok and tiles_ok
        say({"phase": "distance", "sketches": len(H),
             "queries": len(qs), "sharded_common_s": common_s,
             "all_pairs_common_one_card_s": one_common_s,
             "common_equal": common_ok, "tiles_s": tiles_s,
             "tiles_one_card_s": one_tiles_s, "tiles_equal": tiles_ok})
        for row in log:
            say(row)
    tdist.barrier()
    tdist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
