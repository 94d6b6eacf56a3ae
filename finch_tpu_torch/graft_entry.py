"""One-step entry and a multi-shard dry run of the port.

The counterparts of the repository's ``__graft_entry__.py`` (`entry`,
`dryrun_multichip`): `entry` gives one sketch step (hash + bottom-k) and
its arguments; `dryrun_multichip` runs the sharded sketch, merge and
sharded distance over an n-shard mesh on tiny shapes and raises on any
mismatch with the host engines and the unsharded forms.
"""

from __future__ import annotations

import contextlib
import io
import os
import tempfile

import numpy as np
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.engine import composite_planes, resolve_device


def entry(device="cuda"):
    """-> (fn, args): one sketch step on a 1024-capacity state and a
    4096-lane batch of random 21-mers (numpy seed 0), as composite u32
    planes on `device`; fn returns the new state."""
    from finch_tpu_torch.ops import bottomk

    dev = resolve_device(device)
    cap, batch = 1024, 4096
    state = bottomk.empty_state(cap, device=dev)
    rng = np.random.default_rng(0)
    lo, hi = (u64.from_numpy(p, dev) for p in composite_planes(
        rng.integers(0, 4**21, size=batch, dtype=np.uint64),
        rng.integers(0, 2, size=batch, dtype=np.uint64)))

    def step(sh, sc, se, spk, spill, fill, hint, lo, hi, nvalid):
        new_state, _ = bottomk.sketch_step(
            (sh, sc, se, spk, spill, fill, hint), lo, hi, nvalid, 0, k=21,
            seed=0, has_max_hash=False, use_kernel=True)
        return new_state

    return step, (*state, lo, hi, batch)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise FinchMessageError(f"dryrun_multichip: {what}")


def _cli_sketch_bytes(path: str, backend: str, device: str) -> bytes:
    """`finch sketch -N --n-hashes 16 -O path --backend backend`, run in
    this process; its stdout bytes."""
    from finch_tpu_torch import cli

    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8")
    with contextlib.redirect_stdout(out):
        cli.run(["sketch", "-N", "--n-hashes", "16", "-O", path,
                 "--backend", backend, "--device", device])
        out.flush()
    return buf.getvalue()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded path over an n-shard mesh on tiny shapes: sharded mash,
    composite-input and scaled sketches equal the host engine's, the
    CLI's `mesh` bytes equal its `numpy` bytes, the ref-sharded tiles
    equal the unsharded ones and the sharded Gram equals
    all_pairs_common. On the card the shards go to the first n cards,
    taken in turn when fewer are present (logical shards sharing a
    card); with device="cpu" they are n CPU shards. Raises on any
    mismatch."""
    from finch_tpu_torch.core.sketching import sketch_bytes
    from finch_tpu_torch.models.params import FilterParams, SketchParams
    from finch_tpu_torch.native import KmerReader
    from finch_tpu_torch.parallel import (Mesh, ShardedSketchEngine,
                                          all_vs_all_arrays)
    from finch_tpu_torch.parallel.mxu_dist import (all_pairs_common,
                                                   pack_db, sharded_common)

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        mesh = Mesh([torch.device("cuda", i % cards)
                     for i in range(n_devices)])
    else:
        mesh = Mesh([dev] * n_devices)

    # data-parallel sketching of one logical stream, sharded over the mesh
    fa = b">r1\n" + b"ACGTTGCAGTACGTACCGGTTAACGTACGATCGATCCGTACGTAACGT" * 8 \
        + b"\n>r2\n" + b"TTGACGTACCGTTGCAACGGCCTTAAGGCCTTACGATCG" * 7 + b"\n"
    params = SketchParams.mash(kmers_to_sketch=32, final_size=32,
                               no_strict=True, kmer_length=21)
    expected = sketch_bytes(fa, "dryrun", params,
                            FilterParams(filter_on=False), backend="numpy")
    exp = [(k.hash, k.count, k.extra_count) for k in expected.hashes]
    for composite in (False, True):
        eng = ShardedSketchEngine(params, mesh, batch_size_per_device=1024)
        for a, b in KmerReader(fa, k=21, batch_size=4096,
                               composite=composite):
            eng.update(a, b)
        got = [(k.hash, k.count, k.extra_count) for k in eng.finalize()]
        _require(got == exp, f"sharded sketch (composite={composite}) "
                             "diverged from the host engine")

    # the scaled scheme (the grow-and-redo path included)
    sparams = SketchParams.scaled(kmers_to_sketch=8, scale=0.05,
                                  kmer_length=21)
    eng = ShardedSketchEngine(sparams, mesh, batch_size_per_device=1024)
    for a, b in KmerReader(fa, k=21, batch_size=4096):
        eng.update(a, b)
    exp2 = sketch_bytes(fa, "dryrun", sparams, FilterParams(filter_on=False),
                        backend="numpy")
    _require([(k.hash, k.count) for k in eng.finalize()]
             == [(k.hash, k.count) for k in exp2.hashes],
             "sharded scaled sketch diverged from the host engine")

    # the CLI's mesh backend, the user's entry point
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun.fa")
        with open(path, "wb") as f:
            f.write(fa)
        _require(_cli_sketch_bytes(path, "mesh", dev.type)
                 == _cli_sketch_bytes(path, "numpy", dev.type),
                 "CLI mesh sketch != CLI host sketch")

    # ref-sharded distance tiles over the mesh...
    rng = np.random.default_rng(0)
    qs = [np.sort(rng.choice(2**32, size=16, replace=False).astype(np.uint64))
          for _ in range(3)]
    rs = [np.sort(rng.choice(2**32, size=16, replace=False).astype(np.uint64))
          for _ in range(n_devices + 1)]
    got = all_vs_all_arrays(qs, rs, scale=0.0, mesh=mesh)
    want = all_vs_all_arrays(qs, rs, scale=0.0, device=dev)
    _require(got[0].shape == (3, n_devices + 1)
             and all(np.array_equal(g, w) for g, w in zip(got, want)),
             "ref-sharded tiles diverged")

    # ...and the run-partitioned Gram
    db = [np.sort(rng.choice(2**20, size=24, replace=False)
                  .astype(np.uint64)) for _ in range(12)]
    H, L = pack_db(db)
    _require(np.array_equal(sharded_common(H, L, mesh),
                            all_pairs_common(H, L, device=dev)),
             "sharded Gram common diverged")
    print(f"dryrun_multichip({n_devices}) OK on {mesh}: sharded mash, "
          f"composite and scaled sketches exact, CLI mesh path byte-equal, "
          f"dist tiles {got[0].shape}, sharded Gram exact")

