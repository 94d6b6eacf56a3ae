"""finch-compatible CLI for the PyTorch port: sketch / dist / hist / info.

The counterpart of ``finch_tpu/cli.py``. Flag surface, defaults, and
orchestration mirror the reference CLI:
  * option groups + defaults — finch-rs/cli/src/cli.rs:121-215
  * err-filter percentage scaling (err *= k/100, limit 100/k) — cli.rs:241-275
  * mash oversketch rule (kmers_to_sketch = n * oversketch when filtering) —
    cli.rs:277-340
  * subcommand orchestration, sketch-in-place, parse_mash_files param
    inheritance — finch-rs/cli/src/main.rs:48-441

`--backend` takes auto|torch|mesh|native|numpy and `--device` (default
cuda) picks the card or the CPU for the device backends; without a card
they raise unless `--device cpu` is given. `mesh` shards the stream over
every card, one worker process a card (one CPU shard with `--device
cpu`); auto stays on one card. `dist` runs its integer statistics
on that device (parallel/: the Gram engine for --pairwise, the tiles for
query-vs-DB) unless `--backend numpy` asks for the serial host loop.

Run as `python -m finch_tpu_torch.cli sketch|dist|hist|info ...`.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from torch.profiler import record_function

from finch_tpu_torch.core.distance import SketchDistance, distance
from finch_tpu_torch.errors import FinchError
from finch_tpu_torch.core.sketch import Sketch
from finch_tpu_torch.core.sketching import sketch_files
from finch_tpu_torch.core.statistics import cardinality, hist
from finch_tpu_torch.models.engine import resolve_device
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.serialization import (FINCH_BIN_EXT, FINCH_EXT,
                                           MASH_EXT, open_sketch_file)
from finch_tpu_torch.serialization.json_sk import (format_f64,
                                                   multisketch_to_json_bytes)
from finch_tpu_torch.utils.metrics import span


class CliError(FinchError):
    """CLI-layer error; exits with "Error: <msg>" like main.rs:194-199."""


def _add_output_options(p):
    p.add_argument("-o", "--output", dest="output_file", default=None,
                   help="Output to this file")
    p.add_argument("-O", "--std-out", dest="std_out", action="store_true",
                   help="Output to stdout ('print to terminal')")


def _add_filter_options(p):
    p.add_argument("--no-filter", dest="no_filter", action="store_true",
                   help="Disable filtering (default for FASTA)")
    p.add_argument("-f", "--filter", dest="filter", action="store_true",
                   help="Enable filtering (default for FASTQ)")
    p.add_argument("--min-abun-filter", dest="min_abun_filter", default=None,
                   help="Kmers must have at least this coverage to be included")
    p.add_argument("--max-abun-filter", dest="max_abun_filter", default=None,
                   help="Kmers must have a coverage under this to be included")
    p.add_argument("--strand-filter", dest="strand_filter", default=None,
                   help="Filter out kmers with a canonical kmer percentage "
                        "lower than this (adapter filtering) [default: 0.1]")
    p.add_argument("--err-filter", dest="err_filter", default=None,
                   help="The assumed error rate (as a percentage) used to "
                        "dynamically determine the minimum coverage threshold "
                        "[default: 1]")


def _add_sketch_options(p):
    p.add_argument("-s", "--sketch-type", dest="sketch_type", default="mash",
                   choices=["mash", "scaled", "none"],
                   help="What type of sketching to perform [default: mash]")
    p.add_argument("-k", "--kmer-length", dest="kmer_length", default=None,
                   help="Length of kmers to use [default: 21; 4 for "
                        "sketch-type none]")
    p.add_argument("-n", "--n-hashes", dest="n_hashes", default=None,
                   help="How many kmers/hashes to store [default: 1000]")
    p.add_argument("--scale", dest="scale", default=None,
                   help="Sketch scaling factor [default: 0.001]")
    p.add_argument("--seed", dest="seed", default=None,
                   help="Seed murmurhash with this value [default: 0]")
    p.add_argument("--oversketch", dest="oversketch", default=None,
                   help="The amount of extra sketching to do before filtering "
                        "[default: 200]")
    p.add_argument("-N", "--no-strict", dest="no_strict", action="store_true",
                   help="Allow sketching files with fewer kmers than n_hashes")
    p.add_argument("--backend", dest="backend", default="auto",
                   choices=["auto", "torch", "mesh", "native", "numpy"],
                   help="Compute backend (auto: the host fold for small "
                        "inputs, migrating to the device for large ones at "
                        "k <= 63, on one card; mesh: every card, one "
                        "worker process a card, at k <= 31)")
    p.add_argument("--device", dest="device", default="cuda",
                   help="torch device of the device backends: cuda "
                        "(default) or cpu")


def build_cli() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="finch",
        description="Tool for working with genomic MinHash sketches "
                    "(PyTorch/CUDA finch)")
    from finch_tpu_torch import __version__

    ap.add_argument("--version", action="version",
                    version=f"%(prog)s {__version__}")
    sub = ap.add_subparsers(dest="subcommand")

    sp = sub.add_parser("sketch", help="Create sketches from FASTA/Q file(s)")
    sp.add_argument("INPUT", nargs="+", help="The file(s) to sketch")
    sp.add_argument("-b", "--finch-binary-format", dest="binary_format",
                    action="store_true",
                    help="Outputs sketch to a finch-native binary format")
    sp.add_argument("-B", "--mash-binary-format", dest="mash_binary_format",
                    action="store_true",
                    help="Outputs sketch in a binary format compatible with "
                         "`mash`")
    _add_output_options(sp)
    _add_filter_options(sp)
    _add_sketch_options(sp)

    dp = sub.add_parser("dist", help="Compute distances between sketches")
    dp.add_argument("INPUT", nargs="+",
                    help="Sketchfile(s) to make comparisons for")
    dp.add_argument("-p", "--pairwise", action="store_true",
                    help="Calculate distances between all sketches")
    dp.add_argument("-q", "--queries", nargs="+", default=None,
                    help="All distances are from these sketches (sketches "
                         "must be in the first file)")
    dp.add_argument("-d", "--max-dist", dest="max_distance", default="1.0",
                    help="Only report distances under this threshold "
                         "[default: 1.0]")
    dp.add_argument("--old-dist", dest="old_dist_mode", action="store_true",
                    help="Calculate distances using the old "
                         "containment-biased Finch mode")
    _add_output_options(dp)
    _add_filter_options(dp)
    _add_sketch_options(dp)

    hp = sub.add_parser("hist", help="Display histograms of kmer abundances")
    hp.add_argument("INPUT", nargs="+",
                    help="Generate histograms from these file(s)")
    _add_output_options(hp)
    _add_filter_options(hp)
    _add_sketch_options(hp)

    ip = sub.add_parser("info", help="Display basic statistics")
    ip.add_argument("INPUT", nargs="+", help="Return stats on these file(s)")
    _add_filter_options(ip)
    _add_sketch_options(ip)
    return ap


# ---------------------------------------------------------------------------
# argument parsing helpers with clap-like occurrence semantics
# ---------------------------------------------------------------------------

def _get_int(args, key: str, default: int) -> int:
    raw = getattr(args, key)
    val = raw if raw is not None else str(default)
    try:
        v = int(val)
        if v < 0:
            raise ValueError
        return v
    except ValueError:
        raise CliError(f"{key.replace('_', '-')} must be a positive integer")


def _get_float(args, key: str, limit: float, default) -> float:
    raw = getattr(args, key)
    val = raw if raw is not None else str(default)
    try:
        r = float(val)
    except ValueError:
        raise CliError(f"{key.replace('_', '-')} must be a number")
    if not (0.0 <= r <= limit):
        raise CliError(
            f"{key.replace('_', '-')} must be between 0 and "
            f"{format_f64(limit)}")
    return r


def _occurred(args, key: str) -> bool:
    return getattr(args, key) is not None


def get_kmer_length(args) -> int:
    """default 21, or 4 when sketch-type none (cli.rs:161-167). The
    reference parses k as u8 (main.rs:207,257), so > 255 fails the same
    way a non-integer does."""
    if args.kmer_length is not None:
        v = _get_int(args, "kmer_length", 21)
        if v > 255:
            raise CliError("kmer-length must be a positive integer")
        return v
    return 4 if args.sketch_type == "none" else 21


def parse_filter_options(args, kmer_length: int) -> FilterParams:
    """cli.rs:241-275."""
    if args.filter and args.no_filter:
        raise CliError("Can't have both filtering and no filtering!")
    filter_on = True if args.filter else (False if args.no_filter else None)

    min_abun = (_get_int(args, "min_abun_filter", 0)
                if _occurred(args, "min_abun_filter") else None)
    max_abun = (_get_int(args, "max_abun_filter", 0)
                if _occurred(args, "max_abun_filter") else None)

    err_filter = _get_float(args, "err_filter", 100.0 / kmer_length, 1)
    err_filter *= kmer_length / 100.0
    strand_filter = _get_float(args, "strand_filter", 1.0, 0.1)

    return FilterParams(
        filter_on=filter_on,
        abun_filter=(min_abun, max_abun),
        err_filter=err_filter,
        strand_filter=strand_filter,
    )


def parse_sketch_options(args, kmer_length: int,
                         filters_enabled: Optional[bool]) -> SketchParams:
    """cli.rs:277-340 (incl. per-type flag conflict checks)."""
    st = args.sketch_type
    if st == "mash":
        if _occurred(args, "scale"):
            raise CliError("`scale` can not be specified for `mash` sketch types")
        final_size = _get_int(args, "n_hashes", 1000)
        oversketch = _get_int(args, "oversketch", 200)
        sketch_size = final_size * oversketch
        kmers_to_sketch = (sketch_size if filters_enabled in (True, None)
                           else final_size)
        return SketchParams.mash(
            kmers_to_sketch=kmers_to_sketch,
            final_size=final_size,
            no_strict=bool(args.no_strict),
            kmer_length=kmer_length,
            hash_seed=_get_int(args, "seed", 0),
        )
    if st == "scaled":
        if _occurred(args, "oversketch"):
            raise CliError(
                "`oversketch` can not be specified for `scaled` sketch types")
        if args.no_strict:
            raise CliError(
                "`no_strict` can not be specified for `scaled` sketch types")
        return SketchParams.scaled(
            kmers_to_sketch=_get_int(args, "n_hashes", 1000),
            kmer_length=kmer_length,
            scale=_get_float(args, "scale", 1.0, 0.001),
            hash_seed=_get_int(args, "seed", 0),
        )
    if st == "none":
        for key, label in (("n_hashes", "n_hashes"), ("seed", "seed"),
                           ("oversketch", "oversketch"), ("scale", "scale")):
            if _occurred(args, key):
                raise CliError(
                    f"`{label}` can not be specified for `none` sketch types")
        if args.no_strict:
            raise CliError(
                "`no_strict` can not be specified for `none` sketch types")
        return SketchParams.all_counts(kmer_length=kmer_length)
    raise CliError("A unknown sketch type was selected")


def update_sketch_params(args, sketch_params: SketchParams, sketch: Sketch,
                         name: str) -> SketchParams:
    """Inherit unset CLI args from the first sketch file (main.rs:336-441)."""
    new = sketch.sketch_params
    if sketch_params.sketch_type != new.sketch_type:
        raise CliError("Sketch types are not the same")

    updates = {}
    if sketch_params.sketch_type == "mash":
        if not _occurred(args, "n_hashes"):
            updates["final_size"] = new.expected_size()
        if not _occurred(args, "kmer_length"):
            updates["kmer_length"] = new.k
        elif sketch_params.k != new.k:
            raise CliError(
                f"Specified kmer length {sketch_params.k} does not match "
                f"{new.k} from sketch {name}")
        if not _occurred(args, "seed"):
            updates["hash_seed"] = new.hash_info()[2]
        elif sketch_params.hash_seed != new.hash_info()[2]:
            raise CliError(
                f"Specified hash seed {sketch_params.hash_seed} does not "
                f"match {new.hash_info()[2]} from sketch {name}")
    elif sketch_params.sketch_type == "scaled":
        if not _occurred(args, "kmer_length"):
            updates["kmer_length"] = new.k
        elif sketch_params.k != new.k:
            raise CliError(
                f"Specified kmer length {sketch_params.k} does not match "
                f"{new.k} from sketch {name}")
        if not _occurred(args, "seed"):
            updates["hash_seed"] = new.hash_info()[2]
        elif sketch_params.hash_seed != new.hash_info()[2]:
            raise CliError(
                f"Specified hash seed {sketch_params.hash_seed} does not "
                f"match {new.hash_info()[2]} from sketch {name}")
        new_scale = new.hash_info()[3]
        if new_scale is not None:
            if not _occurred(args, "scale"):
                updates["scale"] = new_scale
            elif abs(sketch_params.scale - new_scale) < 2.220446049250313e-16:
                # NOTE: faithful to a reference quirk — main.rs:416-424 bails
                # when the specified scale MATCHES the sketch's scale (the
                # comparison is inverted in the reference).
                raise CliError(
                    f"Specified scale {sketch_params.scale} does not match "
                    f"{new_scale} from sketch {name}")
    else:  # none
        if not _occurred(args, "kmer_length"):
            updates["kmer_length"] = new.k
        elif sketch_params.k != new.k:
            raise CliError(
                f"Specified kmer length {sketch_params.k} does not match "
                f"{new.k} from sketch {name}")
    return sketch_params.replace(**updates) if updates else sketch_params


SKETCH_EXTS = (".json", FINCH_EXT, FINCH_BIN_EXT, MASH_EXT)


def parse_mash_files(args) -> List[Sketch]:
    """Split inputs into sketch vs sequence files; harmonize params
    (main.rs:237-313)."""
    sketch_filenames = [f for f in args.INPUT if f.endswith(SKETCH_EXTS)]
    seq_filenames = [f for f in args.INPUT if not f.endswith(SKETCH_EXTS)]

    kmer_length = get_kmer_length(args)
    filters = parse_filter_options(args, kmer_length)
    sketch_params = parse_sketch_options(args, kmer_length, filters.filter_on)

    if not sketch_filenames:
        return sketch_files(seq_filenames, sketch_params, filters,
                            backend=args.backend, device=args.device)

    first, rest = sketch_filenames[0], sketch_filenames[1:]
    sketches = open_sketch_file(first)
    sketch_params = update_sketch_params(args, sketch_params, sketches[0],
                                         first)
    # err_filter scales with k, so re-derive filters if k was inherited
    if not _occurred(args, "kmer_length"):
        filters = parse_filter_options(args, sketch_params.k)

    if filters.filter_on is True:
        for sketch in sketches:
            filters.filter_sketch(sketch)

    for filename in rest:
        extra = open_sketch_file(filename)
        for sketch in extra:
            mism = sketch_params.check_compatibility(sketch.sketch_params)
            if mism is not None:
                pname, v1, v2 = mism
                raise CliError(
                    f"Sketch {sketch.name} has {pname} {v2}, but working "
                    f"value is {v1}")
        sketches.extend(extra)
        if filters.filter_on is True:
            # faithful quirk: the reference refilters the whole accumulated
            # list after each extra file (main.rs:296-301)
            for sketch in sketches:
                filters.filter_sketch(sketch)

    sketches.extend(sketch_files(seq_filenames, sketch_params, filters,
                                 backend=args.backend, device=args.device))
    return sketches


def calc_sketch_distances(query_sketches, ref_sketches, old_mode: bool,
                          max_distance: float,
                          use_device: bool = True, device="cuda"
                          ) -> Sequence[SketchDistance]:
    """main.rs:315-334 (skips query==ref by full struct equality).

    When use_device (the user did not force --backend numpy), large
    workloads batch the integer stats through the engines of parallel/ on
    `device` ("cuda" unless the caller passes "cpu"; without a card they
    raise) and apply the same f64 formula on host; output order and
    values match the serial loop. Small workloads (under 4096 pairs) take
    the serial loop, as in the JAX package.
    """
    npairs = len(query_sketches) * len(ref_sketches)
    if (not old_mode and npairs >= 4096 and use_device
            and _uniform_dist_params(query_sketches, ref_sketches)):
        return _calc_distances_batched(query_sketches, ref_sketches,
                                       max_distance, device=device)
    distances = []
    for ref_sketch in ref_sketches:
        for query_sketch in query_sketches:
            if query_sketch == ref_sketch:
                continue
            d = distance(query_sketch, ref_sketch, old_mode)
            if d.mash_distance <= max_distance:
                distances.append(d)
    return distances


def _uniform_dist_params(queries, refs) -> bool:
    infos = {s.sketch_params.hash_info() for s in queries}
    infos |= {s.sketch_params.hash_info() for s in refs}
    ks = {s.sketch_params.k for s in queries}
    if len(infos) != 1 or len(ks) != 1:
        return False
    # the device engine uses u64::MAX as its pad sentinel; a (vanishingly
    # rare) genuine hash there must take the serial path for exactness
    u64_max = 0xFFFFFFFFFFFFFFFF
    # hash_array (not hashes[-1]) so lazily-loaded DBs stay unmaterialized
    return all(int(s.hash_array()[-1]) != u64_max
               for s in (*queries, *refs) if len(s.hashes))


def _calc_distances_batched(queries, refs, max_distance: float,
                            device="cuda") -> Sequence[SketchDistance]:
    from finch_tpu_torch.parallel import all_vs_all_arrays

    scale = queries[0].sketch_params.hash_info()[3]
    scale = scale if scale is not None else 0.0
    k = float(queries[0].sketch_params.k)

    if (queries is refs or (len(queries) == len(refs)
                            and all(a is b for a, b in zip(queries, refs)))) \
            and len(refs) <= 32768:
        # pairwise all-vs-all: one global sort + Gram products on the
        # card (parallel/mxu_dist.py) instead of N^2 pair merges. Beyond
        # ~32k sketches the three (N, N) stat matrices outgrow host
        # memory, so the ref-chunked tile engine below takes over.
        return _calc_distances_gram(refs, scale, k, max_distance,
                                    device=device)

    import numpy as np

    qh = [q.hash_array() for q in queries]
    qnames = [q.name for q in queries]
    rnames = [r.name for r in refs]
    qname_ix = {}
    for i, nm in enumerate(qnames):
        qname_ix.setdefault(nm, []).append(i)
    parts = []
    # chunk the ref axis so peak memory stays bounded (three (Q, chunk)
    # uint64 stat matrices) regardless of DB size; ref-major chunk order
    # preserves the serial loop's output order. The f64 math and the
    # max-dist cut run vectorized per chunk (distance_from_stats per pair
    # would cost minutes at DB scale).
    chunk = max(1, (1 << 22) // max(1, len(queries)))
    for r0 in range(0, len(refs), chunk):
        rchunk = refs[r0:r0 + chunk]
        common, istat, jstat = (np.asarray(m) for m in all_vs_all_arrays(
            qh, [r.hash_array() for r in rchunk], scale=scale,
            device=device))
        keep = np.ones(common.shape, dtype=bool)
        # struct-equality self-skip (main.rs:322): probe name-equal pairs
        for jr_l, ref_sketch in enumerate(rchunk):
            for iq in qname_ix.get(ref_sketch.name, ()):
                if queries[iq] == ref_sketch:
                    keep[iq, jr_l] = False
        # ref-major, query-minor within the chunk; gather the candidate
        # stats first, THEN widen to int64 (no full-matrix copies)
        jr_l, iq_arr = np.nonzero(keep.T)
        containment, jaccard, mash, cc, total, exact = _exact_rows(
            common[iq_arr, jr_l].astype(np.int64),
            istat[iq_arr, jr_l].astype(np.int64),
            jstat[iq_arr, jr_l].astype(np.int64), k, max_distance)
        parts.append((containment, jaccard, mash, cc, total,
                      iq_arr[exact], jr_l[exact] + r0))
    if not parts:
        z = np.empty(0)
        zi = np.empty(0, dtype=np.int64)
        return _GramDistanceRows(z, z, z, zi, zi, zi, zi, qnames,
                                 ref_names=rnames)
    cols = [np.concatenate(c) for c in zip(*parts)]
    return _GramDistanceRows(*cols, names=qnames, ref_names=rnames)


def _calc_distances_gram(sketches, scale: float, k: float,
                         max_distance: float,
                         device="cuda") -> "_GramDistanceRows":
    """All-vs-all via the Gram-matrix engine; output order matches the
    serial ref-major/query-minor loop (main.rs:315-334).

    The mash <= max_distance cut is monotone in jaccard, so candidate
    pairs are selected with a single conservative f32 compare over the
    integer stat matrices (common >= total * j_min, widened by a margin)
    and the exact f64 formulas run only on the gathered candidates — no
    (N, N) f64 temporaries and no per-pair Python until emission, which
    stays lazy (`_GramDistanceRows`) so the CLI can serialize straight
    from the arrays."""
    import numpy as np

    from finch_tpu_torch.parallel.mxu_dist import (all_pairs_stats,
                                                   all_pairs_survivors,
                                                   candidate_mask_consts,
                                                   pack_db)

    H, L = pack_db([s.hash_array() for s in sketches])
    n = len(sketches)
    names = [s.name for s in sketches]

    # survivor compaction on the card: only candidate pairs cross to
    # the host (None -> out of contract, take the full-matrix path)
    surv = all_pairs_survivors(H, L, scale, k, max_distance,
                               device=device)
    if surv is not None:
        iq_arr, jr_arr, cc, ii, jj = surv
        # struct-equality self-skip like main.rs:322 on the
        # candidates: vectorized name-equality probe, then struct
        # compare only the (rare) probe hits
        if len(set(names)) != n and len(iq_arr):
            uniq = {nm: ix for ix, nm in enumerate(dict.fromkeys(names))}
            ids = np.array([uniq[nm] for nm in names], dtype=np.int64)
            probe = np.flatnonzero(ids[iq_arr] == ids[jr_arr])
            dup_ix = [int(x) for x in probe
                      if sketches[int(iq_arr[x])]
                      == sketches[int(jr_arr[x])]]
            if dup_ix:
                keep_c = np.ones(len(iq_arr), dtype=bool)
                keep_c[dup_ix] = False
                iq_arr, jr_arr = iq_arr[keep_c], jr_arr[keep_c]
                cc, ii, jj = cc[keep_c], ii[keep_c], jj[keep_c]
        return _finish_gram_rows(cc, ii, jj, iq_arr, jr_arr, names, k,
                                 max_distance)

    common, i_m, j_m = all_pairs_stats(H, L, scale=scale, device=device)

    if max_distance >= 1.0:
        # every pair passes the clamp (mash = min(1, ...) <= 1)
        keep = np.ones((n, n), dtype=bool)
    else:
        # conservative candidate test (shared constants with the device
        # survivors path): no exact survivor is ever dropped in f32;
        # false positives are removed by the exact f64 recheck below.
        # jaccard == 0 pairs have mash = 1 > d and fall out naturally;
        # total == 0 (both empty) means mash = 0 and 0 >= -eps keeps it.
        j_min_lo, eps = candidate_mask_consts(k, max_distance)
        total32 = (i_m - common + j_m).astype(np.int32)
        keep = (common.astype(np.float32)
                >= total32.astype(np.float32) * j_min_lo - eps)
        del total32
    np.fill_diagonal(keep, False)
    # struct-equality self-skip like main.rs:322 (duplicate sketches at
    # different indices are skipped too) — only probe name-equal pairs
    by_name = {}
    for ix, nm in enumerate(names):
        by_name.setdefault(nm, []).append(ix)
    for ixs in by_name.values():
        for a in ixs:
            for b in ixs:
                if a != b and keep[a, b] and sketches[a] == sketches[b]:
                    keep[a, b] = False

    # ref-major, query-minor order (row-major walk of keep.T)
    jr_arr, iq_arr = np.nonzero(keep.T)
    return _finish_gram_rows(
        common[iq_arr, jr_arr], i_m[iq_arr, jr_arr], j_m[iq_arr, jr_arr],
        iq_arr, jr_arr, names, k, max_distance)


def _exact_rows(cc, ii, jj, k: float, max_distance: float):
    """Exact f64 raw_distance math + final mash cut on gathered candidate
    integer stats (same formulas as core/distance.py, vectorized).
    Returns (containment, jaccard, mash, common, total, keep_mask)."""
    import numpy as np

    with record_function("dist.recheck"):
        total = ii - cc + jj
        c64 = cc.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            containment = np.where(jj == 0, 0.0,
                                   c64 / jj.astype(np.float64))
            jaccard = np.where(total == 0, 1.0,
                               c64 / np.maximum(total, 1).astype(np.float64))
            mash = np.where(
                jaccard == 0.0, np.inf,
                -1.0 * np.log((2.0 * jaccard) / (1.0 + jaccard)) / k)
        mash = np.minimum(1.0, np.maximum(0.0, mash))
        exact = mash <= max_distance
        return (containment[exact], jaccard[exact], mash[exact], cc[exact],
                total[exact], exact)


def _finish_gram_rows(cc, ii, jj, iq_arr, jr_arr, names, k: float,
                      max_distance: float) -> "_GramDistanceRows":
    containment, jaccard, mash, common, total, exact = _exact_rows(
        cc, ii, jj, k, max_distance)
    return _GramDistanceRows(
        containment=containment, jaccard=jaccard, mash=mash,
        common=common, total=total,
        iq=iq_arr[exact], jr=jr_arr[exact], names=names)


class _GramDistanceRows:
    """Sequence of SketchDistance rows backed by the Gram engine's
    candidate arrays. Iteration/indexing materialize SketchDistance
    objects (library compatibility); `to_json_bytes` serializes straight
    from the arrays, formatting each distinct (common, i-side, total)
    stat triple once — on a clustered 10k-sketch DB that is thousands of
    `format_f64` calls instead of millions."""

    def __init__(self, containment, jaccard, mash, common, total, iq, jr,
                 names, ref_names=None):
        self._containment = containment
        self._jaccard = jaccard
        self._mash = mash
        self._common = common
        self._total = total
        self._iq = iq
        self._jr = jr
        self._names = names            # query names, indexed by iq
        self._rnames = (ref_names if ref_names is not None
                        else names)    # ref names, indexed by jr

    def __len__(self) -> int:
        return len(self._common)

    def _row(self, ix: int) -> SketchDistance:
        return SketchDistance(
            containment=float(self._containment[ix]),
            jaccard=float(self._jaccard[ix]),
            mash_distance=float(self._mash[ix]),
            common_hashes=int(self._common[ix]),
            total_hashes=int(self._total[ix]),
            query=self._names[self._iq[ix]],
            reference=self._rnames[self._jr[ix]],
        )

    def __getitem__(self, ix):
        if isinstance(ix, slice):
            return [self._row(i) for i in range(*ix.indices(len(self)))]
        return self._row(ix)

    def __iter__(self):
        return (self._row(i) for i in range(len(self)))

    def _row_strings(self, s0: int, s1: int, qname_json, rname_json):
        """Serialized rows [s0, s1): one format_f64 per distinct
        (common, total, containment) stat triple — the three floats are
        functions of those integers plus the containment bits."""
        import numpy as np

        m = s1 - s0
        trip = np.empty((m, 3), dtype=np.int64)
        trip[:, 0] = self._common[s0:s1]
        trip[:, 1] = self._total[s0:s1]
        trip[:, 2] = self._containment[s0:s1].view(np.int64)
        uniq, inv = np.unique(trip, axis=0, return_inverse=True)
        first = np.zeros(len(uniq), dtype=np.int64)
        first[inv[::-1]] = np.arange(m - 1, -1, -1)
        segs = []
        for u in range(len(uniq)):
            ix = s0 + int(first[u])
            segs.append(
                '{"containment":' + format_f64(float(self._containment[ix]))
                + ',"jaccard":' + format_f64(float(self._jaccard[ix]))
                + ',"mashDistance":' + format_f64(float(self._mash[ix]))
                + ',"commonHashes":' + str(int(self._common[ix]))
                + ',"totalHashes":' + str(int(self._total[ix]))
                + ',"query":')
        iq = self._iq[s0:s1]
        jr = self._jr[s0:s1]
        return [segs[t] + qname_json[iq[r]] + ',"reference":'
                + rname_json[jr[r]] + "}"
                for r, t in enumerate(inv)]

    def _name_tables(self):
        import json as _json

        qname_json = [_json.dumps(nm, ensure_ascii=False,
                                  separators=(",", ":"))
                      for nm in self._names]
        rname_json = (qname_json if self._rnames is self._names else
                      [_json.dumps(nm, ensure_ascii=False,
                                   separators=(",", ":"))
                       for nm in self._rnames])
        return qname_json, rname_json

    def write_json_to(self, w, chunk: int = 1 << 18) -> None:
        """Stream the serde-compatible JSON array in bounded-memory
        chunks (the reference's serde_json::to_writer also streams —
        a max-dist 1.0 run over a big DB emits O(N^2) rows)."""
        qn, rn = self._name_tables()
        w.write(b"[")
        for s0 in range(0, len(self), chunk):
            s1 = min(s0 + chunk, len(self))
            payload = ",".join(self._row_strings(s0, s1, qn, rn))
            if s0:
                w.write(b",")
            w.write(payload.encode("utf-8"))
        w.write(b"]")

    def to_json_bytes(self) -> bytes:
        import io

        buf = io.BytesIO()
        self.write_json_to(buf)
        return buf.getvalue()



def output_to(write_fn, output: Optional[str], extension: str) -> None:
    """stdout or file, appending the extension if missing (main.rs:21-46)."""
    if output is None:
        write_fn(sys.stdout.buffer)
        sys.stdout.buffer.flush()
    else:
        out_filename = output if output.endswith(extension) else (
            output + extension)
        try:
            f = open(out_filename, "wb")
        except OSError:
            raise CliError(f"unable to create '{out_filename}'")
        with f:
            write_fn(f)


def _write_dist_json(w, distances) -> None:
    """Stream Vec<SketchDistance> JSON: Gram-engine results serialize
    straight from their arrays in bounded-memory chunks."""
    if isinstance(distances, _GramDistanceRows):
        distances.write_json_to(w)
    else:
        w.write(_dist_json_bytes(distances))


def _dist_json_bytes(distances) -> bytes:
    """serde_json-compatible compact JSON for Vec<SketchDistance>
    (mod.rs:31-43 field names/order)."""
    import json as _json

    if isinstance(distances, _GramDistanceRows):
        return distances.to_json_bytes()
    parts = []
    for d in distances:
        obj = (
            '{"containment":' + format_f64(d.containment)
            + ',"jaccard":' + format_f64(d.jaccard)
            + ',"mashDistance":' + format_f64(d.mash_distance)
            + ',"commonHashes":' + str(d.common_hashes)
            + ',"totalHashes":' + str(d.total_hashes)
            + ',"query":' + _json.dumps(d.query, ensure_ascii=False,
                                        separators=(",", ":"))
            + ',"reference":' + _json.dumps(d.reference, ensure_ascii=False,
                                            separators=(",", ":"))
            + "}")
        parts.append(obj)
    return ("[" + ",".join(parts) + "]").encode("utf-8")



def generate_sketch_files(args, file_ext: str) -> None:
    """Sketch-in-place: write <input><ext> next to each input
    (main.rs:201-235)."""
    kmer_length = get_kmer_length(args)
    filters = parse_filter_options(args, kmer_length)
    sketch_params = parse_sketch_options(args, kmer_length, filters.filter_on)

    for filename in args.INPUT:
        if filename.endswith(SKETCH_EXTS):
            raise CliError(f"Filename {filename} is not a sequence file?")
        sketches = sketch_files([filename], sketch_params, filters,
                                backend=args.backend, device=args.device)
        out_filename = filename + file_ext
        with span("cli.write_sk") as s:
            try:
                out = open(out_filename, "wb")
            except OSError:
                raise CliError(f"Could not open {out_filename}")
            with out:
                s.items = _write_sketches(out, sketches, args)


def _write_sketches(writer, sketches, args) -> int:
    """Write the sketches in the format `args` asks for; returns the
    bytes written."""
    if getattr(args, "binary_format", False):
        from finch_tpu_torch.serialization.finch_bsk import write_finch_file
        data = write_finch_file(sketches)
    elif getattr(args, "mash_binary_format", False):
        from finch_tpu_torch.serialization.mash_msh import write_mash_file
        data = write_mash_file(sketches)
    else:
        data = multisketch_to_json_bytes(sketches)
    writer.write(data)
    return len(data)


def run(argv=None) -> None:
    args = build_cli().parse_args(argv)
    if args.subcommand is None:
        build_cli().print_help()
        raise SystemExit(2)

    # clap declares -O conflicts_with -o (cli.rs:213); argparse has no
    # native conflict groups, so enforce it here
    if getattr(args, "std_out", False) and getattr(args, "output_file",
                                                   None):
        raise CliError(
            "The argument '--std-out' cannot be used with '--output'")

    if args.subcommand == "sketch":
        if args.binary_format and args.mash_binary_format:
            raise CliError("Can't output both binary formats")
        file_ext = (FINCH_BIN_EXT if args.binary_format
                    else MASH_EXT if args.mash_binary_format
                    else FINCH_EXT)
        if args.output_file or args.std_out:
            sketches = parse_mash_files(args)
            with span("cli.write_sk") as s:
                def write(w):
                    s.items = _write_sketches(w, sketches, args)

                output_to(write, args.output_file, file_ext)
        else:
            generate_sketch_files(args, file_ext)

    elif args.subcommand == "dist":
        # clap declares pairwise/queries mutually conflicting
        # (cli.rs:71-85), so the reference binary rejects the combination
        # before main.rs:92-107's pairwise-first branch can ever run
        if args.pairwise and args.queries:
            raise CliError(
                "The argument '--pairwise' cannot be used with '--queries'")
        max_dist = _get_float(args, "max_distance", 1.0, 1.0)
        # the device engines' card is checked before any work, whatever
        # route the workload's size later takes
        use_device = args.backend != "numpy"
        if use_device:
            resolve_device(args.device)
        all_sketches = parse_mash_files(args)
        if args.pairwise:
            query_sketches = list(all_sketches)
        elif args.queries:
            names = set(args.queries)
            query_sketches = [s for s in all_sketches if s.name in names]
        else:
            if not all_sketches:
                raise CliError("No sketches present!")
            query_sketches = [all_sketches[0]]
        distances = calc_sketch_distances(
            query_sketches, all_sketches, args.old_dist_mode, max_dist,
            use_device=use_device, device=args.device)
        output_to(lambda w: _write_dist_json(w, distances),
                  args.output_file, ".json")

    elif args.subcommand == "hist":
        import json as _json

        sketches = parse_mash_files(args)
        # count_array serves lazily-loaded DBs without materializing
        # KmerCount objects (same bincount result as the KmerCount path)
        hist_map = {s.name: hist(s.count_array()) for s in sketches}
        payload = _json.dumps(hist_map, ensure_ascii=False,
                              separators=(",", ":")).encode("utf-8")
        output_to(lambda w: w.write(payload), args.output_file, ".json")

    elif args.subcommand == "info":
        import numpy as np

        sketches = parse_mash_files(args)
        for sketch in sketches:
            # text format faithful to main.rs:146-187, computed from the
            # SoA views so DB-scale info never builds KmerCount objects or
            # loops per kmer byte in Python
            sys.stdout.write(f"{sketch.name}")
            sys.stdout.write(f" (from {sketch.seq_length}bp)\n")
            counts = sketch.count_array()
            hash_arr = sketch.hash_array()
            c = cardinality(hash_arr)
            sys.stdout.write(f"  Estimated # of Unique Kmers: {c}\n")
            histogram = np.asarray(hist(counts), dtype=np.int64)
            # the reference folds (i+1)*v and v serially in f32
            # (main.rs:159-164); adding a 0f32 term never changes a
            # non-negative accumulator, so folding only the nonzero
            # entries reproduces it bit-for-bit in O(distinct depths)
            num = np.float32(0)
            den = np.float32(0)
            for i in np.nonzero(histogram)[0]:
                v = histogram[i]
                num += np.float32(np.float32(i + 1) * np.float32(v))
                den += np.float32(v)
            mean = (np.float32(num / den) if len(histogram)
                    else np.float32("nan"))
            sys.stdout.write(
                f"  Estimated Average Depth: {_fmt_f32(mean)}x\n")
            kmer_bytes = sketch.kmer_list()
            klen = len(kmer_bytes[0]) if kmer_bytes else 0
            if kmer_bytes and all(len(km) == klen for km in kmer_bytes):
                # u64 math with wraparound, like the reference's release
                # build (total_gc: u64, main.rs:166-176)
                arr = np.frombuffer(b"".join(kmer_bytes),
                                    dtype=np.uint8).reshape(len(kmer_bytes),
                                                            klen)
                is_gc = ((arr == ord("G")) | (arr == ord("g"))
                         | (arr == ord("C")) | (arr == ord("c")))
                per_kmer = is_gc.sum(axis=1, dtype=np.uint64)
                with np.errstate(over="ignore"):
                    total_gc = int((per_kmer
                                    * counts.astype(np.uint64)).sum(
                                        dtype=np.uint64))
            else:  # ragged kmers (malformed input): faithful slow path
                total_gc = 0
                for km, cnt in zip(kmer_bytes, counts.tolist()):
                    total_gc += sum(cnt if b in b"GgCc" else 0 for b in km)
            if not len(counts):
                total_bases = np.float32(0)
            else:
                total_bases = np.float32(num * np.float32(klen))
            pct = np.float32(np.float32(100) * np.float32(total_gc)
                             / total_bases)
            sys.stdout.write(f"  Estimated % GC: {_fmt_f32(pct)}%\n")


def _fmt_f32(x) -> str:
    """Rust f32 Display (shortest round-trip; 'NaN'/'inf')."""
    import numpy as np

    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "inf" if x > 0 else "-inf"
    return np.format_float_positional(np.float32(x), unique=True, trim="-")



def main() -> None:
    try:
        run()
    except (FinchError, ValueError) as err:
        sys.stderr.write(f"Error: {err}\n")
        raise SystemExit(1)
    except BrokenPipeError:
        raise SystemExit(0)


if __name__ == "__main__":
    main()
