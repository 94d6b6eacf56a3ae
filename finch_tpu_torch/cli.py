"""finch-compatible CLI for the PyTorch port: the `sketch` subcommand.

The counterpart of ``finch_tpu/cli.py``. Flag surface, defaults, and
orchestration mirror the reference CLI:
  * option groups + defaults — finch-rs/cli/src/cli.rs:121-215
  * err-filter percentage scaling (err *= k/100, limit 100/k) — cli.rs:241-275
  * mash oversketch rule (kmers_to_sketch = n * oversketch when filtering) —
    cli.rs:277-340
  * sketch-in-place and parse_mash_files param inheritance —
    finch-rs/cli/src/main.rs:48-441

`--backend` takes auto|torch|native|numpy and `--device` (default cuda)
picks the card or the CPU for the device backends; without a card they
raise unless `--device cpu` is given. `dist`, `hist` and `info` are not
ported yet (use finch_tpu_torch.cli).

Run as `python -m finch_tpu_torch.cli sketch ...`.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from finch_tpu_torch.errors import FinchError
from finch_tpu_torch.core.sketch import Sketch
from finch_tpu_torch.core.sketching import sketch_files
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.serialization import (FINCH_BIN_EXT, FINCH_EXT,
                                           MASH_EXT, open_sketch_file)
from finch_tpu_torch.serialization.json_sk import (format_f64,
                                                   multisketch_to_json_bytes)


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
                   choices=["auto", "torch", "native", "numpy"],
                   help="Compute backend (auto: the host fold for small "
                        "inputs, migrating to the device for large ones)")
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
        try:
            out = open(out_filename, "wb")
        except OSError:
            raise CliError(f"Could not open {out_filename}")
        with out:
            _write_sketches(out, sketches, args)


def _write_sketches(writer, sketches, args) -> None:
    if getattr(args, "binary_format", False):
        from finch_tpu_torch.serialization.finch_bsk import write_finch_file
        writer.write(write_finch_file(sketches))
    elif getattr(args, "mash_binary_format", False):
        from finch_tpu_torch.serialization.mash_msh import write_mash_file
        writer.write(write_mash_file(sketches))
    else:
        writer.write(multisketch_to_json_bytes(sketches))


def run(argv=None) -> None:
    args = build_cli().parse_args(argv)
    if args.subcommand is None:
        build_cli().print_help()
        raise SystemExit(2)

    # clap declares -O conflicts_with -o (cli.rs:213); argparse has no
    # native conflict groups, so enforce it here
    if args.std_out and args.output_file:
        raise CliError(
            "The argument '--std-out' cannot be used with '--output'")

    if args.binary_format and args.mash_binary_format:
        raise CliError("Can't output both binary formats")
    file_ext = (FINCH_BIN_EXT if args.binary_format
                else MASH_EXT if args.mash_binary_format
                else FINCH_EXT)
    if args.output_file or args.std_out:
        sketches = parse_mash_files(args)
        output_to(lambda w: _write_sketches(w, sketches, args),
                  args.output_file, file_ext)
    else:
        generate_sketch_files(args, file_ext)


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
