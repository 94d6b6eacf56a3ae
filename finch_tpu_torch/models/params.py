"""Sketch + filter parameter algebra.

Behavioral contract from the reference:
  * SketchParams enum           — finch-rs/lib/src/sketch_schemes/mod.rs:53-212
  * FilterParams + pipeline     — finch-rs/lib/src/filtering.rs:11-145
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from finch_tpu_torch.errors import FinchMessageError

U32_MAX = 0xFFFFFFFF


def _pk_take(pk, idx):
    """Index a packed-kmer payload: one u64 array for k <= 31, a (lo, hi)
    word tuple on the wide (k > 31) path."""
    if isinstance(pk, tuple):
        return tuple(w[idx] for w in pk)
    return pk[idx]
U64_MAX = 0xFFFFFFFFFFFFFFFF


def scale_to_max_hash(scale: float) -> int:
    """max_hash = u64::MAX / (1/scale) as u64  (scaled.rs:22-31).

    The Rust cast `(1./scale) as u64` truncates toward zero (and saturates),
    which we must reproduce exactly.
    """
    iscale = 1.0 / scale
    if iscale >= 2.0**64:
        iscale_int = U64_MAX
    elif iscale <= 0:
        iscale_int = 0
    else:
        iscale_int = int(iscale)  # truncation, like `as u64`
    if iscale_int == 0:
        # the reference panics on the u64::MAX / 0 (scaled.rs:31); surface
        # the invalid parameter instead of silently sketching everything
        raise FinchMessageError(
            f"invalid scale {1.0 / iscale if iscale else 0!r}: "
            "scale must be in (0, 1]")
    return U64_MAX // iscale_int


@dataclass(frozen=True)
class SketchParams:
    """Tagged union over the three sketch schemes (mod.rs:53-71)."""

    sketch_type: str = "mash"  # "mash" | "scaled" | "none"
    kmers_to_sketch: int = 1000
    final_size: int = 1000  # mash only
    no_strict: bool = False  # mash only
    kmer_length: int = 21
    hash_seed: int = 0
    scale: float = 0.001  # scaled only

    @staticmethod
    def mash(kmers_to_sketch=1000, final_size=1000, no_strict=False,
             kmer_length=21, hash_seed=0) -> "SketchParams":
        return SketchParams("mash", kmers_to_sketch, final_size, no_strict,
                            kmer_length, hash_seed, 0.0)

    @staticmethod
    def scaled(kmers_to_sketch=1000, kmer_length=21, scale=0.001,
               hash_seed=0) -> "SketchParams":
        return SketchParams("scaled", kmers_to_sketch, 0, False,
                            kmer_length, hash_seed, scale)

    @staticmethod
    def all_counts(kmer_length=4) -> "SketchParams":
        return SketchParams("none", 0, 0, False, kmer_length, 0, 0.0)

    @property
    def k(self) -> int:
        return self.kmer_length

    def hash_info(self):
        """(hash_type, hash_bits, hash_seed, scale|None)  (mod.rs:138-146)."""
        if self.sketch_type == "mash":
            return ("MurmurHash3_x64_128", 64, self.hash_seed, None)
        if self.sketch_type == "scaled":
            return ("MurmurHash3_x64_128", 64, self.hash_seed, self.scale)
        return ("None", 0, 0, None)

    def expected_size(self) -> int:
        """mod.rs:148-156."""
        if self.sketch_type == "mash":
            return self.final_size
        if self.sketch_type == "scaled":
            return self.kmers_to_sketch
        return 4 ** self.kmer_length

    def max_hash(self) -> Optional[int]:
        if self.sketch_type == "scaled":
            return scale_to_max_hash(self.scale)
        return None

    def process_post_filter(self, kmers: list, name: str) -> list:
        """Truncate to final_size; strict check (mod.rs:115-128). Works on
        KmerCount lists and array 4-tuples alike."""
        if isinstance(kmers, tuple):
            h, c, e, pk = kmers
            if self.sketch_type == "mash":
                n = min(len(h), self.final_size)
                if not self.no_strict and n < self.final_size:
                    raise FinchMessageError(
                        f"{name} had too few kmers ({n}) to sketch")
                return h[:n], c[:n], e[:n], _pk_take(pk, slice(None, n))
            return kmers
        if self.sketch_type == "mash":
            kmers = kmers[: self.final_size]
            if not self.no_strict and len(kmers) < self.final_size:
                raise FinchMessageError(
                    f"{name} had too few kmers ({len(kmers)}) to sketch")
        return kmers

    def check_compatibility(self, other: "SketchParams"):
        """Return (param, v1, v2) on mismatch, else None (mod.rs:185-212)."""
        if self.k != other.k:
            return ("k", str(self.k), str(other.k))
        if self.hash_info()[0] != other.hash_info()[0]:
            return ("hash type", self.hash_info()[0], other.hash_info()[0])
        if self.hash_info()[1] != other.hash_info()[1]:
            return ("hash bits", str(self.hash_info()[1]),
                    str(other.hash_info()[1]))
        if self.hash_info()[2] != other.hash_info()[2]:
            return ("hash seed", str(self.hash_info()[2]),
                    str(other.hash_info()[2]))
        return None

    @staticmethod
    def from_sketches(sketches) -> "SketchParams":
        """mod.rs:158-177."""
        first = sketches[0].sketch_params
        for ix, sketch in enumerate(sketches[1:], start=1):
            mism = first.check_compatibility(sketch.sketch_params)
            if mism is not None:
                name, v1, v2 = mism
                raise FinchMessageError(
                    f"First sketch has {name} {v1}, but sketch {ix + 1} has "
                    f"{name} {v2}")
        return first

    def replace(self, **kw) -> "SketchParams":
        return replace(self, **kw)


def _fmt_f64(x: float) -> str:
    """Rust f64 Display (to_string()): shortest round-trip digits, always
    positional — Display never uses exponent notation — and integral
    values without the ".0"."""
    if x == int(x) and abs(x) < 1e16:
        return str(int(x))
    r = repr(x)
    if "e" in r or "E" in r:
        from decimal import Decimal

        return format(Decimal(r), "f")
    return r


@dataclass
class FilterParams:
    """filtering.rs:11-16; default filtering.rs:136-145."""

    filter_on: Optional[bool] = False  # Some(false) is the Rust default
    abun_filter: tuple = (None, None)
    err_filter: float = 0.0
    strand_filter: float = 0.0

    def copy(self) -> "FilterParams":
        return FilterParams(self.filter_on, tuple(self.abun_filter),
                            self.err_filter, self.strand_filter)

    def filter_counts(self, hashes):
        """Filtering pipeline, filtering.rs:60-87. Mutates self.abun_filter
        when the error filter derives a stricter low cutoff. `hashes` is a
        list of KmerCount."""
        from finch_tpu_torch.core import filtering

        filter_on = self.filter_on is True
        filtered = list(hashes)
        if filter_on and self.strand_filter > 0.0:
            filtered = filtering.filter_strands(filtered, self.strand_filter)
        if filter_on and self.err_filter > 0.0:
            cutoff = filtering.guess_filter_threshold(filtered, self.err_filter)
            low = self.abun_filter[0]
            if low is not None:
                if cutoff > low:
                    self.abun_filter = (cutoff, self.abun_filter[1])
            else:
                self.abun_filter = (cutoff, self.abun_filter[1])
        if filter_on and (self.abun_filter[0] is not None
                          or self.abun_filter[1] is not None):
            filtered = filtering.filter_abundance(
                filtered, self.abun_filter[0], self.abun_filter[1])
        return filtered

    def filter_counts_arrays(self, h, c, e, pk):
        """Array form of filter_counts: same pipeline order and abun_filter
        mutation, on (hash, count, extra, packed) arrays — no KmerCount
        objects until the final survivors are known."""
        import numpy as np

        from finch_tpu_torch.core import filtering

        filter_on = self.filter_on is True
        if filter_on and self.strand_filter > 0.0:
            m = filtering.filter_strands_mask(c, e, self.strand_filter)
            h, c, e, pk = h[m], c[m], e[m], _pk_take(pk, m)
        if filter_on and self.err_filter > 0.0:
            cutoff = filtering.guess_filter_threshold(
                np.asarray(c), self.err_filter)
            low = self.abun_filter[0]
            if low is None or cutoff > low:
                self.abun_filter = (cutoff, self.abun_filter[1])
        if filter_on and (self.abun_filter[0] is not None
                          or self.abun_filter[1] is not None):
            m = filtering.filter_abundance_mask(
                c, self.abun_filter[0], self.abun_filter[1])
            h, c, e, pk = h[m], c[m], e[m], _pk_take(pk, m)
        return h, c, e, pk

    def filter_sketch(self, sketch) -> None:
        """Metadata-only update quirk (filtering.rs:20-54): runs the filters
        on a copy of the params, DISCARDS the filtered hashes, and only
        tightens the sketch's recorded filter params."""
        filters_copy = self.copy()
        filters_copy.filter_counts(sketch.hashes)
        sp = sketch.filter_params
        sp.filter_on = self.filter_on
        lo, hi = self.abun_filter
        slo, shi = sp.abun_filter
        if lo is not None and hi is not None:
            sp.abun_filter = (max(lo, slo or 0), min(hi, shi if shi is not None else U32_MAX))
        elif lo is not None:
            sp.abun_filter = (max(lo, slo or 0), None)
        elif hi is not None:
            sp.abun_filter = (None, min(hi, shi if shi is not None else U32_MAX))
        else:
            sp.abun_filter = (None, None)
        sp.err_filter = max(sp.err_filter, self.err_filter)
        sp.strand_filter = max(sp.strand_filter, self.strand_filter)

    def to_serialized(self) -> dict:
        """filtering.rs:89-108 (key order follows the reference code)."""
        out = {}
        if self.filter_on is not True:
            return out
        if self.strand_filter > 0.0:
            out["strandFilter"] = _fmt_f64(self.strand_filter)
        if self.err_filter > 0.0:
            out["errFilter"] = _fmt_f64(self.err_filter)
        if self.abun_filter[0] is not None:
            out["minCopies"] = str(self.abun_filter[0])
        if self.abun_filter[1] is not None:
            out["maxCopies"] = str(self.abun_filter[1])
        return out

    @staticmethod
    def from_serialized(filters: dict) -> "FilterParams":
        """filtering.rs:110-133."""
        low = int(filters["minCopies"]) if "minCopies" in filters else None
        high = int(filters["maxCopies"]) if "maxCopies" in filters else None
        return FilterParams(
            filter_on=bool(filters),
            abun_filter=(low, high),
            err_filter=float(filters.get("errFilter", "0")),
            strand_filter=float(filters.get("strandFilter", "0")),
        )
