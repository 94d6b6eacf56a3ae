"""Drop-in equivalent of finch's Python bindings (pyo3 module `finch`).

The counterpart of ``finch_tpu/api.py``. Usage: ``import
finch_tpu_torch.api as finch`` then use ``finch.Multisketch``,
``finch.Sketch``, ``finch.sketch_file`` like the reference module
(finch-rs/lib/src/python.rs). ``sketch_file`` takes the auto backend: a
small input folds on the host, a large one at k <= 63 moves to the card
unless the caller passes ``device="cpu"``, and k >= 64 stays on the host;
without a card it raises at any k.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from finch_tpu_torch.core import sketch as core_sketch
from finch_tpu_torch.core.distance import distance as core_distance
from finch_tpu_torch.core.distance import minmer_matrix
from finch_tpu_torch.core.sketching import sketch_files as rs_sketch_files
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.serialization import open_sketch_file
from finch_tpu_torch.serialization.finch_bsk import write_finch_file

# the pyo3 module exports one exception type (python.rs:682-690); ours is
# the library-wide unified taxonomy root (finch_tpu_torch/errors.py)
from finch_tpu_torch.errors import FinchError as FinchError  # noqa: F401 re-export


def merge_sketches(sketch: core_sketch.Sketch, other: core_sketch.Sketch,
                   size: Optional[int] = None) -> None:
    """Sorted two-pointer merge summing counts on hash ties, then clip
    (python.rs:24-100)."""
    sketch.seq_length += other.seq_length
    sketch.num_valid_kmers += other.num_valid_kmers

    mism = sketch.sketch_params.check_compatibility(other.sketch_params)
    if mism is not None:
        name, v1, v2 = mism
        raise FinchError(
            f"First sketch has {name} {v1}, but second sketch has {name} {v2}")

    s1 = sketch.hashes
    s2 = other.hashes
    new_hashes: List[core_sketch.KmerCount] = []
    i = j = 0
    while i < len(s1) and j < len(s2):
        if s1[i].hash < s2[j].hash:
            new_hashes.append(s1[i])
            i += 1
        elif s2[j].hash < s1[i].hash:
            new_hashes.append(s2[j])
            j += 1
        else:
            new_hashes.append(core_sketch.KmerCount(
                hash=s1[i].hash, kmer=s1[i].kmer,
                count=s1[i].count + s2[j].count,
                extra_count=s1[i].extra_count + s2[j].extra_count,
                label=s1[i].label))
            i += 1
            j += 1
    # NOTE: faithful to the reference, which drops the unmerged tails of
    # both inputs (python.rs:49-67 only walks while both have elements).

    scale = sketch.sketch_params.hash_info()[3]
    if size is not None and scale is not None:
        max_hash = sketch.sketch_params.max_hash()
        clipped = []
        for ix, h in enumerate(new_hashes):
            if h.hash <= max_hash or ix < size:
                clipped.append(h)
            else:
                break
        new_hashes = clipped
    elif scale is not None:
        max_hash = sketch.sketch_params.max_hash()
        clipped = []
        for h in new_hashes:
            if h.hash > max_hash:
                break
            clipped.append(h)
        new_hashes = clipped
    elif size is not None:
        new_hashes = new_hashes[:size]
    sketch.hashes = new_hashes


def _clone_core(s: core_sketch.Sketch) -> core_sketch.Sketch:
    """Fast deep clone of a core sketch (KmerCounts are re-created; kmer
    bytes are immutable and shared). ~10x cheaper than copy.deepcopy."""
    from dataclasses import replace as _rep

    return core_sketch.Sketch(
        name=s.name, seq_length=s.seq_length,
        num_valid_kmers=s.num_valid_kmers, comment=s.comment,
        hashes=[_rep(k) for k in s.hashes],
        filter_params=s.filter_params.copy(),
        sketch_params=s.sketch_params)


class Sketch:
    """python.rs:310-616.

    Accessing a Multisketch member returns a copy-on-write view: the pyo3
    bindings clone on access (python.rs:149-156), but eagerly deep-copying
    made iterating an n-sketch DB O(n^2); here the clone is deferred to
    the first mutation, which is semantically identical."""

    _owned: bool = True

    def _own(self) -> None:
        if not self._owned:
            self.s = _clone_core(self.s)
            self._owned = True

    def __init__(self, name: str, _core: Optional[core_sketch.Sketch] = None,
                 _shared: bool = False):
        self._owned = not _shared
        if _core is not None:
            self.s = _core
            return
        self.s = core_sketch.Sketch(
            name=name, seq_length=0, num_valid_kmers=0, comment="",
            hashes=[],
            filter_params=FilterParams(),
            sketch_params=SketchParams.mash(
                kmers_to_sketch=1000, final_size=1000, no_strict=True,
                kmer_length=21, hash_seed=0))

    def __repr__(self):
        return f'<Sketch "{self.s.name}">'

    def __len__(self):
        return len(self.s)

    @property
    def name(self) -> str:
        return self.s.name

    @name.setter
    def name(self, value: str) -> None:
        self._own()
        self.s.name = value

    @property
    def seq_length(self) -> int:
        return self.s.seq_length

    @property
    def num_valid_kmers(self) -> int:
        return self.s.num_valid_kmers

    @property
    def comment(self) -> str:
        return self.s.comment

    @comment.setter
    def comment(self, value: str) -> None:
        self._own()
        self.s.comment = value

    @property
    def hashes(self) -> List[Tuple[int, bytes, int, int]]:
        return [(k.hash, k.kmer, k.count, k.extra_count)
                for k in self.s.hashes]

    @property
    def sketch_params(self) -> dict:
        p = self.s.sketch_params
        if p.sketch_type == "mash":
            return {"sketch_type": "mash",
                    "kmers_to_sketch": p.kmers_to_sketch,
                    "final_size": p.final_size, "no_strict": p.no_strict,
                    "kmer_length": p.kmer_length, "hash_seed": p.hash_seed}
        if p.sketch_type == "scaled":
            return {"sketch_type": "scaled",
                    "kmers_to_sketch": p.kmers_to_sketch,
                    "kmer_length": p.kmer_length, "scale": p.scale,
                    "hash_seed": p.hash_seed}
        return {"sketch_type": "none", "kmer_length": p.kmer_length}

    def merge(self, sketch: "Sketch", size: Optional[int] = None) -> None:
        self._own()
        merge_sketches(self.s, sketch.s, size)

    def compare(self, sketch: "Sketch",
                old_mode: bool = False) -> Tuple[float, float]:
        """-> (containment, jaccard); python.rs:482-487."""
        d = core_distance(sketch.s, self.s, old_mode)
        return (d.containment, d.jaccard)

    def compare_counts(self, sketch: "Sketch"):
        """Count/moment stats over the intersection (python.rs:496-559).

        The two-pointer walk is replaced by its closed form (see
        core/distance.py: both final pointers equal #(h <= m) with
        m = min of the two maxima); the reference's exact online-moment
        update order is kept, run only over the common elements, so the
        f64 results are bit-identical to the streaming loop."""
        rh = self.s.hash_array()
        qh = sketch.s.hash_array()
        if len(rh) == 0 or len(qh) == 0:
            return (0, 0, 0, 0, 0, math.nan, math.nan, math.nan)
        rc = np.array([k.count for k in self.s.hashes], dtype=np.uint64)
        qc = np.array([k.count for k in sketch.s.hashes], dtype=np.uint64)
        m = min(int(rh[-1]), int(qh[-1]))
        ref_pos = int(np.searchsorted(rh, np.uint64(m), side="right"))
        query_pos = int(np.searchsorted(qh, np.uint64(m), side="right"))
        _, ri, qi = np.intersect1d(rh, qh, assume_unique=True,
                                   return_indices=True)
        common = len(ri)
        ref_count = int(rc[ri].sum())
        query_count = int(qc[qi].sum())
        q_mean = q_m2 = q_m3 = q_m4 = 0.0
        for idx, fc in enumerate(qc[qi].astype(np.float64)):
            n = idx + 1.0
            delta = fc - q_mean
            delta_n = delta / n
            delta_n2 = delta_n * delta_n
            term1 = delta * delta_n * (n - 1.0)
            q_mean += delta_n
            q_m4 += (term1 * delta_n2 * (n * n - 3.0 * n + 3.0)
                     + 6.0 * delta_n2 * q_m2 - 4.0 * delta_n * q_m3)
            q_m3 += term1 * delta_n * (n - 2.0) - 3.0 * delta_n * q_m2
            q_m2 += term1
        var = q_m2 / common if common else math.nan
        skew = (math.sqrt(common) * q_m3 / q_m2 ** 1.5) if q_m2 else math.nan
        kurt = (common * q_m4 / (q_m2 * q_m2) - 3.0) if q_m2 else math.nan
        return (common, ref_pos, query_pos, ref_count, query_count, var,
                skew, kurt)

    def compare_matrix(self, *sketches: "Sketch") -> np.ndarray:
        """Counts matrix aligned to this sketch's hashes (python.rs:569-576)."""
        pairs = [(np.array([k.hash for k in s.s.hashes], dtype=np.uint64),
                  [k.count for k in s.s.hashes]) for s in sketches]
        return minmer_matrix(
            np.array([k.hash for k in self.s.hashes], dtype=np.uint64), pairs)

    @property
    def counts(self) -> np.ndarray:
        return np.array([k.count for k in self.s.hashes], dtype=np.int32)

    @counts.setter
    def counts(self, value) -> None:
        """Setter drops zero-count entries (python.rs:585-608)."""
        self._own()
        val = list(value)
        if len(val) != len(self.s.hashes):
            raise FinchError("counts must be same length as sketch")
        new_hashes = []
        for kc, v in zip(self.s.hashes, val):
            if v < 0:
                raise FinchError(f"Negative count {v} not supported")
            if v > 0:
                new_hashes.append(core_sketch.KmerCount(
                    hash=kc.hash, kmer=kc.kmer, count=int(v),
                    extra_count=kc.extra_count, label=kc.label))
        self.s.hashes = new_hashes

    def copy(self) -> "Sketch":
        return Sketch("", _core=_clone_core(self.s))


class Multisketch:
    """python.rs:105-266."""

    def __init__(self, sketches: Optional[List[core_sketch.Sketch]] = None):
        self.sketches: List[core_sketch.Sketch] = sketches or []

    @classmethod
    def open(cls, filename: str) -> "Multisketch":
        try:
            return cls(open_sketch_file(filename))
        except Exception as e:
            raise FinchError(str(e))

    @classmethod
    def from_sketches(cls, sketches: List[Sketch]) -> "Multisketch":
        return cls([s.s for s in sketches])

    def __repr__(self):
        n = len(self.sketches)
        plural = "sketch" if n == 1 else "sketches"
        return f"<Multisketch ({n} {plural})>"

    def __len__(self):
        return len(self.sketches)

    def __iter__(self):
        # pyo3 clones on access (python.rs:149); the COW view defers the
        # clone to first mutation, making iteration O(1) per member
        return (Sketch("", _core=s, _shared=True)
                for s in list(self.sketches))

    def _index(self, key) -> int:
        if isinstance(key, int):
            l = len(self.sketches)
            # (python.rs:283-290 computes l - key for negative keys, which
            # overruns; we implement standard Python negative indexing)
            if -l <= key < 0:
                return l + key
            if 0 <= key < l:
                return key
            raise IndexError("index out of range")
        if isinstance(key, str):
            for i, s in enumerate(self.sketches):
                if s.name == key:
                    return i
            raise KeyError(key)
        raise FinchError("key is not a string or integer")

    def __getitem__(self, key) -> Sketch:
        # COW clone like the reference bindings (python.rs:156)
        return Sketch(
            "", _core=self.sketches[self._index(key)], _shared=True)

    def __delitem__(self, key) -> None:
        del self.sketches[self._index(key)]

    def __contains__(self, key: str) -> bool:
        return any(s.name == key for s in self.sketches)

    def save(self, filename: str) -> None:
        """Writes finch binary (.bsk) format (python.rs:180-186)."""
        try:
            with open(filename, "wb") as f:
                f.write(write_finch_file(self.sketches))
        except OSError:
            raise FinchError(f"Could not create {filename}")

    def add(self, sketch: Sketch) -> None:
        # clone like the reference bindings (python.rs:196): the core is
        # shared and the wrapper demoted to a COW view, so a later
        # mutation through it clones instead of reaching the collection
        self.sketches.append(sketch.s)
        sketch._owned = False

    def best_match(self, query: Sketch) -> Tuple[int, Sketch]:
        """Max-containment member (python.rs:202-216)."""
        best = 0
        max_containment = 0.0
        for ix, s in enumerate(self.sketches):
            d = core_distance(query.s, s, False)
            if d.containment > max_containment:
                max_containment = d.containment
                best = ix
        # COW clone like the reference bindings (python.rs:216)
        return (best, Sketch("", _core=self.sketches[best], _shared=True))

    def filter_to_matches(self, query: Sketch, threshold: float) -> None:
        """python.rs:223-234."""
        self.sketches = [
            s for s in self.sketches
            if core_distance(query.s, s, False).containment >= threshold]

    def filter_to_names(self, names) -> None:
        name_set = set(names)
        self.sketches = [s for s in self.sketches if s.name in name_set]


def sketch_file(filename: str, n_hashes: int = 1000,
                final_size: Optional[int] = None, kmer_length: int = 21,
                filter: bool = True, seed: int = 0,
                no_strict: bool = False, device="cuda") -> Sketch:
    """python.rs:645-679 (hardwired err_filter=1.0, strand_filter=0.1);
    the auto backend on `device`, which keeps k >= 64 on the host."""
    sketch_params = SketchParams.mash(
        kmers_to_sketch=n_hashes,
        final_size=final_size if final_size is not None else n_hashes,
        no_strict=no_strict, kmer_length=kmer_length, hash_seed=seed)
    filters = FilterParams(filter_on=filter, abun_filter=(None, None),
                           err_filter=1.0, strand_filter=0.1)
    try:
        sketches = rs_sketch_files([filename], sketch_params, filters,
                                   device=device)
    except Exception as e:
        raise FinchError(str(e))
    return Sketch("", _core=sketches[-1])
