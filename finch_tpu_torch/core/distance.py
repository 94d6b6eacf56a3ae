"""Jaccard / containment / Mash distance engine (host path).

Exact vectorized re-derivation of the reference's two-pointer merge
(finch-rs/lib/src/distance.rs:66-126). For distinct sorted hash arrays
the pointer-merge end state is closed-form:

    m      = min(max(query), max(ref))
    common = |query ∩ ref|                (common elements are always <= m)
    i      = #{q in query : q <= m}
    j      = #{r in ref   : r <= m}

then the scaled-tail rule advances i/j past hashes < max_hash
(distance.rs:99-115), and:

    containment = common / j   (0 if j == 0)
    total       = i - common + j
    jaccard     = common / total   (1 if total == 0)
    mashDistance = clamp(-ln(2j/(1+j)) / k, 0, 1)   (distance.rs:37-41)

The batched engines in parallel/ (mxu_dist.py, sharded_dist.py) compute
the same integer statistics on the card; cli.py applies this float math
on host (f64).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from finch_tpu_torch.core.sketch import Sketch
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.params import U64_MAX


@dataclass
class SketchDistance:
    """JSON shape per finch-rs/lib/src/serialization/mod.rs:31-43."""

    containment: float
    jaccard: float
    mash_distance: float
    common_hashes: int
    total_hashes: int
    query: str
    reference: str

    def to_json_dict(self) -> dict:
        return {
            "containment": self.containment,
            "jaccard": self.jaccard,
            "mashDistance": self.mash_distance,
            "commonHashes": self.common_hashes,
            "totalHashes": self.total_hashes,
            "query": self.query,
            "reference": self.reference,
        }


def scale_recip_max_hash(scale: float) -> int:
    """u64::MAX / scale.recip() as u64 (distance.rs:100)."""
    recip = 1.0 / scale
    if recip >= 2.0**64:
        r = U64_MAX
    elif recip <= 0:
        r = 0
    else:
        r = int(recip)
    if r == 0:
        r = 1
    return U64_MAX // r


def raw_distance_arrays(query: np.ndarray, ref: np.ndarray, scale: float):
    """(containment, jaccard, common, total) over sorted distinct u64 hash
    arrays — exact equivalent of distance.rs:66-126."""
    query = np.asarray(query, dtype=np.uint64)
    ref = np.asarray(ref, dtype=np.uint64)
    if len(query) == 0 or len(ref) == 0:
        i = j = 0
        common = 0
    else:
        m = min(int(query[-1]), int(ref[-1]))
        common = int(np.intersect1d(query, ref, assume_unique=True).size)
        i = int(np.searchsorted(query, np.uint64(m), side="right"))
        j = int(np.searchsorted(ref, np.uint64(m), side="right"))

    if scale > 0.0:
        max_hash = scale_recip_max_hash(scale)
        i = max(i, int(np.searchsorted(query, np.uint64(max_hash), side="left")))
        j = max(j, int(np.searchsorted(ref, np.uint64(max_hash), side="left")))

    containment = 0.0 if j == 0 else common / j
    total = i - common + j
    jaccard = 1.0 if total == 0 else common / total
    return containment, jaccard, common, total


def old_distance_arrays(query: np.ndarray, ref: np.ndarray):
    """v0.2 containment-biased mode (distance.rs:136-157), faithful loop
    semantics (including the i < len-1 pointer clamp).

    Degenerate inputs: an empty ref leaves total == 0, so the 0/0 f64
    divisions produce NaN exactly as in Rust (distance.rs:153-155; NaN
    serializes as null, like serde_json). An empty query would index
    ``query_sketch[0]`` out of bounds in Rust (a panic); we raise a clean
    FinchError instead of crashing.
    """
    query = np.asarray(query, dtype=np.uint64)
    ref = np.asarray(ref, dtype=np.uint64)
    if len(query) == 0 and len(ref) > 0:
        raise FinchMessageError(
            "old-dist requires a non-empty query sketch")
    if len(ref) == 0:
        return float("nan"), float("nan"), 0, 0
    # vectorized transcription of the reference's monotone pointer walk:
    # for each ref hash the pointer advances to the first query index with
    # query[i] >= rh, clamped to len-1, and never moves backward
    # (np.maximum.accumulate keeps the never-backward rule faithful even
    # for pathological unsorted inputs)
    idx = np.minimum(np.searchsorted(query, ref, side="left"),
                     len(query) - 1)
    idx = np.maximum.accumulate(idx)
    common = int((query[idx] == ref).sum())
    total = len(ref)
    containment = common / total
    jaccard = common / (common + 2 * (total - common))
    return containment, jaccard, common, total


def mash_distance_from_jaccard(jaccard: float, k: float) -> float:
    """clamp(-ln(2j/(1+j))/k, 0, 1) — distance.rs:37-41."""
    if jaccard == 0.0:
        m = math.inf
    else:
        m = -1.0 * math.log((2.0 * jaccard) / (1.0 + jaccard)) / k
    return min(1.0, max(0.0, m))


def distance_from_stats(common: int, i: int, j: int, k: float,
                        query: str, reference: str) -> SketchDistance:
    """Build a SketchDistance from the integer pointer-merge end state —
    the single f64 formula shared by the serial and device-batched paths
    (distance.rs:29-47)."""
    containment = 0.0 if j == 0 else common / j
    total = i - common + j
    jaccard = 1.0 if total == 0 else common / total
    return SketchDistance(
        containment=containment,
        jaccard=jaccard,
        mash_distance=mash_distance_from_jaccard(jaccard, k),
        common_hashes=common,
        total_hashes=total,
        query=query,
        reference=reference,
    )


def distance(query_sketch: Sketch, ref_sketch: Sketch,
             old_mode: bool = False) -> SketchDistance:
    """distance.rs:9-47."""
    if old_mode:
        cont, jac, common, total = old_distance_arrays(
            query_sketch.hash_array(), ref_sketch.hash_array())
    else:
        min_scale = 0.0
        s1 = query_sketch.sketch_params.hash_info()[3]
        s2 = ref_sketch.sketch_params.hash_info()[3]
        if s1 is not None and s2 is not None:
            min_scale = min(s1, s2)
        cont, jac, common, total = raw_distance_arrays(
            query_sketch.hash_array(), ref_sketch.hash_array(), min_scale)

    k = float(query_sketch.sketch_params.k)
    return SketchDistance(
        containment=cont,
        jaccard=jac,
        mash_distance=mash_distance_from_jaccard(jac, k),
        common_hashes=common,
        total_hashes=total,
        query=query_sketch.name,
        reference=ref_sketch.name,
    )


def minmer_matrix(ref_hashes, sketches_hashes_counts):
    """Sketches × ref-hash count matrix (distance.rs:345-364).

    ref_hashes: sorted u64 array; sketches_hashes_counts: list of
    (hashes u64[], counts u32[]). Faithful to the reference's pointer walk
    (which clamps at the last ref position).
    """
    ref_hashes = np.asarray(ref_hashes, dtype=np.uint64)
    out = np.zeros((len(sketches_hashes_counts), len(ref_hashes)),
                   dtype=np.int32)
    if len(ref_hashes) == 0:
        return out
    # The reference walks a monotone ref cursor over ascending sketch
    # hashes, stopping at the first ref >= h and clamping at the last ref
    # position (distance.rs:351-361). For ascending distinct hashes that
    # cursor equals min(searchsorted_left(ref, h), len-1), so the walk
    # vectorizes to one searchsorted per sketch.
    for i, (hashes, counts) in enumerate(sketches_hashes_counts):
        hashes = np.asarray(hashes, dtype=np.uint64)
        counts = (np.asarray(counts, dtype=np.uint64)
                  .astype(np.uint32).view(np.int32))  # Rust `as i32` wrap
        pos = np.minimum(np.searchsorted(ref_hashes, hashes, side="left"),
                         len(ref_hashes) - 1)
        match = ref_hashes[pos] == hashes
        out[i, pos[match]] = counts[match]
    return out
