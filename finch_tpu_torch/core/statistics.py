"""Sketch statistics: KMV cardinality + abundance histogram.

Exact semantics of finch-rs/lib/src/statistics.rs (including the f32
arithmetic in `cardinality`, statistics.rs:19-22).
"""

from __future__ import annotations

from typing import List

import numpy as np


def cardinality(sketch) -> int:
    """k-minimum-value unique-kmer estimate (statistics.rs:8-23).

    Reproduces the reference's f32 math: (len-1) / (last_hash / usize::MAX)
    evaluated in f32 then truncated to integer.
    """
    if not len(sketch):
        return 0
    last_hash = sketch[-1].hash if hasattr(sketch[-1], "hash") else int(sketch[-1])
    num = np.float32(len(sketch) - 1)
    den = np.float32(np.float32(np.uint64(last_hash)) /
                     np.float32(np.uint64(0xFFFFFFFFFFFFFFFF)))
    with np.errstate(divide="ignore", invalid="ignore"):
        val = np.float32(num / den)
    # Rust `as u64` cast: NaN -> 0, clamps to [0, u64::MAX]
    if np.isnan(val) or val < 0:
        return 0
    if np.isinf(val) or val >= np.float32(2.0**64):
        return 0xFFFFFFFFFFFFFFFF
    return int(val)


def hist(sketch) -> List[int]:
    """Number of kmers at each coverage level; index i = count i+1
    (statistics.rs:30-47). Accepts KmerCount lists, plain ints, or a
    numpy count array (vectorized)."""
    import numpy as np

    if isinstance(sketch, np.ndarray):
        if len(sketch) == 0:
            return []
        return np.bincount(sketch.astype(np.int64))[1:].tolist()
    max_count = 0
    counts = {}
    for k in sketch:
        c = k.count if hasattr(k, "count") else int(k)
        max_count = max(max_count, c)
        counts[c - 1] = counts.get(c - 1, 0) + 1
    return [counts.get(i, 0) for i in range(max_count)]
