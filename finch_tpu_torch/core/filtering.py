"""Adaptive error / strand / abundance filters.

Exact transcription of the reference semantics:
  * guess_filter_threshold — finch-rs/lib/src/filtering.rs:154-195
  * filter_abundance       — finch-rs/lib/src/filtering.rs:329-343
  * filter_strands         — finch-rs/lib/src/filtering.rs:413-432

These run on host over the (small, <= kmers_to_sketch) candidate arrays; the
heavy reduction work happened on-device before this point.
"""

from __future__ import annotations

from typing import Optional


from finch_tpu_torch.core.statistics import hist


def guess_filter_threshold(sketch, filter_level: float) -> int:
    """Dynamic low-abundance cutoff from the count histogram.

    Returns the lowest count that should be kept (filtering.rs:154-195).
    """
    hist_data = hist(sketch)
    total_counts = float(sum((i + 1) * c for i, c in enumerate(hist_data)))
    cutoff_amt = filter_level * total_counts

    wgt_cutoff = 0
    cum_count = 0
    for count in hist_data:
        cum_count += wgt_cutoff * count
        if float(cum_count) > cutoff_amt:
            break
        wgt_cutoff += 1

    if wgt_cutoff == 0:
        return 1

    win_size = max(1, wgt_cutoff // 20)
    s = sum(hist_data[:win_size])
    lowest_val = s
    lowest_idx = win_size - 1
    for i, j in zip(range(wgt_cutoff - win_size), range(win_size, wgt_cutoff)):
        if s <= lowest_val:
            lowest_val = s
            lowest_idx = j
        s -= hist_data[i]
        s += hist_data[j]

    return lowest_idx + 1


def filter_abundance(sketch, low: Optional[int], high: Optional[int]):
    """Inclusive low <= count <= high (filtering.rs:329-343)."""
    lo = low if low is not None else 0
    hi = high if high is not None else 0xFFFFFFFF
    return [k for k in sketch if lo <= k.count <= hi]


def filter_strands(sketch, ratio_cutoff: float):
    """Strand-bias (adapter) filter (filtering.rs:413-432).

    Entries with count < 16 pass through; otherwise keep iff
    min(extra, count - extra) / count >= ratio_cutoff.
    """
    out = []
    for k in sketch:
        if k.count < 16:
            out.append(k)
            continue
        lowest = min(k.extra_count, k.count - k.extra_count)
        if (lowest / k.count) >= ratio_cutoff:
            out.append(k)
    return out


# ---------------------------------------------------------------------------
# Array variants (object-free fast path; bit-identical to the list forms,
# property-pinned in tests/test_filtering.py)
# ---------------------------------------------------------------------------

def filter_strands_mask(c, e, ratio_cutoff: float):
    """Boolean keep-mask form of filter_strands (filtering.rs:413-432)."""
    import numpy as np

    c64 = c.astype(np.float64)
    lowest = np.minimum(e, c - e).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio_ok = lowest / c64 >= ratio_cutoff
    return (c < 16) | ratio_ok


def filter_abundance_mask(c, low, high):
    """Boolean keep-mask form of filter_abundance (filtering.rs:329-343)."""
    lo = low if low is not None else 0
    hi = high if high is not None else 0xFFFFFFFF
    return (c >= lo) & (c <= hi)
