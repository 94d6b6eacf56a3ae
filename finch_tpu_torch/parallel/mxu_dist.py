"""All-vs-all sketch intersection as Gram products on the card.

The counterpart of ``finch_tpu/parallel/mxu_dist.py``: `finch dist
--pairwise` at DB scale (reference: a serial per-pair two-pointer merge
over every (query, ref) combination, finch-rs/lib/src/distance.rs:66-126
driven by main.rs:315-334). The whole common-count matrix is a Gram
matrix:

    common = M @ M.T      where M[n, d] = 1 iff distinct hash d ∈ sketch n

and M's rows only interact through hashes shared by >= 2 sketches. So:

  1. ONE torch.sort of all hashes, with the sketch ids gathered by its
     indices, groups equal hashes into runs. Grouping needs equality
     only, so a signed int64 sort of the u64 bit patterns serves.
  2. Runs of length 1 (hashes unique to one sketch) contribute nothing
     off-diagonal and are dropped; the diagonal is just the sketch sizes.
  3. The surviving (run, sketch) incidences form E, a (runs x N) 0/1
     matrix built page by page; common += E_page.T @ E_page, int8
     through `torch._int_mm` with int32 sums (exact below 2^31).

The page cuts (a page never splits a run) are computed once on the host
from one copy of the run-start offsets: the Gram sum does not depend on
how whole runs are grouped into pages.

The i/j pointer-end counts decompose per pair as #{h <= m} with
m = min(max_q, max_r) (core/distance.py's closed form): one batched
`torch.searchsorted` of the sketch maxima into each row, in u64
order (``u64.key``). Survivors of a --max-dist cut are masked on the card
with the JAX package's conservative f32 test and compacted with
`torch.nonzero` of the transposed mask, which is ref-major order.

Every device function takes `device` ("cuda" unless the caller passes
"cpu"; without a card it raises). Each device phase runs inside
``torch.profiler.record_function("dist.<phase>")``, so a profile
attributes the card's time to it.

The mesh form, `sharded_common`, computes the incidences once and gives
each shard a contiguous element range cut at run boundaries; the shards'
int32 partials add on the first device and, across processes, by
`all_reduce(SUM)`. The JAX package's `_gram_range` is `_page_cuts` over
that range.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from finch_tpu_torch import u64
from finch_tpu_torch.models.engine import resolve_device
from finch_tpu_torch.models.params import U64_MAX

__all__ = ["all_pairs_stats", "all_pairs_common", "all_pairs_survivors",
           "below_counts_device", "pack_db", "sharded_common"]

# torch.searchsorted values per call in the below counts (bounds the
# expanded (rows, thresholds) int64 block to 128 MB)
_SEARCH_BLOCK = 1 << 24


def pack_db(sketch_hashes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length sorted hash arrays into (N, K) u64 with
    U64_MAX padding + (N,) lengths."""
    n = len(sketch_hashes)
    k = max((len(h) for h in sketch_hashes), default=1)
    out = np.full((n, max(k, 1)), U64_MAX, dtype=np.uint64)
    lens = np.zeros(n, dtype=np.int32)
    for i, h in enumerate(sketch_hashes):
        out[i, : len(h)] = h
        lens[i] = len(h)
    return out, lens


# ---------------------------------------------------------------------------
# phase 1: global sort -> shared-hash incidences (run_id, sketch_id)
# ---------------------------------------------------------------------------

def _shared_incidences(hashes: torch.Tensor, sid: torch.Tensor):
    """Sort the flat hashes, gather the sketch ids by the sort's indices,
    keep the elements whose hash occurs >= 2 times (pads at U64_MAX never
    duplicate real hashes and pad-pad runs are masked) and compact them.

    Returns (run_id i64[n_shared], sid i64[n_shared], run_start
    bool[n_shared]); run ids are dense (0..n_runs-1) and each run's
    elements are contiguous."""
    with record_function("dist.incidences"):
        hs, order = torch.sort(hashes)
        ss = sid[order]
        eq = hs[1:] == hs[:-1]
        edge = torch.zeros(1, dtype=torch.bool, device=hs.device)
        prev_eq = torch.cat([edge, eq])
        multi = (prev_eq | torch.cat([eq, edge])) & (hs != u64.MAX)
        new_run = multi & ~prev_eq
        rid = torch.cumsum(new_run, 0) - 1
        keep = torch.nonzero(multi).squeeze(1)
        return rid[keep], ss[keep], new_run[keep]


# ---------------------------------------------------------------------------
# phase 2: E-page Gram accumulation
# ---------------------------------------------------------------------------

def _page_size(run_block: int, n: int, cap: int) -> int:
    """Gram page: smallest power of two > max(run_block, n), clamped to
    the element count (a page must never split a run; the longest run
    holds each sketch once)."""
    page = 2
    while page < max(run_block, n + 1):
        page *= 2
    return min(page, max(int(cap), 2))


def _page_cuts(starts: np.ndarray, n_shared: int, page: int, lo: int = 0,
               hi: int | None = None):
    """[(a, b, r0, r1)]: the elements [a, b) and runs [r0, r1) of each
    page over the elements [lo, hi) (default: all), whose ends are run
    starts or n_shared. A page ends at the last run boundary within
    `page` elements of its start, which are the JAX package's cuts (its
    `_gram_range` for a range)."""
    ends = np.append(starts, n_shared)
    hi = n_shared if hi is None else hi
    r_hi = int(np.searchsorted(ends, hi))
    cuts = []
    a, r0 = lo, int(np.searchsorted(ends, lo))
    while a < hi:
        r1 = min(int(np.searchsorted(ends, a + page, side="right")) - 1,
                 r_hi)
        if r1 <= r0:
            raise ValueError(f"Gram page of {page} elements is shorter "
                             "than a run")
        b = int(ends[r1])
        cuts.append((a, b, r0, r1))
        a, r0 = b, r1
    return cuts


def _pad8(x: int, least: int = 8) -> int:
    return max(least, -(-x // 8) * 8)


def _gram_accumulate(rid: torch.Tensor, sid: torch.Tensor, cuts,
                     n_sketches: int) -> torch.Tensor:
    """common (N, N) int32 = sum over the pages `cuts` (_page_cuts) of
    E_page^T @ E_page.

    E is held transposed, (sketches, runs), so the product is
    `torch._int_mm(Et, Et.t())`: row-major times column-major. Its CUDA
    shape rules (rows > 16, inner and column counts multiples of 8) are
    met by zero rows and columns, which add nothing. Scatter conflicts
    cannot occur (a sketch holds each hash once), so E is written as
    0/1 directly, from a 1 that lies on the card (a Python 1 would be
    copied from the host, with a sync, on every page). One E buffer and
    one product buffer serve every page (stream order keeps a page's
    writes after the last page's reads)."""
    n_pad = _pad8(n_sketches, 24)
    dev = rid.device
    rows = [_pad8(r1 - r0) for _, _, r0, r1 in cuts]
    e_buf = torch.empty(n_pad * max(rows, default=8), device=dev,
                        dtype=torch.int8)
    common = torch.zeros((n_pad, n_pad), device=dev, dtype=torch.int32)
    prod = torch.empty_like(common)
    one = torch.ones((), dtype=e_buf.dtype, device=dev)
    for (a, b, r0, _), rp in zip(cuts, rows):
        with record_function("dist.e_scatter"):
            et = e_buf[:n_pad * rp].view(n_pad, rp).zero_()
            et.index_put_((sid[a:b], rid[a:b] - r0), one)
        with record_function("dist.gram"):
            common += torch._int_mm(et, et.t(), out=prod)
    return common[:n_sketches, :n_sketches]


def _check_gram_bound(k: int) -> None:
    """The int32 Gram accumulation is exact only while per-pair common
    counts stay below 2^31; a pair's common count is bounded by the padded
    sketch length, so enforce the precondition instead of assuming it."""
    if k >= 1 << 31:
        raise ValueError(
            "Gram distance engine: sketch length exceeds the exact "
            "accumulation bound; use the tile engine "
            "(parallel.sharded_dist) for sketches this large")


def _run_floor(starts: np.ndarray, n_shared: int, pos: int) -> int:
    """The start of the run that holds shared element `pos` (n_shared
    past the last one): a range end moved back to a run boundary."""
    if pos >= n_shared:
        return n_shared
    return int(starts[np.searchsorted(starts, pos, side="right") - 1])


def _common_device(h: torch.Tensor, run_block: int,
                   mesh=None) -> torch.Tensor:
    """The (N, N) int32 Gram of the (N, K) hashes `h` on their device,
    diagonal not fixed. Syncs once (for the run starts); the products
    stay queued when it returns.

    With `mesh` (parallel/mesh.py), global shard d Grams the shared
    elements [d*cap//n, (d+1)*cap//n) of the cap = N*K flat entries on
    its device, each end moved back to the start of its run (applied
    alike on both sides, so the ranges partition the runs), and this
    process's partials add on h's device. Without it, one range holds
    every element."""
    n, k = h.shape
    _check_gram_bound(k)
    sid = torch.arange(n, device=h.device).repeat_interleave(k)
    rid, sid_c, run_start = _shared_incidences(h.reshape(-1), sid)
    with record_function("dist.page_cuts"):
        starts = torch.nonzero(run_start).squeeze(1).cpu().numpy()
    n_shared = rid.shape[0]
    page = _page_size(run_block, n, n * k)
    if mesh is None:
        ranges = [(h.device, 0, n_shared)]
    else:
        ranges = []
        for i, dev in enumerate(mesh.devices):
            d = mesh.rank * len(mesh.devices) + i
            ranges.append((dev, *(_run_floor(starts, n_shared,
                                             e * n * k // mesh.size)
                                  for e in (d, d + 1))))
    common = None
    for dev, lo, hi in ranges:
        with record_function("dist.page_cuts"):
            cuts = [(a - lo, b - lo, r0, r1) for a, b, r0, r1 in
                    _page_cuts(starts, n_shared, page, lo, hi)]
        part = _gram_accumulate(rid[lo:hi].to(dev), sid_c[lo:hi].to(dev),
                                cuts, n).to(h.device)
        common = part if common is None else common + part
    return common


def all_pairs_common(hashes_padded: np.ndarray, lengths: np.ndarray,
                     run_block: int = 2048, device="cuda") -> np.ndarray:
    """Exact |q ∩ r| for all sketch pairs. (N, N) int64; the diagonal is
    the sketch sizes."""
    dev = resolve_device(device)
    common = _common_device(u64.from_numpy(hashes_padded, dev), run_block)
    common = common.cpu().numpy().astype(np.int64)
    np.fill_diagonal(common, np.asarray(lengths, dtype=np.int64))
    return common


def sharded_common(hashes_padded: np.ndarray, lengths: np.ndarray, mesh,
                   axis=None, run_block: int = 2048) -> np.ndarray:
    """all_pairs_common over a Mesh (parallel/mesh.py): the incidence
    list is computed once, on the first device (every process of a
    multi-process mesh holds the same DB and computes it too), each
    shard Grams its run-aligned element range (_common_device), and the
    int32 partials add across processes by all_reduce(SUM). `axis` is
    accepted for the JAX package's signature and not read: the mesh has
    one axis."""
    common = _common_device(u64.from_numpy(hashes_padded, mesh.devices[0]),
                            run_block, mesh).contiguous()
    if mesh.group is not None:
        import torch.distributed as tdist

        tdist.all_reduce(common, op=tdist.ReduceOp.SUM, group=mesh.group)
    common = common.cpu().numpy().astype(np.int64)
    np.fill_diagonal(common, np.asarray(lengths, dtype=np.int64))
    return common


# ---------------------------------------------------------------------------
# phase 3: i/j pointer-end counts
# ---------------------------------------------------------------------------

def _below_counts(hashes_padded: np.ndarray, lengths: np.ndarray,
                  thresholds: np.ndarray, side: str = "right") -> np.ndarray:
    """Host: counts[n, t] = number of hashes in sketch n that are <=
    thresholds[t] (side 'right') or strictly below (side 'left').

    One searchsorted of ALL elements into the sorted threshold vector +
    a per-row bin histogram + cumsum. Pads (U64_MAX) land in the
    overflow bin of every threshold and contribute nothing (genuine
    u64::MAX hashes are rejected by callers upstream)."""
    n, k = hashes_padded.shape
    m = len(thresholds)
    order = np.argsort(thresholds, kind="stable")
    sm = thresholds[order]
    flat = hashes_padded.reshape(-1)
    # bin(h) = number of sorted thresholds the element does NOT count
    # toward; it counts toward threshold ranks >= bin(h)
    ss_side = "left" if side == "right" else "right"
    bins = np.searchsorted(sm, flat, ss_side).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    hist = np.bincount(rows * (m + 1) + bins,
                       minlength=n * (m + 1)).reshape(n, m + 1)
    csum = np.cumsum(hist[:, :m].astype(np.int32), axis=1)
    inv = np.empty(m, dtype=np.int64)
    inv[order] = np.arange(m)
    return csum.take(inv, axis=1)


def _below_counts_device(h: torch.Tensor,
                         thresholds: np.ndarray) -> torch.Tensor:
    """counts[n, t] = #{x in row n of `h` : x <= thresholds[t]} (u64
    order), int32 on h's device, queued without a sync.

    The counterpart of the JAX package's `_below_counts_device_sorted`
    and its dispatch, which merge-sort each row with the sorted
    thresholds because a TPU lacks a fast searchsorted: here one batched
    `torch.searchsorted` of the thresholds into each row (rows ascend,
    with U64_MAX pads, the largest value, so pads never count)."""
    n = h.shape[0]
    m = len(thresholds)
    dev = h.device
    tkeys = u64.key(u64.from_numpy(thresholds, dev))
    with record_function("dist.below_counts"):
        hkeys = u64.key(h)
        rows = max(1, _SEARCH_BLOCK // max(1, m))
        counts = torch.empty((n, m), dtype=torch.int32, device=dev)
        for r in range(0, n, rows):
            blk = hkeys[r:r + rows]
            counts[r:r + rows] = torch.searchsorted(
                blk, tkeys.expand(blk.shape[0], m).contiguous(), right=True,
                out_int32=True)
        return counts


def below_counts_device(hashes_padded: np.ndarray, lengths: np.ndarray,
                        thresholds: np.ndarray, device="cuda") -> np.ndarray:
    """Device variant of _below_counts(side='right'); same contract."""
    dev = resolve_device(device)
    return _below_counts_device(u64.from_numpy(hashes_padded, dev),
                                thresholds).cpu().numpy()


def _sketch_maxima(hashes_padded: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
    """Per-sketch largest hash (0 for empty sketches)."""
    return np.array(
        [hashes_padded[i, lengths[i] - 1] if lengths[i] else np.uint64(0)
         for i in range(len(lengths))], dtype=np.uint64)


def _scaled_tail(hashes_padded: np.ndarray, lengths: np.ndarray,
                 scale: float) -> np.ndarray:
    """#{hashes < max_hash} per sketch, the scaled-tail advance
    (distance.rs:99-115)."""
    from finch_tpu_torch.core.distance import scale_recip_max_hash

    max_hash = np.uint64(scale_recip_max_hash(scale))
    return _below_counts(hashes_padded, lengths,
                         np.array([max_hash], dtype=np.uint64),
                         side="left")[:, 0]


def all_pairs_stats(hashes_padded: np.ndarray, lengths: np.ndarray,
                    scale: float = 0.0, run_block: int = 2048,
                    device="cuda"):
    """(common, i, j) int64 (N, N) matrices with raw_distance semantics:
    i[q, r] = #{q's hashes <= min(max_q, max_r)} plus the scaled-tail
    advance past hashes < max_hash (distance.rs:99-115); j = transpose
    role. Self-pairs are included (callers skip them like main.rs:322).

    The Gram and the below counts are both queued on the card (the JAX
    package's device_ij=True form) and fetched after."""
    dev = resolve_device(device)
    lengths = np.asarray(lengths, dtype=np.int64)
    h = u64.from_numpy(hashes_padded, dev)
    common_dev = _common_device(h, run_block)
    maxima = _sketch_maxima(hashes_padded, lengths)
    # below[q, r] = #{q <= max_r}
    below = _below_counts_device(h, maxima).cpu().numpy()
    common = common_dev.cpu().numpy().astype(np.int64)
    np.fill_diagonal(common, lengths)
    # m = min(max_q, max_r): i = #{q <= m} = min(below[q, r], len_q) with
    # the convention that when max_q <= max_r, #{q <= m} = len_q
    i_mat = np.minimum(below, lengths[:, None])
    j_mat = i_mat.T.copy()

    empty = lengths == 0
    if empty.any():
        i_mat[empty, :] = 0
        i_mat[:, empty] = 0
        j_mat[empty, :] = 0
        j_mat[:, empty] = 0

    if scale > 0.0:
        # scaled-tail rule: advance both pointers past hashes strictly
        # below max_hash
        sb = _scaled_tail(hashes_padded, lengths, scale)
        i_mat = np.maximum(i_mat, sb[:, None])   # query side
        j_mat = np.maximum(j_mat, sb[None, :])   # ref side
    return common, i_mat, j_mat


# ---------------------------------------------------------------------------
# survivor compaction on the card: mask + compact the candidate pairs so
# only the survivors, not the (N, N) matrices, cross to the host
# ---------------------------------------------------------------------------

def candidate_mask_consts(k: float, max_distance: float):
    """(j_min_lo f32, eps f32) for the conservative candidate test
    `common >= total * j_min_lo - eps`. mash <= d is monotone in
    jaccard with boundary j_min = e^{-kd} / (2 - e^{-kd}); the margin
    guarantees no exact survivor is dropped in f32 (false positives are
    removed by the exact f64 recheck). ONE definition shared by the host
    prefilter, the device survivors pass, and the equality tests."""
    e = math.exp(-k * max_distance)
    j_min = e / (2.0 - e)
    return np.float32(j_min * (1.0 - 1e-4)), np.float32(1e-3)


def all_pairs_survivors(hashes_padded: np.ndarray, lengths: np.ndarray,
                        scale: float, k: float, max_distance: float,
                        run_block: int = 2048, device="cuda"):
    """(iq, jr, common, i, j) int64 arrays for every candidate pair whose
    mash distance can be <= max_distance (a conservative superset — the
    caller reruns the exact f64 filter), in ref-major/query-minor order.

    Returns None when the workload is out of contract (max_distance >= 1
    keeps everything; a padded length of 2^16 or more; n < 2 or
    n > 2^14, past which the (N, N) matrices outgrow the card; more
    survivors than the cap) — callers take the full-matrix path."""
    n, kpad = hashes_padded.shape
    if (max_distance >= 1.0 or kpad >= (1 << 16) or n < 2
            or n > (1 << 14)):
        return None
    _check_gram_bound(kpad)
    dev = resolve_device(device)
    lengths = np.asarray(lengths, dtype=np.int32)
    maxima = _sketch_maxima(hashes_padded, lengths)
    scaled = scale > 0.0
    j_min_lo, eps = candidate_mask_consts(k, max_distance)
    cap = min(n * n, 1 << 22)

    h = u64.from_numpy(hashes_padded, dev)
    common = _common_device(h, run_block)
    below = _below_counts_device(h, maxima)
    with record_function("dist.survivors"):
        len_t = torch.from_numpy(lengths).to(dev)
        base = torch.minimum(below, len_t[:, None])
        empty = len_t == 0
        base = base.masked_fill(empty[:, None] | empty[None, :], 0)
        if scaled:
            sb = torch.from_numpy(_scaled_tail(
                hashes_padded, lengths, scale).astype(np.int32)).to(dev)
            i_mat = torch.maximum(base, sb[:, None])
            j_mat = torch.maximum(base.T, sb[None, :])
        else:
            i_mat = base
            j_mat = base.T
        cf = common.to(torch.float32)
        tf = (i_mat + j_mat).to(torch.float32) - cf
        keep = cf >= (tf * torch.tensor(j_min_lo, device=dev)
                      - torch.tensor(eps, device=dev))
        keep.fill_diagonal_(False)
        # row-major walk of keep.T: ref-major, query-minor
        pairs = torch.nonzero(keep.T.contiguous())
        if pairs.shape[0] > cap:
            return None
        jr, iq = pairs[:, 0], pairs[:, 1]
        out = torch.stack([iq, jr, common[iq, jr].long(),
                           i_mat[iq, jr].long(), j_mat[iq, jr].long()])
    # the diagonal (sketch sizes) is masked, so c never needs it
    return tuple(out.cpu().numpy())
