"""The CUDA kernels (extract, weighted extract, tiers D and D2) against
their plain PyTorch versions on the card.

A CUDA kernel has no interpret mode, so these tests skip without a card;
run them on the GPU with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` (the
repository's conftest imports JAX, which the GPU machine need not have).
chip_smoke.py holds the kernel against the plain version at the main
path's shapes as well. The input builders below take any device, so the
same inputs can be checked on the CPU against the plain versions alone."""

import numpy as np
import pytest
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.ops import dedup, extract
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers

pytestmark = pytest.mark.cuda

MAX = np.uint64(2**64 - 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(v, dev):
    return (u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), dev),
            u64.from_numpy((v >> np.uint64(32)).astype(np.uint32), dev))


def _thresh(dev, frac):
    return torch.tensor([u64.to_i64(min(int(frac * 2**64), 2**64 - 1))],
                        device=dev)


def _random_lanes(k, nch, seed):
    rng = np.random.default_rng(seed + k)
    b = nch * extract.CHUNK
    v = ((rng.integers(0, 4 ** k, size=b, dtype=np.uint64) << np.uint64(1))
         | rng.integers(0, 2, size=b, dtype=np.uint64))
    v[rng.random(b) < 0.03] = MAX
    return v


def _split_by_hash(rng, k, n, th):
    """n random distinct packed k-mers hashing <= th, and n hashing > th."""
    pool = np.unique(rng.integers(0, 4 ** k, size=8 * n, dtype=np.uint64))
    h = u64.to_numpy(hash_packed_kmers(u64.from_numpy(pool), k=k, seed=0))
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    assert len(low) >= n and len(high) >= n
    return low[:n], high[:n]


# survivors per chunk of the edge column: 32 real slab entries over 5
# chunks (aovf 0) and 33 (aovf 1)
EDGE_COUNTS = {"exactly_32": (8, 8, 8, 4, 4), "just_33": (8, 8, 8, 8, 1)}


def edge_lanes(counts, seed=0):
    """Lanes in which only column 5 has survivors (threshold half the hash
    space): counts[c] of them in chunk c, rows 0..counts[c]-1. Chunk 3's
    and chunk 4's survivors repeat chunk 0's first k-mers, so equal slab
    values sit within one merge step (chunks 0-3) and across two (chunk
    4). Returns (lanes, threshold)."""
    k, th = 21, 2**63
    rng = np.random.default_rng(seed)
    nch = len(counts)
    low, high = _split_by_hash(rng, k, 4096, th)
    lanes = high[rng.integers(0, len(high), size=nch * extract.CHUNK)]
    lanes = lanes.reshape(nch, extract.COLH, extract.CHUNK_W)
    for c, n in enumerate(counts):
        lanes[c, :n, 5] = low[:n] if c >= 3 else low[8 * c:8 * c + n]
    return (lanes.reshape(-1) << np.uint64(1)), th


@pytest.mark.parametrize("k,seed,nch,frac", [
    (21, 0, 4, 0.004), (28, 42, 1, 1.0), (1, 0, 2, 0.5),
    # the 4-base word assembly and the murmur tail (T = K mod 16: 4, 5,
    # 0, 1, 9), on 1, 3 and 5 chunks (a merge step past the slab's end)
    (4, 0, 3, 0.5), (5, 7, 1, 0.3), (16, 0, 5, 0.01), (17, 42, 3, 0.05),
    (25, 0, 5, 0.002),
])
def test_kernel_matches_plain(cuda, k, seed, nch, frac):
    vlo, vhi = _planes(_random_lanes(k, nch, 0), cuda)
    th = _thresh(cuda, frac)
    before = extract.extract_candidates.launches
    got = extract.extract_candidates(vlo, vhi, th, k=k, seed=seed)
    torch.cuda.synchronize()
    assert extract.extract_candidates.launches == before + 1
    want = extract.extract_candidates_plain(vlo, vhi, th, k=k, seed=seed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case,aovf", [("exactly_32", 0), ("just_33", 1)])
def test_kernel_column_edges(cuda, case, aovf):
    lanes, th = edge_lanes(EDGE_COUNTS[case])
    vlo, vhi = _planes(lanes, cuda)
    tt = torch.tensor([u64.to_i64(th)], device=cuda)
    got = extract.extract_candidates(vlo, vhi, tt, k=21, seed=0)
    torch.cuda.synchronize()
    want = extract.extract_candidates_plain(vlo, vhi, tt, k=21, seed=0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (int(got[4]), int(got[5])) == (0, aovf)


def _lanes(cuda, k, nch, dup, shuffle, seed=0):
    rng = np.random.default_rng(seed)
    b = nch * extract.CHUNK
    v = ((rng.integers(0, 4 ** k, size=b // dup, dtype=np.uint64)
          << np.uint64(1)) | rng.integers(0, 2, size=b // dup,
                                          dtype=np.uint64))
    v = np.tile(v, dup)
    if shuffle:
        v = v[rng.permutation(b)]
    v[-37:] = MAX
    return _planes(v, cuda)


@pytest.mark.parametrize("k,nch,dup,shuffle,frac", [
    (21, 4, 64, False, 0.05),   # stride-aligned copies: absorbed
    (21, 8, 1, False, 0.3),     # more than 32 distinct per column
    (25, 2, 4, True, 1.0),      # cold, scattered copies
])
def test_weighted_kernel_matches_plain(cuda, k, nch, dup, shuffle, frac):
    vlo, vhi = _lanes(cuda, k, nch, dup, shuffle)
    th = _thresh(cuda, frac)
    before = extract.extract_candidates.launches_weighted
    got = extract.extract_candidates(vlo, vhi, th, k=k, seed=0,
                                     weighted=True)
    torch.cuda.synchronize()
    assert extract.extract_candidates.launches_weighted == before + 1
    want = extract.extract_candidates_plain(vlo, vhi, th, k=k, seed=0,
                                            weighted=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# per chunk, the survivors of the edge column as indices into the sorted
# survivor pool (rows 0.. of the chunk); 16 chunks, 4 merge steps, and the
# weighted flag aovf
WEIGHTED_SYNTHETIC = {
    # 32 distinct values, 8 a chunk: copies within a step and across steps
    "distinct_32": ([[(5 * i + j) % 32 + 1 for j in range(8)]
                     for i in range(16)], 0),
    # the same, and in the last chunk a 33rd value below them all: the
    # largest held value (and its count) drops out in a sorted merge
    "distinct_33": ([[(5 * i + j) % 32 + 1 for j in range(8)]
                     for i in range(15)] + [[0] + list(range(12, 19))], 1),
    # a full list, then one smaller value (inserted: the largest drops
    # out, the only cause of aovf) and copies of held values
    "insert_push": ([list(range(1 + 8 * i, 9 + 8 * i)) for i in range(4)]
                    + [[0], [], [], [], [5, 5, 6]] + [[]] * 6 + [[1]], 1),
    # a full list, then a larger value (refused: the only cause of aovf)
    # and copies of held values
    "refused": ([list(range(8 * i, 8 * i + 8)) for i in range(4)]
                + [[40], [], [], [], [3, 3]] + [[]] * 7, 1),
    # a held value gains copies, is pushed out in the same step, and
    # returns in two later steps
    "pushed_out_returns": ([[40] + list(range(7)), list(range(7, 15)),
                            list(range(15, 23)), [40],
                            list(range(23, 31)), [31, 32, 33], [40, 5, 5],
                            [], [40], [], [], [], [40, 3], [], [], []], 1),
}


def weighted_synthetic(case, dev):
    """Lanes in which only columns 5 and 2046 have survivors (threshold
    half the hash space), per chunk as WEIGHTED_SYNTHETIC lists them.
    Returns (vlo, vhi, thresh, aovf)."""
    chunks, aovf = WEIGHTED_SYNTHETIC[case]
    k, th = 21, 2**63
    rng = np.random.default_rng(3)
    low, high = _split_by_hash(rng, k, 4096, th)
    low = np.sort(low)
    lanes = high[rng.integers(0, len(high), size=len(chunks) * extract.CHUNK)]
    lanes = lanes.reshape(len(chunks), extract.COLH, extract.CHUNK_W)
    for c, idx in enumerate(chunks):
        for col in (5, 2046):
            lanes[c, :len(idx), col] = low[idx]
    vlo, vhi = _planes(lanes.reshape(-1) << np.uint64(1), dev)
    return vlo, vhi, torch.tensor([u64.to_i64(th)], device=dev), aovf


@pytest.mark.parametrize("case", sorted(WEIGHTED_SYNTHETIC))
def test_weighted_kernel_edges(cuda, case):
    vlo, vhi, th, aovf = weighted_synthetic(case, cuda)
    got = extract.extract_candidates(vlo, vhi, th, k=21, seed=0,
                                     weighted=True)
    torch.cuda.synchronize()
    want = extract.extract_candidates_plain(vlo, vhi, th, k=21, seed=0,
                                            weighted=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (int(got[4]), int(got[5])) == (0, aovf)


@pytest.mark.parametrize("k,nch,dup,shuffle,frac", [
    (21, 2, 64, False, 1.0),    # a cold burst: D holds it
    (21, 4, 1, False, 1.0),     # cold and distinct: dovf
    (15, 3, 8, True, 0.2),
])
def test_dedup_kernel_matches_plain(cuda, k, nch, dup, shuffle, frac):
    vlo, vhi = _lanes(cuda, k, nch, dup, shuffle)
    th = _thresh(cuda, frac)
    ex = extract.extract_candidates_plain(vlo, vhi, th, k=k, seed=0)
    before = dedup.dedup_candidates.launches
    got = dedup.dedup_candidates(vlo, vhi, ex[2], ex[3], th, k=k)
    torch.cuda.synchronize()
    assert dedup.dedup_candidates.launches == before + 1
    want = dedup.dedup_candidates_plain(vlo, vhi, ex[2], ex[3], th, k=k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def synthetic_slab(groups, seed=0):
    """A slab (len(groups) x 32 rows of CHUNK_W columns, u64 as int64
    numpy) built group by group. Each group is None (every row u64::MAX),
    ("pool", n, p) (n of its 32 rows per column drawn from the column's p
    pool values, in turn, so that the pool fills over the groups),
    ("fresh", n) (n new distinct values per column, below every pool
    value) or ("copies", n) (n copies of one new value, below every pool
    value)."""
    rng = np.random.default_rng(seed)
    rows, w = 32, extract.CHUNK_W
    col = np.arange(w, dtype=np.uint64)[None, :] << np.uint64(40)
    out = np.full((len(groups) * rows, w), MAX, dtype=np.uint64)
    drawn = 0
    fresh = 0
    for g, spec in enumerate(groups):
        if spec is None:
            continue
        block = np.full((rows, w), MAX, dtype=np.uint64)
        n = spec[1]
        pick = np.argsort(rng.random((rows, w)), axis=0)[:n]
        if spec[0] == "pool":
            idx = (drawn + np.arange(n)) % spec[2]
            vals = (np.uint64(1 << 20) + idx.astype(np.uint64))[:, None]
            drawn += n
        elif spec[0] == "fresh":
            vals = (np.uint64(1) + fresh + np.arange(n, dtype=np.uint64))[
                :, None]
            fresh += n
        else:
            vals = np.full((n, 1), np.uint64(1 + fresh), dtype=np.uint64)
            fresh += 1
        np.put_along_axis(block, pick, col + vals, axis=0)
        out[g * rows:(g + 1) * rows] = block
    return out.reshape(-1).view(np.int64)


# (slab groups, d2ovf)
D2_SYNTHETIC = {
    # u64::MAX groups between real ones, the last step empty: the output
    # is the compacted layout, no holes; the fourth step holds 3 copies
    # of each of 8 values already held
    "max_groups": ([("pool", 12, 30), None, None, ("pool", 24, 8), None],
                   0),
    # 70 heads by the fifth step, no step over 95 rows; the last step's
    # 32 fresh values push the largest heads past row 95
    "ovf_last": ([("pool", 20, 70)] * 5 + [("fresh", 32)], 1),
    # 32 fresh values a step: 96 heads after three steps, so the fourth
    # step, the earliest that can, overflows, and every later one
    "ovf_earliest": ([("fresh", 32)] * 6, 1),
    # 85 heads, then two steps of 8 copies: neither step reaches row 96,
    # though one pass over both would (16 rows below 85 heads)
    "near_full": ([("pool", 30, 85)] * 3 + [("copies", 8)] * 2
                  + [None] * 3, 0),
}


@pytest.mark.parametrize("nch,dup,shuffle,frac", [
    (4, 4, False, 0.02),        # one step
    (8, 8, True, 0.05), (16, 1, False, 0.2),
    (96, 16, True, 0.05),       # 24 steps: longer than the ring's 16
])
def test_dedup_slab_kernel_matches_plain(cuda, nch, dup, shuffle, frac):
    vlo, vhi = _lanes(cuda, 21, nch, dup, shuffle)
    slab = extract.extract_candidates_plain(vlo, vhi, _thresh(cuda, frac),
                                            k=21, seed=0)[1]
    before = dedup.dedup_slab_candidates.launches
    got = dedup.dedup_slab_candidates(slab, k=21)
    torch.cuda.synchronize()
    assert dedup.dedup_slab_candidates.launches == before + 1
    want = dedup.dedup_slab_candidates_plain(slab, k=21)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(D2_SYNTHETIC))
def test_dedup_slab_kernel_edges(cuda, case):
    groups, ovf = D2_SYNTHETIC[case]
    slab = torch.from_numpy(synthetic_slab(groups)).to(cuda)
    got = dedup.dedup_slab_candidates(slab, k=21)
    torch.cuda.synchronize()
    want = dedup.dedup_slab_candidates_plain(slab, k=21)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1]) == ovf


# tier D's edge cases, one D2_SYNTHETIC-style group per chunk: (groups,
# dovf)
D_SYNTHETIC = {
    **D2_SYNTHETIC,
    # 27 chunks, longer than the ring's 16: 22 dense steps of two copies
    # of each of the 16 held values, u64::MAX chunks, 8 copies of a new
    # value, and a last chunk with no survivor
    "ring_copies": ([("pool", 32, 16)] * 22
                    + [None, ("copies", 8), None, ("pool", 3, 16), None], 0),
    # 64 heads, a dense step of their copies (rows up to 95), 12 new
    # values waiting, then copies again: that step's rows pass 95 and the
    # largest heads drop, though every value is a copy of a head
    "hits_past_96": ([("pool", 32, 64)] * 3
                     + [("fresh", 12), ("pool", 32, 64), None], 1),
}


def lanes_from_slab(slab, th, seed=0):
    """Tier D lanes whose survivors are a synthetic slab's real entries:
    a lane is the slab value - 1 with a hash at or below th (a tenth of
    them exactly th). Any other lane is padding (both planes all-ones; a
    third of them, with hashes at or below th too) or a random value whose
    hash is above th (a tenth of them exactly th + 1). Returns the value
    and hash planes as u64 numpy arrays."""
    rng = np.random.default_rng(seed)
    real = slab != MAX
    n = slab.size
    low_h = rng.integers(0, th, size=n, dtype=np.uint64, endpoint=True)
    low_h[rng.random(n) < 0.1] = np.uint64(th)
    high_h = rng.integers(th + 1, 2**64 - 1, size=n, dtype=np.uint64,
                          endpoint=True)
    high_h[rng.random(n) < 0.1] = np.uint64(th + 1)
    pad = ~real & (rng.random(n) < 0.3)
    v = np.where(real, slab - np.uint64(1),
                 rng.integers(0, 2**62, size=n, dtype=np.uint64))
    v[pad] = MAX
    h = np.where(real | (pad & (rng.random(n) < 0.5)), low_h, high_h)
    return v, h


def d_synthetic(case, dev):
    """The planes and threshold of a D_SYNTHETIC case, and its dovf."""
    groups, ovf = D_SYNTHETIC[case]
    th = 2**63 + 12345
    v, h = lanes_from_slab(synthetic_slab(groups).view(np.uint64), th)
    vlo, vhi = _planes(v, dev)
    hlo, hhi = _planes(h, dev)
    return vlo, vhi, hlo, hhi, torch.tensor([u64.to_i64(th)], device=dev), ovf


@pytest.mark.parametrize("case", sorted(D_SYNTHETIC))
def test_dedup_kernel_edges(cuda, case):
    vlo, vhi, hlo, hhi, th, ovf = d_synthetic(case, cuda)
    got = dedup.dedup_candidates(vlo, vhi, hlo, hhi, th, k=21)
    torch.cuda.synchronize()
    want = dedup.dedup_candidates_plain(vlo, vhi, hlo, hhi, th, k=21)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1]) == ovf


# ---------------------------------------------------------------------------
# the distance path's device phases (library calls, no kernel of the
# port's): each on the card against the same function on the CPU
# ---------------------------------------------------------------------------

def _dist_db(seed, n, kmax=64, pool=3000):
    """n sorted distinct sketches over a shared full-range u64 pool, a
    third of it >= 2^63; lengths 1..kmax, one of exactly kmax."""
    rng = np.random.default_rng(seed)
    p = np.unique(rng.integers(0, 2**64 - 1, size=max(pool, kmax),
                               dtype=np.uint64))
    p[: len(p) // 3] |= np.uint64(1 << 63)
    p = np.unique(p)
    return [np.sort(rng.choice(p, size=kmax if i == 0 else
                               int(rng.integers(1, kmax)), replace=False))
            for i in range(n)]


@pytest.mark.parametrize("run_block", [2048, 8])
@pytest.mark.parametrize("n", [1, 2, 15, 17, 1000])
def test_gram_padding(cuda, n, run_block):
    """torch._int_mm's shape rules (rows > 16, multiples of 8) are met by
    padding E, on one page or on many pages of a few runs each."""
    from finch_tpu_torch.parallel import mxu_dist

    H, L = mxu_dist.pack_db(_dist_db(n, n, pool=100 if n < 20 else 3000))
    got = mxu_dist.all_pairs_common(H, L, run_block=run_block, device="cuda")
    want = mxu_dist.all_pairs_common(H, L, device="cpu")
    assert np.array_equal(got, want)
    if n >= 15:
        assert (want[~np.eye(n, dtype=bool)] > 0).any()


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_stats_above_2_63(cuda, scale):
    """i/j and the scaled tail order hashes >= 2^63 as u64 on the card."""
    from finch_tpu_torch.parallel import mxu_dist

    H, L = mxu_dist.pack_db(_dist_db(3, 40) + [np.empty(0, np.uint64)])
    assert (H[H != MAX] >= np.uint64(1 << 63)).mean() > 0.2
    want = mxu_dist.all_pairs_stats(H, L, scale=scale, device="cpu")
    got = mxu_dist.all_pairs_stats(H, L, scale=scale, device="cuda")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    th = np.concatenate([mxu_dist._sketch_maxima(H, L), H[0, :5],
                         np.array([0, 1 << 63], dtype=np.uint64)])
    assert np.array_equal(mxu_dist.below_counts_device(H, L, th,
                                                       device="cuda"),
                          mxu_dist._below_counts(H, L, th))


def test_survivors_order(cuda):
    """The survivors' rows on the card equal the CPU's, in ref-major
    order (compared after the exact f64 recheck: the f32 candidate test
    may round differently on the two devices)."""
    from finch_tpu_torch import cli
    from finch_tpu_torch.parallel import mxu_dist

    sk = _dist_db(4, 300, kmax=48, pool=400)
    H, L = mxu_dist.pack_db(sk)
    names = [f"s{i}" for i in range(len(sk))]
    for d in (0.1, 0.3):
        rows = {}
        for dev in ("cuda", "cpu"):
            iq, jr, c, i, j = mxu_dist.all_pairs_survivors(
                H, L, 0.0, 21.0, d, device=dev)
            assert (np.diff(jr * len(sk) + iq) > 0).all()
            r = cli._finish_gram_rows(c, i, j, iq, jr, names, 21.0, d)
            rows[dev] = (r._iq, r._jr, r._common, r._total, r._mash)
        for g, w in zip(rows["cuda"], rows["cpu"]):
            assert np.array_equal(g, w)
        assert len(rows["cuda"][0]) > 0


def test_tile_engine_partial_tile(cuda):
    """Query-vs-DB tiles on the card: 16 queries of 64-hash sketches give
    a 4096-ref tile, and 10,001 refs end in a partial one."""
    from finch_tpu_torch.parallel import sharded_dist

    db = _dist_db(5, 10_001, kmax=64, pool=20_000)
    queries = db[:15] + [np.empty(0, np.uint64)]
    assert sharded_dist._pick_tile(16, 64) == 4096
    for scale in (0.0, 0.5):
        got = sharded_dist.all_vs_all_arrays(queries, db, scale=scale,
                                             device="cuda")
        want = sharded_dist.all_vs_all_arrays(queries, db, scale=scale,
                                              device="cpu")
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


# --- the wide step (32 <= k <= 63): PyTorch calls only, card vs CPU ---

def _wide_batches(k, nbatch, b, seed):
    rng = np.random.default_rng(seed + k)
    pool_lo = rng.integers(0, 2**64, size=b, dtype=np.uint64)
    pool_hi = rng.integers(0, 2 ** (2 * k - 64), size=b, dtype=np.uint64)
    for _ in range(nbatch):
        idx = rng.integers(0, b, size=b - 12345)  # runs; a padded tail
        yield ((pool_lo[idx], pool_hi[idx]),
               rng.integers(0, 2, size=len(idx), dtype=np.uint8))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("k", [32, 51, 63])
def test_wide_step_card_equals_cpu(cuda, k, scaled):
    """TorchEngine's wide step on 2M-lane batches: the raw state (pads
    included) and the capacity after every batch equal the CPU's; the
    scaled case grows its state."""
    from finch_tpu_torch.models.engine import TorchEngine
    from finch_tpu_torch.models.params import SketchParams
    from finch_tpu_torch.ops import bottomk_wide

    params = (SketchParams.scaled(kmers_to_sketch=1000, scale=0.01,
                                  kmer_length=k) if scaled else
              SketchParams.mash(kmers_to_sketch=200_000, final_size=1000,
                                kmer_length=k, no_strict=True))
    engines = [TorchEngine(params, device=d) for d in (cuda, "cpu")]
    cap0 = engines[0].capacity
    for packed, rc in _wide_batches(k, 2, 1 << 21, 5):
        for e in engines:
            e.update(packed, rc)
        got, want = (bottomk_wide.state_to_numpy(e.state) for e in engines)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert engines[0].capacity == engines[1].capacity
    assert engines[0].stats["wide"] >= 2
    if scaled:
        assert engines[0].capacity > cap0


def test_hybrid_wide_migrates_on_card(cuda, monkeypatch):
    """HybridEngine at k = 51 on a cold card (the warm record cleared for
    the test: earlier tests stepped on the card) takes the cold switch
    point, 4M k-mers: it folds the first 2M-lane batches on the host, then
    migrates onto the card's wide step; its sketch equals NumpyEngine's on
    the same batches."""
    from finch_tpu_torch.models import engine
    from finch_tpu_torch.models.engine import HybridEngine, NumpyEngine
    from finch_tpu_torch.models.params import SketchParams

    monkeypatch.setattr(engine, "_warm_cards", set())

    params = SketchParams.mash(kmers_to_sketch=1000, final_size=1000,
                               kmer_length=51, no_strict=True)
    hyb, host = HybridEngine(params, device=cuda), NumpyEngine(params)
    for i, (packed, rc) in enumerate(_wide_batches(51, 4, 1 << 21, 9)):
        hyb.update(packed, rc)
        host.update(packed, rc)
        assert (hyb._dev is not None) == (i >= 2)
    assert hyb._dev.device.type == "cuda" and hyb.stats["wide"] == 1
    got, want = hyb.finalize_arrays(), host.finalize_arrays()
    for a, b in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        np.testing.assert_array_equal(a, b)


def _isolate_fastq(path, reads=60_000, genome=300_000, seed=4):
    """`reads` 150 bp reads of a random genome (30x at the defaults),
    half reverse-complemented, Phred 40: about 7.8M 21-mers in some five
    parse batches, so that the cold switch point falls before the last,
    with every k-mer seen many times."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=genome, dtype=np.uint8)
    starts = rng.integers(0, genome - 150, size=reads)
    seqs = g[starts[:, None] + np.arange(150)]
    rev = rng.random(reads) < 0.5
    seqs[rev] = 3 - seqs[rev, ::-1]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)[seqs]
    qual = b"I" * 150
    with open(path, "wb") as f:
        for i, row in enumerate(bases):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, row.tobytes(), qual))
    return str(path)


def test_auto_second_sketch_starts_on_the_warm_card(cuda, monkeypatch,
                                                     tmp_path):
    """In one process, from a cleared warm record: auto's first sketch of
    a 7.8M-k-mer FASTQ folds on the host to the cold switch point and
    migrates; its card steps make the card warm, so the second sketch of
    the same file folds nothing on the host and opens engine.warm_start
    once. Both .sk byte strings equal native's."""
    from finch_tpu_torch.core.sketching import sketch_stream
    from finch_tpu_torch.models import engine
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes
    from finch_tpu_torch.tools.switch_point import cli_params
    from finch_tpu_torch.utils import get_meter

    monkeypatch.setattr(engine, "_warm_cards", set())
    fq = _isolate_fastq(tmp_path / "isolate.fq")
    params, filters = cli_params(fq, 21)
    spans = ("engine.host_fold", "engine.warm_start", "engine.migrate")

    def sketch(backend):
        before = {n: get_meter(n).calls for n in spans}
        engines = []
        sk = sketch_stream(fq, fq, params, filters, backend=backend,
                           device="cuda", engine_out=engines)
        opened = {n: get_meter(n).calls - before[n] for n in spans}
        return multisketch_to_json_bytes([sk]), sk, opened, engines

    want, sk, _, _ = sketch("native")
    assert sk.num_valid_kmers > 4 << 20 and len(sk.hashes) == 1000
    assert not engine.card_is_warm(cuda)
    first, _, opened, engines = sketch("auto")
    assert opened["engine.host_fold"] >= 2 and opened["engine.migrate"] == 1
    assert opened["engine.warm_start"] == 0 and engines[0]._dev is not None
    assert engine.card_is_warm(cuda)
    second, _, opened, engines = sketch("auto")
    assert opened == {"engine.host_fold": 0, "engine.warm_start": 1,
                      "engine.migrate": 1}
    assert engines[0]._dev is not None
    assert first == second == want


# --- the slot path (k <= 31) ---

def test_slots_are_pinned_and_wait_for_their_copy(cuda, monkeypatch):
    """TorchEngine's slots are pinned on the card; HybridEngine's are
    pinned on a warm card, and on a cold one plain until its stream is on
    the card and pinned after. The ring hands a slot out only once the
    copy behind its event has finished: here every copy queues behind a
    10 ms device sleep, so the slots come back before their copies would
    have ended."""
    from finch_tpu_torch.models import engine as eng
    from finch_tpu_torch.models.engine import (SLOTS, HybridEngine,
                                               SlotRing, TorchEngine)
    from finch_tpu_torch.models.params import SketchParams

    params = SketchParams.mash(kmers_to_sketch=1000, final_size=1000)
    assert TorchEngine(params, device=cuda).next_slot().planes.is_pinned()
    monkeypatch.setattr(eng, "card_is_warm", lambda dev: False)
    hyb = HybridEngine(params, device=cuda)
    assert not hyb.next_slot().planes.is_pinned()
    hyb._migrate()
    assert hyb.next_slot().planes.is_pinned()
    hyb.finalize_arrays()
    monkeypatch.setattr(eng, "card_is_warm", lambda dev: True)
    hyb = HybridEngine(params, device=cuda)
    assert hyb.next_slot().planes.is_pinned()
    hyb.finalize_arrays()

    ring = SlotRing(1 << 21, pinned=True)
    dst = torch.empty(1 << 21, dtype=torch.int32, device=cuda)
    for _ in range(4 * SLOTS):
        slot = ring.take()
        assert slot.copied is None or slot.copied.query()
        torch.cuda._sleep(20_000_000)
        dst.copy_(slot.planes[0], non_blocking=True)
        if slot.copied is None:
            slot.copied = torch.cuda.Event()
        slot.copied.record()
    torch.cuda.synchronize()


def test_slot_path_sk_equals_update_path(cuda, monkeypatch, tmp_path):
    """The same 7.8M-k-mer FASTQ through TorchEngine twice: the reader
    parsing into its pinned slots (every step a slot step), and the
    staged `update` path (the engine told to take none). Equal .sk
    bytes."""
    from finch_tpu_torch.core import sketching
    from finch_tpu_torch.models.engine import TorchEngine
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes
    from finch_tpu_torch.tools.switch_point import cli_params
    from finch_tpu_torch.utils import get_meter

    fq = _isolate_fastq(tmp_path / "isolate.fq")
    params, filters = cli_params(fq, 21)

    def sketch(slots: bool):
        def make(sketch_params, backend, batch_size, device):
            e = TorchEngine(sketch_params, batch_size=batch_size,
                            device=device)
            e.takes_slots = slots
            return e

        monkeypatch.setattr(sketching, "_make_engine", make)
        engines = []
        before = get_meter("engine.step").calls
        sk = sketching.sketch_stream(fq, fq, params, filters,
                                     backend="torch", device="cuda",
                                     engine_out=engines)
        steps = get_meter("engine.step").calls - before
        return (multisketch_to_json_bytes([sk]),
                engines[0].stats.get("slot_steps", 0), steps)

    staged, none, _ = sketch(False)
    slotted, slot_steps, steps = sketch(True)
    assert none == 0 and slot_steps == steps >= 4
    assert slotted == staged


# --- the mesh: logical shards on one card ---

@pytest.mark.parametrize("scheme", ["mash", "scaled"])
def test_two_shard_mesh_equals_torch_engine(cuda, scheme):
    """ShardedSketchEngine over 2 logical shards on the card (1M lanes
    each: the kernels run on both) finalizes to TorchEngine's sketch on
    the same 2M-lane batches."""
    from finch_tpu_torch.models.engine import TorchEngine
    from finch_tpu_torch.models.params import SketchParams
    from finch_tpu_torch.parallel import Mesh, ShardedSketchEngine

    params = (SketchParams.scaled(kmers_to_sketch=1000, scale=0.01)
              if scheme == "scaled" else
              SketchParams.mash(kmers_to_sketch=200_000, final_size=1000))
    mesh = Mesh([cuda, cuda])
    sharded = ShardedSketchEngine(params, mesh, batch_size_per_device=1 << 20)
    single = TorchEngine(params, device=cuda)
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 4 ** 21, size=1 << 20, dtype=np.uint64)
    for _ in range(3):
        pk = pool[rng.integers(0, len(pool), size=1 << 21)]  # duplicates
        rc = rng.integers(0, 2, size=1 << 21, dtype=np.uint8)
        sharded.update(pk, rc)
        single.update(pk, rc)
    torch.cuda.synchronize()
    for a, b in zip(sharded.finalize_arrays(), single.finalize_arrays()):
        np.testing.assert_array_equal(a, b)
    steps = sum(sharded.stats.get(f"tier_{t}", 0)
                for t in ("A", "D2", "B", "D", "C"))
    assert steps >= 6   # every shard step took the kernel path


def test_four_shard_lockstep_mesh_equals_torch_engine(cuda):
    """4 logical shards of 512k lanes on the card step in lockstep (one
    host wait a round for every shard's read): the sketch is
    TorchEngine's on the same 2M-lane batches, with fewer host syncs than
    the shards made reads."""
    from finch_tpu_torch.models.engine import TorchEngine
    from finch_tpu_torch.models.params import SketchParams
    from finch_tpu_torch.parallel import Mesh, ShardedSketchEngine

    params = SketchParams.mash(kmers_to_sketch=200_000, final_size=1000)
    sharded = ShardedSketchEngine(params, Mesh([cuda] * 4),
                                  batch_size_per_device=1 << 19)
    single = TorchEngine(params, device=cuda)
    rng = np.random.default_rng(22)
    pool = rng.integers(0, 4 ** 21, size=1 << 20, dtype=np.uint64)
    for i in range(4):
        pk = (pool[rng.integers(0, len(pool), size=1 << 21)] if i % 2
              else rng.integers(0, 4 ** 21, size=1 << 21, dtype=np.uint64))
        rc = rng.integers(0, 2, size=1 << 21, dtype=np.uint8)
        sharded.update(pk, rc)
        single.update(pk, rc)
    torch.cuda.synchronize()
    for a, b in zip(sharded.finalize_arrays(), single.finalize_arrays()):
        np.testing.assert_array_equal(a, b)
    stats = sharded.stats
    assert sum(stats.get(f"tier_{t}", 0)
               for t in ("A", "D2", "B", "D", "C")) == 16
    assert stats["syncs"] < stats["shard_reads"]
