"""The port's distance engines (finch_tpu_torch.parallel) against the JAX
package's (finch_tpu.parallel), integer for integer, on the CPU.

Hashes are drawn over the whole u64 range: a compare done in int64 order
instead of u64 order shows only on hashes >= 2^63, and the scaled tail
(scale 0.5 puts half the hash space below max_hash) takes those compares
too. The port's Gram runs with one page and with many small ones (the sum
must not depend on the page cuts)."""

import numpy as np
import pytest
import torch

from finch_tpu.parallel import mxu_dist as jmx
from finch_tpu.parallel import sharded_dist as jsd
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.parallel import mxu_dist as tmx
from finch_tpu_torch.parallel import sharded_dist as tsd

CPU = "cpu"
U64_TOP = np.uint64(2**64 - 1)
POOLS = {"high": 120, "low": 4000, "none": None}


def _db(seed, n, overlap="high", kmax=48, empty=True):
    """n sorted distinct u64 sketches (lengths 1..kmax, one of exactly
    kmax), drawn from a shared pool (or not at all for "none"); a quarter
    of the pool has the top bit set. Optionally one empty sketch last."""
    rng = np.random.default_rng(seed)
    size = POOLS[overlap]
    if size is None:
        pool = rng.integers(0, U64_TOP, size=n * kmax, dtype=np.uint64)
    else:
        pool = rng.integers(0, U64_TOP, size=max(size, kmax),
                            dtype=np.uint64)
    pool[: len(pool) // 4] |= np.uint64(1 << 63)
    pool = rng.permutation(np.unique(pool))
    out = []
    for i in range(n - int(empty)):
        m = kmax if i == 0 else int(rng.integers(1, kmax))
        if size is None:
            out.append(np.sort(pool[i * kmax:i * kmax + m]))
        else:
            out.append(np.sort(rng.choice(pool, size=m, replace=False)))
    if empty:
        out.append(np.empty(0, dtype=np.uint64))
    return out


@pytest.fixture(params=["one_page", "small_pages"])
def run_block(request):
    """The port's Gram page: 2048 runs (every DB here in one page) or 8
    (many pages, each of a few whole runs)."""
    return 2048 if request.param == "one_page" else 8


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("scale", [0.0, 0.5])
@pytest.mark.parametrize("overlap", ["high", "low", "none"])
def test_all_pairs_stats_vs_jax(overlap, scale):
    sk = _db(list(POOLS).index(overlap) + int(10 * scale), 21, overlap)
    H, L = tmx.pack_db(sk)
    real = H[H != U64_TOP]
    assert (real >= np.uint64(1 << 63)).any() and (real < (1 << 63)).any()
    got = tmx.all_pairs_stats(H, L, scale=scale, device=CPU)
    want = jmx.all_pairs_stats(H, L, scale=scale)
    _equal(got, want)
    # the JAX package's below counts on its device give the same stats
    _equal(got, jmx.all_pairs_stats(H, L, scale=scale, device_ij=True))
    if overlap == "high":
        assert (want[0][~np.eye(21, dtype=bool)] > 0).mean() > 0.5


def test_all_pairs_common_gram_forms(run_block):
    sk = _db(7, 21, "high")
    H, L = tmx.pack_db(sk)
    _equal([tmx.all_pairs_common(H, L, run_block=run_block, device=CPU)],
           [jmx.all_pairs_common(H, L)])


@pytest.mark.parametrize("top_bit", [False, True])
def test_run_spanning_pages(top_bit):
    """A hash shared by every sketch makes the longest possible run; with
    a tiny run_block the page cuts must keep every run whole. The shared
    hash lies below or above 2^63."""
    sk = _db(9, 30, "low", kmax=20, empty=False)
    shared = np.uint64(0xF00D_0000_0000_0001 if top_bit
                       else 0x700D_0000_0000_0001)
    sk = [np.sort(np.unique(np.append(s, shared))) for s in sk]
    H, L = tmx.pack_db(sk)
    want = jmx.all_pairs_common(H, L, run_block=4)
    assert (want >= 1).all()
    _equal([tmx.all_pairs_common(H, L, run_block=4, device=CPU)], [want])


def test_page_cuts_keep_runs_whole():
    starts = np.array([0, 3, 5, 9, 10, 14])
    cuts = tmx._page_cuts(starts, 16, 8)
    assert cuts == [(0, 5, 0, 2), (5, 10, 2, 4), (10, 16, 4, 6)]
    with pytest.raises(ValueError):
        tmx._page_cuts(np.array([0, 9]), 12, 8)


@pytest.mark.parametrize("n", [1, 2, 17])
def test_small_n_vs_jax(n, run_block):
    sk = _db(100 + n, n, "high", empty=n > 1)
    H, L = tmx.pack_db(sk)
    _equal(tmx.all_pairs_stats(H, L, run_block=run_block, device=CPU),
           jmx.all_pairs_stats(H, L))
    surv = tmx.all_pairs_survivors(H, L, 0.0, 21.0, 0.9,
                                   run_block=run_block, device=CPU)
    want = jmx.all_pairs_survivors(H, L, 0.0, 21.0, 0.9)
    if n == 1:
        assert surv is None and want is None
    else:
        _equal(surv, want)


def test_identical_and_empty_sketches():
    rng = np.random.default_rng(2)
    s = np.sort(rng.integers(0, U64_TOP, size=80, dtype=np.uint64))
    e = np.empty(0, dtype=np.uint64)
    H, L = tmx.pack_db([s, s.copy(), s[:40], e, e])
    got = tmx.all_pairs_common(H, L, device=CPU)
    _equal([got], [jmx.all_pairs_common(H, L)])
    assert got[0, 1] == 80 and got[0, 2] == 40 and got[3, 4] == 0
    _equal(tmx.all_pairs_stats(H, L, scale=0.5, device=CPU),
           jmx.all_pairs_stats(H, L, scale=0.5))


def test_below_counts_device_vs_jax():
    sk = _db(44, 30, "low")
    H, L = tmx.pack_db(sk)
    maxima = tmx._sketch_maxima(H, L)
    # duplicate thresholds, thresholds equal to elements, 0, and values
    # on both sides of 2^63
    thresholds = np.concatenate([
        maxima, maxima[:3], H[0, :4], np.array([0, 1 << 63, (1 << 63) - 1],
                                               dtype=np.uint64)])
    want = jmx.below_counts_device(H, L, thresholds)
    got = tmx.below_counts_device(H, L, thresholds, device=CPU)
    assert np.array_equal(got, want)
    assert np.array_equal(got, tmx._below_counts(H, L, thresholds))


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_all_pairs_survivors_vs_jax(scale, run_block):
    sk = _db(9, 13, "high", kmax=40)
    H, L = tmx.pack_db(sk)
    for d in (0.05, 0.3, 0.9):
        got = tmx.all_pairs_survivors(H, L, scale, 21.0, d,
                                      run_block=run_block, device=CPU)
        want = jmx.all_pairs_survivors(H, L, scale, 21.0, d)
        _equal(got, want)
        iq, jr = got[0], got[1]
        assert (iq != jr).all()
        key = jr * len(sk) + iq
        assert (np.diff(key) > 0).all()   # ref-major, query-minor
    assert len(got[0]) > 0


def test_all_pairs_survivors_contract():
    rng = np.random.default_rng(10)
    H, L = tmx.pack_db([np.sort(rng.integers(0, U64_TOP, size=8,
                                             dtype=np.uint64))
                        for _ in range(3)])
    # max_distance >= 1 keeps everything: no survivor advantage
    assert tmx.all_pairs_survivors(H, L, 0.0, 21.0, 1.0, device=CPU) is None
    # a single sketch: nothing to pair
    H1, L1 = tmx.pack_db([np.arange(4, dtype=np.uint64)])
    assert tmx.all_pairs_survivors(H1, L1, 0.0, 21.0, 0.5,
                                   device=CPU) is None
    # padded length 2^16: counts no longer fit the contract
    big = np.arange(1 << 16, dtype=np.uint64)
    Hb, Lb = tmx.pack_db([big, big[:5]])
    assert tmx.all_pairs_survivors(Hb, Lb, 0.0, 21.0, 0.5,
                                   device=CPU) is None
    # more than 2^14 sketches
    Hn = np.zeros(((1 << 14) + 1, 1), dtype=np.uint64)
    Ln = np.ones((1 << 14) + 1, dtype=np.int32)
    assert tmx.all_pairs_survivors(Hn, Ln, 0.0, 21.0, 0.5,
                                   device=CPU) is None


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_all_vs_all_arrays_vs_jax(scale, monkeypatch):
    """Query-vs-DB tiles; the port's tile is forced to 4 refs so 17 refs
    take five tiles, the last one partial."""
    db = _db(21, 18, "high", kmax=40)
    queries = db[:3] + [db[-1]]   # an empty query too
    refs = db[1:]
    want = jsd.all_vs_all_arrays(queries, refs, scale=scale)
    monkeypatch.setattr(tsd, "_pick_tile", lambda q, kp: 4)
    got = tsd.all_vs_all_arrays(queries, refs, scale=scale, device=CPU)
    assert all(g.dtype == np.uint64 for g in got)
    _equal(got, want)
    assert (np.asarray(got[0])[0] > 0).sum() > 10


def test_all_vs_all_arrays_edges():
    z = tsd.all_vs_all_arrays([np.arange(3, dtype=np.uint64)], [],
                              device=CPU)
    assert all(m.shape == (1, 0) for m in z)
    with pytest.raises(ValueError, match="sentinel"):
        tsd.all_vs_all_arrays([np.array([1, 2**64 - 1], dtype=np.uint64)],
                              [np.arange(3, dtype=np.uint64)], device=CPU)


def test_device_functions_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    H, L = tmx.pack_db([np.arange(3, dtype=np.uint64)] * 2)
    for call in (lambda: tmx.all_pairs_common(H, L),
                 lambda: tmx.all_pairs_stats(H, L),
                 lambda: tmx.all_pairs_survivors(H, L, 0.0, 21.0, 0.5),
                 lambda: tmx.below_counts_device(H, L, L.astype(np.uint64)),
                 lambda: tsd.all_vs_all_arrays([H[0]], [H[1]])):
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            call()
