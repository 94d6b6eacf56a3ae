"""finch_tpu_torch.core.distance against finch_tpu.core.distance: the
serial engine every device result of the port is held against.

Hashes are drawn over the whole u64 range, so values >= 2^63 (negative as
int64 bit patterns) and the scaled tail below max_hash are both hit."""

import math

import numpy as np
import pytest

from finch_tpu.core import distance as jd
from finch_tpu.core.sketch import LazyKmerCounts as JLazy, Sketch as JSketch
from finch_tpu.errors import FinchError as JFinchError
from finch_tpu.models.params import (FilterParams as JFilters,
                                     SketchParams as JParams)
from finch_tpu_torch.core import distance as td
from finch_tpu_torch.core.sketch import LazyKmerCounts, Sketch
from finch_tpu_torch.errors import FinchError
from finch_tpu_torch.models.params import FilterParams, SketchParams

U64_TOP = np.uint64(2**64 - 1)


def _pairs(seed, n=60):
    """Sorted distinct u64 arrays over the full range, sharing a pool so
    pairs overlap; some empty, some all >= 2^63."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, U64_TOP, size=300, dtype=np.uint64)
    pool[:40] |= np.uint64(1 << 63)
    out = []
    for _ in range(n):
        a, b = (np.sort(np.unique(rng.choice(pool, size=int(rng.integers(
            0, 50))))) for _ in range(2))
        out.append((a, b))
    out.append((np.empty(0, np.uint64), pool[:5].copy()))
    out.append((np.sort(pool[:30]), np.sort(pool[:30])))
    hi = np.sort(pool[:40])
    out.append((hi[::2], hi[1::2]))
    return out


@pytest.mark.parametrize("scale", [0.0, 0.05, 0.5, 0.9])
def test_raw_distance_arrays_full_u64_range(scale):
    cases = _pairs(1)
    assert any(len(a) and a[-1] >= np.uint64(1 << 63) for a, _ in cases)
    for a, b in cases:
        got = td.raw_distance_arrays(a, b, scale)
        assert got == jd.raw_distance_arrays(a, b, scale)
    # the scaled tail advances i/j for these scales
    if scale:
        mh = np.uint64(td.scale_recip_max_hash(scale))
        assert any(((a < mh).sum() > 0) for a, _ in cases)
        assert td.scale_recip_max_hash(scale) == \
            jd.scale_recip_max_hash(scale)


def test_old_distance_arrays_and_degenerate_inputs():
    for a, b in _pairs(2):
        if len(a) == 0 and len(b) > 0:
            with pytest.raises(FinchError):
                td.old_distance_arrays(a, b)
            with pytest.raises(JFinchError):
                jd.old_distance_arrays(a, b)
            continue
        got = td.old_distance_arrays(a, b)
        want = jd.old_distance_arrays(a, b)
        if len(b) == 0:
            assert math.isnan(got[0]) and math.isnan(got[1])
            assert got[2:] == want[2:] == (0, 0)
        else:
            assert got == want


def _sketch(mod, name, hashes, params):
    lazy = LazyKmerCounts if mod == "torch" else JLazy
    sk = Sketch if mod == "torch" else JSketch
    c = np.ones(len(hashes), dtype=np.uint32)
    return sk(name=name, seq_length=0, num_valid_kmers=0, comment="",
              hashes=lazy(hashes, [b""] * len(hashes), c, c),
              filter_params=(FilterParams if mod == "torch"
                             else JFilters)(),
              sketch_params=params)


@pytest.mark.parametrize("kind", ["mash", "scaled"])
def test_distance_matches_jax(kind):
    def params(mod):
        P = SketchParams if mod == "torch" else JParams
        if kind == "mash":
            return P.mash(kmers_to_sketch=50, final_size=50, kmer_length=21)
        return P.scaled(kmers_to_sketch=50, kmer_length=21, scale=0.7)

    for old in (False, True):
        for n, (a, b) in enumerate(_pairs(3)):
            if old and len(a) == 0:
                continue
            got = td.distance(_sketch("torch", "q", a, params("torch")),
                              _sketch("torch", f"r{n}", b, params("torch")),
                              old)
            want = jd.distance(_sketch("jax", "q", a, params("jax")),
                               _sketch("jax", f"r{n}", b, params("jax")),
                               old)
            g, w = got.to_json_dict(), want.to_json_dict()
            if old and len(b) == 0:
                assert math.isnan(g.pop("containment"))
                assert math.isnan(w.pop("containment"))
                g.pop("jaccard"), w.pop("jaccard")
            assert g == w


def test_mash_distance_and_stats_formula():
    for jac in (0.0, 1e-9, 0.3, 1.0, float("nan")):
        assert td.mash_distance_from_jaccard(jac, 21.0) == \
            jd.mash_distance_from_jaccard(jac, 21.0)
    for c, i, j in ((0, 0, 0), (3, 10, 10), (5, 5, 7), (0, 4, 0)):
        assert td.distance_from_stats(c, i, j, 21.0, "q", "r") \
            .to_json_dict() == jd.distance_from_stats(
                c, i, j, 21.0, "q", "r").to_json_dict()


def test_minmer_matrix_matches_jax():
    rng = np.random.default_rng(5)
    ref = np.sort(rng.integers(0, U64_TOP, size=40, dtype=np.uint64))
    sks = []
    for _ in range(6):
        h = np.sort(np.unique(np.concatenate([
            rng.choice(ref, size=10),
            rng.integers(0, U64_TOP, size=5, dtype=np.uint64)])))
        sks.append((h, rng.integers(1, 2**32, size=len(h), dtype=np.uint64)))
    assert np.array_equal(td.minmer_matrix(ref, sks),
                          jd.minmer_matrix(ref, sks))
    assert td.minmer_matrix(ref[:0], sks).shape == (6, 0)
