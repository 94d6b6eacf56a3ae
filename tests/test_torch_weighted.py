"""The weighted (duplicate-absorbing) extract of ops/extract.py, plain
PyTorch version, against the Pallas TPU kernel it replaces
(``_extract_kernel`` weighted=True) in interpret mode on the CPU.

Integers throughout, so the tolerance is 0: cand must be equal entry for
entry, also when aovf is set (the sketch's adaptive-absorb hint reads it
then), the slab must equal the unweighted form's, and the flags must be
equal. Mirrors test_pallas_extract.py's weighted tests at two chunks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import pallas_extract as pe
from finch_tpu_torch import native, u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops import extract

torch.set_num_threads(2)

U64_MAX = np.uint64(2**64 - 1)
CHUNK = extract.CHUNK
CHUNK_W = extract.CHUNK_W


def _planes(comp):
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def _both(comp, th, k, seed=0):
    """(Pallas outputs, port outputs) of the weighted extract, as numpy."""
    lo, hi = _planes(comp)
    j = pe.extract_candidates(
        jnp.asarray(lo), jnp.asarray(hi), jnp.uint32(th >> 32),
        jnp.uint32(th & 0xFFFFFFFF), k=k, seed=seed, interpret=True,
        weighted=True)
    p = extract.extract_candidates(
        u64.from_numpy(lo), u64.from_numpy(hi),
        torch.tensor([u64.to_i64(th)]), k=k, seed=seed, weighted=True)
    return ([np.asarray(x) for x in j[:4]] + [int(j[4]), int(j[5])],
            [u64.to_numpy(x) for x in p[:4]] + [int(p[4]), int(p[5])])


def _absorb_case(k):
    """Two chunks holding the same distinct values (cross-chunk copies in
    one column), 100 in-chunk same-column copies and padding lanes."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 4 ** k, size=CHUNK, dtype=np.uint64)
    v = np.tile(vals, 2)
    comp = (v << np.uint64(1)) | (v & np.uint64(1))
    comp[CHUNK_W:CHUNK_W + 100] = comp[:100]
    comp[-29:] = U64_MAX
    return comp


@pytest.mark.parametrize("k", [21, 15, 25])
def test_weighted_plain_matches_pallas(k):
    comp = _absorb_case(k)
    th = int(0.05 * 2**64)
    j, p = _both(comp, th, k)
    assert j[4:] == [0, 0] and p[4:] == j[4:]
    assert np.array_equal(p[0], j[0])
    # the weighted form changes only cand: the slab is the unweighted one
    lo, hi = _planes(comp)
    unw = extract.extract_candidates(
        u64.from_numpy(lo), u64.from_numpy(hi),
        torch.tensor([u64.to_i64(th)]), k=k, seed=0)
    assert np.array_equal(p[1], u64.to_numpy(unw[1]))
    assert np.array_equal(p[1], j[1])
    # every cross-chunk copy was absorbed into a weight field
    shift = np.uint64(2 * k + 2)
    real = p[0][p[0] != U64_MAX]
    assert np.any((real >> shift) > 0)


def test_weighted_distinct_matches_unweighted():
    """Duplicate-free lanes: weighted cand == unweighted cand (all weight
    fields zero), on both sides."""
    rng = np.random.default_rng(19)
    packed = np.unique(rng.permutation(np.arange(CHUNK, dtype=np.uint64)
                                       * np.uint64(65537))
                       % np.uint64(4 ** 21))
    v = np.full(CHUNK, U64_MAX, dtype=np.uint64)
    v[:len(packed)] = packed << np.uint64(1)
    rng.shuffle(v)
    th = int(0.01 * 2**64)
    j, p = _both(v, th, 21)
    assert j[4:] == p[4:] == [0, 0]
    assert np.array_equal(p[0], j[0])
    lo, hi = _planes(v)
    unw = extract.extract_candidates(
        u64.from_numpy(lo), u64.from_numpy(hi),
        torch.tensor([u64.to_i64(th)]), k=21, seed=0)
    assert np.array_equal(p[0], u64.to_numpy(unw[0]))


def test_weighted_overflow_output_matches_pallas():
    """aovf = 1: five chunks whose columns 0..3 each get 8 distinct
    survivors per chunk (40 distinct over the batch, more than the 32
    kept), while columns 4..7 get one value 40 times (absorbed, no
    overflow). cand must still equal the TPU kernel's entry for entry."""
    k, seed = 21, 0
    rng = np.random.default_rng(99)
    nch = 5
    th = int(0.002 * 2**64)
    pool = np.unique(rng.integers(0, 4 ** k, size=1 << 17, dtype=np.uint64))
    h = native.murmur3_packed(pool, k, seed)
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    packed = high[rng.integers(0, len(high), size=nch * CHUNK)]
    lanes = packed.reshape(nch, extract.COLH, CHUNK_W)
    lanes[:, :8, :4] = low[:nch * 8 * 4].reshape(nch, 8, 4)
    lanes[:, :8, 4:8] = low[-4:][None, None, :]
    comp = packed << np.uint64(1)
    j, p = _both(comp, th, k, seed)
    assert j[4:] == [0, 1] and p[4:] == j[4:]
    assert np.array_equal(p[0], j[0])
    cand = p[0].reshape(extract.ACC_H, CHUNK_W)
    assert np.all(cand[:, :4] != U64_MAX)  # 32 of the 40 kept
    shift = np.uint64(2 * k + 2)
    assert np.all(cand[0, 4:8] >> shift == 39)  # 40 copies, one head


def test_weighted_gate():
    z = torch.zeros(CHUNK, dtype=torch.int32)
    th = torch.zeros(1, dtype=torch.int64)
    assert extract.supports_weighted(25) and not extract.supports_weighted(26)
    assert all(extract.supports_weighted(k) == pe.supports_weighted(k)
               for k in range(1, 32))
    with pytest.raises(FinchMessageError):
        extract.extract_candidates(z, z, th, k=26, seed=0, weighted=True)
    # CPU tensors take the plain version and launch nothing
    before = (extract.extract_candidates.launches,
              extract.extract_candidates.launches_weighted)
    extract.extract_candidates(z, z, th, k=21, seed=0, weighted=True)
    assert (extract.extract_candidates.launches,
            extract.extract_candidates.launches_weighted) == before
