"""Tier D of ops/dedup.py, plain PyTorch version, against the Pallas TPU
kernel it replaces (``_dedup_kernel``) in interpret mode on the CPU.

Integers throughout, so the tolerance is 0: cand must be equal entry for
entry, holes included, also when dovf is set, and the flags equal. Both
sides get the same hash planes (the port's plain extract, which equals
the Pallas kernel's: tests/test_torch_extract.py). Mirrors
test_pallas_extract.py's tier-D tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import pallas_extract as pe
from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops import dedup, extract

torch.set_num_threads(2)

U64_MAX = np.uint64(2**64 - 1)
CHUNK = extract.CHUNK


def _both(v, th, k, seed=0):
    """(Pallas (cand, dovf), port (cand, dovf)) of tier D, as numpy."""
    lo = u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = u64.from_numpy((v >> np.uint64(32)).astype(np.uint32))
    tt = torch.tensor([u64.to_i64(th)])
    _c, _s, hlo, hhi, _covf, _aovf = extract.extract_candidates(
        lo, hi, tt, k=k, seed=seed)
    j = pe.dedup_candidates(
        *(jnp.asarray(u64.to_numpy(t)) for t in (lo, hi, hlo, hhi)),
        jnp.uint32(th >> 32), jnp.uint32(th & 0xFFFFFFFF), k=k, seed=seed,
        interpret=True)
    p = dedup.dedup_candidates(lo, hi, hlo, hhi, tt, k=k)
    return (np.asarray(j[0]), int(j[1])), (u64.to_numpy(p[0]), int(p[1]))


def _tiled(nchunks, dup, k, seed_rng=23):
    rng = np.random.default_rng(seed_rng)
    b = nchunks * CHUNK
    distinct = rng.integers(0, 4 ** k, size=b // dup, dtype=np.uint64)
    rc = rng.integers(0, 2, size=b // dup, dtype=np.uint64)
    v = np.tile((distinct << np.uint64(1)) | rc, dup)
    v[-17:] = U64_MAX
    return v


@pytest.mark.parametrize("nchunks,dup,k", [
    (1, 16, 21), (2, 64, 21),
    (1, 16, 15),   # the weight field starts exactly at the high word
    (1, 16, 25),   # the narrowest weight field, 12 bits
])
def test_dedup_plain_matches_pallas(nchunks, dup, k):
    v = _tiled(nchunks, dup, k)
    (jc, jf), (pc, pf) = _both(v, int(0.3 * 2**64), k)
    assert jf == pf == 0
    assert np.array_equal(pc, jc)
    # heads carry their duplicates in the weight field
    real = pc[pc != U64_MAX]
    assert np.any((real >> np.uint64(2 * k + 2)) > 0)


def test_dedup_overflow_output_matches_pallas():
    """A cold four-chunk uniform batch: 32 distinct survivors per column
    per chunk, 128 > 96 rows, so dovf = 1; cand (the 96 kept rows) must
    still equal the TPU kernel's entry for entry."""
    rng = np.random.default_rng(3)
    v = rng.integers(0, 4 ** 21, size=4 * CHUNK, dtype=np.uint64) \
        << np.uint64(1)
    (jc, jf), (pc, pf) = _both(v, 2**64 - 1, 21)
    assert jf == pf == 1
    assert np.array_equal(pc, jc)


def test_dedup_gate_and_checks():
    for k in (1, 15, 21, 25, 26, 28):
        for b in (CHUNK // 2, CHUNK, 3 * CHUNK, 4 * CHUNK, 8 * CHUNK):
            assert dedup.supports_dedup(k, b) == pe.supports_dedup(k, b)
            assert (dedup.supports_dedup_slab(k, b)
                    == pe.supports_dedup_slab(k, b))
    z = torch.zeros(CHUNK, dtype=torch.int32)
    th = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(FinchMessageError):
        dedup.dedup_candidates(z, z, z, z, th, k=26)
    with pytest.raises(FinchMessageError):
        dedup.dedup_candidates(z, z, z[:-1], z, th, k=21)
    with pytest.raises(FinchMessageError):
        dedup.dedup_slab_candidates(torch.zeros(3 * CHUNK // 4,
                                                dtype=torch.int64), k=21)
    # CPU tensors take the plain versions and launch nothing
    before = (dedup.dedup_candidates.launches,
              dedup.dedup_slab_candidates.launches)
    dedup.dedup_candidates(z, z, z, z, th, k=21)
    dedup.dedup_slab_candidates(torch.full((CHUNK,), -1, dtype=torch.int64),
                                k=21)
    assert (dedup.dedup_candidates.launches,
            dedup.dedup_slab_candidates.launches) == before
