"""The plain PyTorch version of the extract kernel (ops/extract.py) against
the Pallas TPU kernel it replaces, run in interpret mode on the CPU.

Integers throughout, so the tolerance is 0: cand must be equal, the slab
equal as a multiset per (chunk, column), the hash planes equal on every
non-padding lane, and both overflow flags equal."""

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


def _lanes(packed, rc, pad):
    v = (packed << np.uint64(1)) | rc
    v[pad] = U64_MAX
    return ((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


def _random_case(nch, k, thresh_frac, seed_rng, dup=False):
    rng = np.random.default_rng(seed_rng)
    b = nch * CHUNK
    packed = rng.integers(0, 4 ** k, size=b, dtype=np.uint64)
    if dup:  # cross-chunk duplicates, scattered and same-column
        packed[b // 2:b // 2 + 64] = packed[:64]
        packed[3 * CHUNK:3 * CHUNK + 4096] = packed[:4096]
    rc = rng.integers(0, 2, size=b, dtype=np.uint64)
    pad = rng.random(b) < 0.03
    pad[-37:] = True
    th = min(int(thresh_frac * 2**64), 2**64 - 1)
    return _lanes(packed, rc, pad) + (th, pad)


def _column_overflow_case(k, seed):
    """Five chunks whose columns 0..3 each hold 8 survivors per chunk (40
    over the batch: the accumulator overflows) while no chunk-column holds
    more than 8."""
    rng = np.random.default_rng(99)
    nch = 5
    b = nch * CHUNK
    th = int(0.002 * 2**64)
    pool = rng.integers(0, 4 ** k, size=1 << 16, dtype=np.uint64)
    h = native.murmur3_packed(pool, k, seed)
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    packed = high[rng.integers(0, len(high), size=b)]
    lanes = packed.reshape(nch, extract.COLH, extract.CHUNK_W)
    lanes[:, :8, :4] = low[rng.integers(0, len(low), size=(nch, 8, 4))]
    rc = rng.integers(0, 2, size=b, dtype=np.uint64)
    pad = np.zeros(b, dtype=bool)
    return _lanes(packed, rc, pad) + (th, pad)


CASES = {
    # name: (k, seed, lanes, expected (covf, aovf) or None)
    "one_chunk_k21": (21, 0, lambda: _random_case(1, 21, 0.01, 1), (0, 0)),
    "one_chunk_k15": (15, 42, lambda: _random_case(1, 15, 0.01, 2), (0, 0)),
    "four_chunks_dups": (21, 0, lambda: _random_case(4, 21, 0.004, 3,
                                                     dup=True), (0, 0)),
    "cold": (21, 0, lambda: _random_case(1, 21, 1.0, 4), (1, 0)),
    "column_overflow": (21, 0, lambda: _column_overflow_case(21, 0), (0, 1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas(name):
    k, seed, make, flags = CASES[name]
    vlo, vhi, th, pad = make()
    b = len(vlo)
    nch = b // CHUNK

    j = pe.extract_candidates(
        jnp.asarray(vlo), jnp.asarray(vhi), jnp.uint32(th >> 32),
        jnp.uint32(th & 0xFFFFFFFF), k=k, seed=seed, interpret=True,
        weighted=False)
    j_cand, j_slab, j_hlo, j_hhi = (np.asarray(x) for x in j[:4])
    j_flags = (int(j[4]), int(j[5]))

    p = extract.extract_candidates(
        u64.from_numpy(vlo), u64.from_numpy(vhi),
        torch.tensor([u64.to_i64(th)]), k=k, seed=seed)
    p_cand, p_slab, p_hlo, p_hhi = (u64.to_numpy(x) for x in p[:4])
    p_flags = (int(p[4]), int(p[5]))

    assert j_flags == flags, "the case must exercise what it names"
    assert p_flags == j_flags
    assert np.array_equal(p_cand, j_cand)

    def per_column(slab):
        return np.sort(slab.reshape(nch, extract.ROWS_OUT, extract.CHUNK_W),
                       axis=1)
    assert np.array_equal(per_column(p_slab), per_column(j_slab))
    real = ~pad
    assert np.array_equal(p_hlo[real], j_hlo[real])
    assert np.array_equal(p_hhi[real], j_hhi[real])


def test_wrapper_checks():
    z = torch.zeros(CHUNK, dtype=torch.int32)
    th = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(FinchMessageError):
        extract.extract_candidates(z, z, th, k=29, seed=0)  # k > 28
    with pytest.raises(FinchMessageError):
        extract.extract_candidates(z[:-1], z[:-1], th, k=21, seed=0)
    with pytest.raises(FinchMessageError):
        extract.extract_candidates(z.long(), z.long(), th, k=21, seed=0)
    assert extract.supports(28, CHUNK) and not extract.supports(21, CHUNK // 2)
    # CPU tensors take the plain version and launch nothing
    before = extract.extract_candidates.launches
    extract.extract_candidates(z, z, th, k=21, seed=0)
    assert extract.extract_candidates.launches == before
