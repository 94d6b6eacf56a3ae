"""The CUDA kernels (extract, weighted extract, tiers D and D2) against
their plain PyTorch versions on the card.

A CUDA kernel has no interpret mode, so these tests skip without a card;
run them on the GPU with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` (the
repository's conftest imports JAX, which the GPU machine need not have).
chip_smoke.py holds the kernel against the plain version at the main
path's shapes as well."""

import numpy as np
import pytest
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.ops import dedup, extract

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,seed,nch,frac", [(21, 0, 4, 0.004),
                                             (28, 42, 1, 1.0),
                                             (1, 0, 2, 0.5)])
def test_kernel_matches_plain(cuda, k, seed, nch, frac):
    rng = np.random.default_rng(k)
    b = nch * extract.CHUNK
    v = ((rng.integers(0, 4 ** k, size=b, dtype=np.uint64) << np.uint64(1))
         | rng.integers(0, 2, size=b, dtype=np.uint64))
    v[rng.random(b) < 0.03] = np.uint64(2**64 - 1)
    vlo = u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32), cuda)
    vhi = u64.from_numpy((v >> np.uint64(32)).astype(np.uint32), cuda)
    th = torch.tensor([u64.to_i64(min(int(frac * 2**64), 2**64 - 1))],
                      device=cuda)
    before = extract.extract_candidates.launches
    got = extract.extract_candidates(vlo, vhi, th, k=k, seed=seed)
    torch.cuda.synchronize()
    assert extract.extract_candidates.launches == before + 1
    want = extract.extract_candidates_plain(vlo, vhi, th, k=k, seed=seed)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _lanes(cuda, k, nch, dup, shuffle, seed=0):
    rng = np.random.default_rng(seed)
    b = nch * extract.CHUNK
    v = ((rng.integers(0, 4 ** k, size=b // dup, dtype=np.uint64)
          << np.uint64(1)) | rng.integers(0, 2, size=b // dup,
                                          dtype=np.uint64))
    v = np.tile(v, dup)
    if shuffle:
        v = v[rng.permutation(b)]
    v[-37:] = np.uint64(2**64 - 1)
    return (u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                           cuda),
            u64.from_numpy((v >> np.uint64(32)).astype(np.uint32), cuda))


def _thresh(cuda, frac):
    return torch.tensor([u64.to_i64(min(int(frac * 2**64), 2**64 - 1))],
                        device=cuda)


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


@pytest.mark.parametrize("nch,dup,shuffle,frac", [
    (4, 4, False, 0.02), (8, 8, True, 0.05), (16, 1, False, 0.2),
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
