"""Tier D2 of ops/dedup.py, plain PyTorch version, against the Pallas TPU
kernel it replaces (``_dedup_slab_kernel``) in interpret mode on the CPU.

Integers throughout, so the tolerance is 0: cand must be equal entry for
entry, holes included, also when d2ovf is set, and the flags equal. Both
sides get the same slab (the port's plain extract, whose slab equals the
Pallas kernel's: tests/test_torch_extract.py). Mirrors
test_pallas_extract.py's tier-D2 tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import pallas_extract as pe
from finch_tpu_torch import native, u64
from finch_tpu_torch.ops import dedup, extract

torch.set_num_threads(2)

U64_MAX = np.uint64(2**64 - 1)
CHUNK = extract.CHUNK
K, SEED = 21, 0


def _slab(v, th):
    lo = u64.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = u64.from_numpy((v >> np.uint64(32)).astype(np.uint32))
    out = extract.extract_candidates(lo, hi, torch.tensor([u64.to_i64(th)]),
                                     k=K, seed=SEED)
    return out[1], int(out[4])


def _both(slab):
    j = pe.dedup_slab_candidates(jnp.asarray(u64.to_numpy(slab)), k=K,
                                 interpret=True)
    p = dedup.dedup_slab_candidates(slab, k=K)
    return (np.asarray(j[0]), int(j[1])), (u64.to_numpy(p[0]), int(p[1]))


@pytest.mark.parametrize("nchunks,dup,frac", [
    (4, 4, 0.02), (8, 8, 0.02), (4, 1, 0.01),
])
def test_dedup_slab_plain_matches_pallas(nchunks, dup, frac):
    rng = np.random.default_rng(5)
    b = nchunks * CHUNK
    distinct = rng.integers(0, 4 ** K, size=b // dup, dtype=np.uint64)
    rc = rng.integers(0, 2, size=b // dup, dtype=np.uint64)
    v = np.tile((distinct << np.uint64(1)) | rc, dup)
    v[-9:] = U64_MAX
    slab, covf = _slab(v, int(frac * 2**64))
    assert covf == 0  # the slab holds every survivor
    (jc, jf), (pc, pf) = _both(slab)
    assert jf == pf == 0
    assert np.array_equal(pc, jc)


def test_dedup_slab_overflow_output_matches_pallas():
    """Sixteen chunks (four steps of 32 slab rows) whose columns 0..3 get 8
    distinct survivors per chunk (128 per column over the batch) while no
    chunk-column holds more than 8: d2ovf = 1, and cand (the 96 kept rows,
    holes included) must still equal the TPU kernel's entry for entry."""
    rng = np.random.default_rng(77)
    nch = 16
    th = int(0.004 * 2**64)
    pool = np.unique(rng.integers(0, 4 ** K, size=1 << 18, dtype=np.uint64))
    h = native.murmur3_packed(pool, K, SEED)
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    packed = high[rng.integers(0, len(high), size=nch * CHUNK)]
    lanes = packed.reshape(nch, extract.COLH, extract.CHUNK_W)
    lanes[:, :8, :4] = low[:nch * 8 * 4].reshape(nch, 8, 4)
    # columns 4..5: two values, each in every chunk (a burst D2 collapses)
    lanes[:, :2, 4:6] = low[-2:][None, None, :]
    slab, covf = _slab(packed << np.uint64(1), th)
    assert covf == 0
    (jc, jf), (pc, pf) = _both(slab)
    assert jf == pf == 1
    assert np.array_equal(pc, jc)
