"""The CUDA extract kernel against its plain PyTorch version on the card.

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
from finch_tpu_torch.ops import extract

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
