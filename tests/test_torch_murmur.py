"""The port's torch murmur3 (finch_tpu_torch.ops.murmur3) against the JAX
package's hash_packed_kmers and the native scalar oracle, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops.murmur3 import hash_packed_kmers as jax_hash
from finch_tpu_torch import native, u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("k", [1, 7, 15, 16, 21, 28, 31])
def test_hash_matches_jax_and_oracle(k, seed):
    rng = np.random.default_rng(1000 + k)
    packed = rng.integers(0, 4 ** k, size=4096, dtype=np.uint64)
    packed[:4] = [0, 4 ** k - 1, 1, 4 ** k // 2]
    got = u64.to_numpy(hash_packed_kmers(u64.from_numpy(packed), k=k,
                                         seed=seed))
    assert np.array_equal(got, native.murmur3_packed(packed, k, seed))
    assert np.array_equal(
        got, np.asarray(jax_hash(jnp.asarray(packed), k=k, seed=seed)))


def test_hash_ignores_bits_above_2k():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 4 ** 21, size=256, dtype=np.uint64)
    high = packed | np.uint64(0xABC << 50)
    a = hash_packed_kmers(u64.from_numpy(packed), k=21, seed=0)
    b = hash_packed_kmers(u64.from_numpy(high), k=21, seed=0)
    assert torch.equal(a, b)


def test_hash_rejects_wide_k():
    with pytest.raises(FinchMessageError):
        hash_packed_kmers(torch.zeros(4, dtype=torch.int64), k=32)
