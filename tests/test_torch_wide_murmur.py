"""The port's wide murmur (hash_packed_kmers_wide, 32 <= k <= 63) against
finch_tpu.ops.murmur3.hash_packed_kmers_wide and the native
murmur3_packed_w, on seeded random two-word codes over the whole code
range, for every k and two hash seeds. Integers: exact equality.

The JAX function runs eagerly (jax.disable_jit): the same code, without
compiling 64 programs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops.murmur3 import hash_packed_kmers_wide as jax_hash
from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.native import murmur3_packed_w
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers_wide

N = 512


def _codes(k: int, seed: int):
    rng = np.random.default_rng(1000 * seed + k)
    plo = rng.integers(0, 2**64, size=N, dtype=np.uint64)
    phi = rng.integers(0, 2 ** (2 * k - 64), size=N, dtype=np.uint64)
    # the extremes: all-A, all-T, and a leading T over random low words
    plo[:3] = [0, 2**64 - 1, 12345]
    phi[:3] = [0, 2 ** (2 * k - 64) - 1, 2 ** (2 * k - 64) - 1]
    return plo, phi


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("k", range(32, 64))
def test_wide_hash_matches_jax_and_native(k, seed):
    plo, phi = _codes(k, seed)
    got = u64.to_numpy(hash_packed_kmers_wide(
        u64.from_numpy(plo), u64.from_numpy(phi), k=k, seed=seed))
    with jax.disable_jit():
        want = np.asarray(jax_hash(jnp.asarray(plo), jnp.asarray(phi), k=k,
                                   seed=seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, murmur3_packed_w(plo, phi, k, seed))


@pytest.mark.parametrize("k", [31, 64])
def test_wide_hash_refuses_other_k(k):
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(FinchMessageError):
        hash_packed_kmers_wide(z, z, k=k)
