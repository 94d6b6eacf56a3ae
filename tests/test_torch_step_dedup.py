"""The port's sketch_step in its default configuration (the weighted
extract behind the adaptive-absorb hint, tiers D2 and D) against
finch_tpu.ops.bottomk.sketch_step with absorb=True, dedup_tier=True and the
Pallas kernels in interpret mode, at two chunks (b = 131072), where tier
D2 is gated off and every dirty step takes tier D.

Mirrors test_pallas_extract.py's tier-D integration test: a 64x
stride-aligned duplicate burst and a half-duplicate batch, each a cold
step then a warm one. Integers throughout (tolerance 0): the unflushed
states (spill, fill and hint included) and the flushed states must be
equal array for array after every step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import bottomk as jbk
from finch_tpu_torch import u64
from finch_tpu_torch.ops import bottomk as tbk

torch.set_num_threads(2)

K, SEED, CAP, B = 21, 0, 256, 1 << 17


def _planes(packed, rc):
    comp = (packed << np.uint64(1)) | rc.astype(np.uint64)
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def jax_step(state_np, lo, hi):
    new, _ = jbk.sketch_step(
        tuple(jnp.asarray(a) for a in state_np), jnp.asarray(lo),
        jnp.asarray(hi), jnp.uint32(B), jnp.uint64(0), k=K, seed=SEED,
        has_max_hash=False, use_kernel=True, composite=True,
        kernel_interpret=True, absorb=True, dedup_tier=True)
    flushed, _ = jbk.flush_state(new, jnp.uint64(0), k=K, seed=SEED)
    return (tuple(np.asarray(a) for a in new),
            tuple(np.asarray(a) for a in flushed))


def torch_step(state_np, lo, hi, stats):
    new, _ = tbk.sketch_step(
        tbk.state_from_numpy(state_np), u64.from_numpy(lo),
        u64.from_numpy(hi), B, 0, k=K, seed=SEED, has_max_hash=False,
        use_kernel=True, stats=stats)
    flushed, _ = tbk.flush_state(new, 0, k=K, seed=SEED)
    return tbk.state_to_numpy(new), tbk.state_to_numpy(flushed)


def assert_states_equal(a, b):
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


def _batch(pattern):
    rng = np.random.default_rng(31)
    if pattern == "full_dup":
        distinct = rng.integers(0, 4 ** K, size=B // 64, dtype=np.uint64)
        packed = np.tile(distinct, 64)
        rc = np.tile(rng.integers(0, 2, size=B // 64, dtype=np.uint8), 64)
    else:  # half heavy duplicates, half unique
        d1 = rng.integers(0, 4 ** K, size=B // 32, dtype=np.uint64)
        packed = np.concatenate(
            [np.tile(d1, 16),
             rng.integers(0, 4 ** K, size=B // 2, dtype=np.uint64)])
        rc = rng.integers(0, 2, size=B, dtype=np.uint8)
    return packed, rc


@pytest.mark.parametrize("pattern", ["full_dup", "mixed"])
def test_tier_d_steps_match_jax(pattern):
    packed, rc = _batch(pattern)
    state = tuple(np.asarray(a) for a in jbk.empty_state(CAP))
    stats = {}
    # a cold step, then one against the warmed threshold
    for p in (packed, packed ^ np.uint64(0x155)):
        lo, hi = _planes(p, rc)
        j_state, j_flushed = jax_step(state, lo, hi)
        t_state, t_flushed = torch_step(state, lo, hi, stats)
        assert_states_equal(t_state, j_state)
        assert_states_equal(t_flushed, j_flushed)
        state = j_state
    # both steps overflowed a chunk column (copies share columns), and
    # tier D collapsed them; without D2 the hint never engages
    assert stats.get("tier_D") == 2, stats
    assert int(state[6][0]) == 0
    assert "extract_weighted" not in stats
