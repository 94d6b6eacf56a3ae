"""The port's sketch_step against the JAX package (Pallas kernel in
interpret mode, absorb and dedup tiers off) on the two rails the two-chunk
streams of test_torch_bottomk.py cannot reach:

* tier B — stride-aligned duplicates overflow the cross-chunk accumulator
  (more than 32 survivors in one column) while no chunk-column holds more
  than 8. Each chunk contributes at most 8 per column, so this needs five
  chunks (b = 327680). The warm mid-stream state has a nearly full spill,
  so the step also runs spill compaction.
* the scaled below rail — has_max_hash streams return the grow signal
  `below`, which must agree exactly along with the flushed state.
"""

import jax.numpy as jnp
import numpy as np
import torch

from finch_tpu.ops import bottomk as jbk
from finch_tpu_torch import native, u64
from finch_tpu_torch.ops import bottomk as tbk

torch.set_num_threads(2)

K, SEED = 21, 0
COLH, CHUNK_W = 32, 2048


def _planes(packed, rc):
    comp = (packed << np.uint64(1)) | rc
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def jax_step(state_np, lo, hi, nvalid, max_hash=0, has_max_hash=False):
    state = tuple(jnp.asarray(a) for a in state_np)
    new, below = jbk.sketch_step(
        state, jnp.asarray(lo), jnp.asarray(hi), jnp.uint32(nvalid),
        jnp.uint64(max_hash), k=K, seed=SEED, has_max_hash=has_max_hash,
        use_kernel=True, composite=True, kernel_interpret=True,
        absorb=False, dedup_tier=False)
    out, _ = jbk.flush_state(new, jnp.uint64(max_hash), k=K, seed=SEED)
    return (tuple(np.asarray(a) for a in new),
            tuple(np.asarray(a) for a in out), int(below))


def torch_step(state_np, lo, hi, nvalid, max_hash=0, has_max_hash=False):
    stats = {}
    new, below = tbk.sketch_step(
        tbk.state_from_numpy(state_np), u64.from_numpy(lo),
        u64.from_numpy(hi), nvalid, max_hash, k=K, seed=SEED,
        has_max_hash=has_max_hash, use_kernel=True, absorb=False,
        dedup_tier=False, stats=stats)
    out, _ = tbk.flush_state(new, max_hash, k=K, seed=SEED)
    return (tbk.state_to_numpy(new), tbk.state_to_numpy(out), int(below),
            stats)


def assert_states_equal(a, b):
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


def test_tier_b_stride_aligned_duplicates():
    rng = np.random.default_rng(21)
    nch = 5
    b = nch * COLH * CHUNK_W
    cap = 2000
    th = int(0.002 * 2**64)
    pool = rng.integers(0, 4 ** K, size=1 << 16, dtype=np.uint64)
    h = native.murmur3_packed(pool, K, SEED)
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    packed = rng.integers(0, 4 ** K, size=b, dtype=np.uint64)
    lanes = packed.reshape(nch, COLH, CHUNK_W)
    # columns 0..7: one low-hash value per column, in rows 0..7 of every
    # chunk (40 copies at stride CHUNK_W); the other rows never survive
    lanes[:, :, :8] = high[rng.integers(0, len(high), size=(nch, COLH, 8))]
    lanes[:, :8, :8] = low[:8][None, None, :]
    rc = rng.integers(0, 2, size=b, dtype=np.uint64)
    lo, hi = _planes(packed, rc)

    # a warm mid-stream state: threshold th, spill 50000/65536 full of
    # entries with many duplicates (compaction frees enough room)
    hs = np.unique(rng.integers(0, th, size=cap - 1, dtype=np.uint64))
    n = len(hs) + 1
    state = [np.full(cap, 2**64 - 1, dtype=np.uint64),
             np.zeros(cap, dtype=np.uint64), np.zeros(cap, dtype=np.uint64),
             np.zeros(cap, dtype=np.uint64)]
    state[0][:n] = np.append(hs, np.uint64(th))
    state[1][:n] = rng.integers(1, 4, size=n, dtype=np.uint64)
    state[2][:n] = state[1][:n] // np.uint64(2)
    state[3][:n] = rng.integers(0, 4 ** K, size=n, dtype=np.uint64)
    spill = np.full(tbk.spill_capacity(cap), 2**64 - 1, dtype=np.uint64)
    comps = (rng.integers(0, 4 ** K, size=5000, dtype=np.uint64)
             << np.uint64(1)) + np.uint64(1)
    spill[:50000] = comps[rng.integers(0, 5000, size=50000)]
    state += [spill, np.array([50000], dtype=np.int32),
              np.zeros(1, dtype=np.int32)]
    state = tuple(state)

    j_state, j_flushed, _ = jax_step(state, lo, hi, b)
    t_state, t_flushed, _, stats = torch_step(state, lo, hi, b)
    assert stats.get("tier_B") == 1
    assert stats["syncs"] >= 3  # fill, flags, pages (+ compaction)
    assert_states_equal(t_state, j_state)
    assert_states_equal(t_flushed, j_flushed)


def test_scaled_below_rail():
    rng = np.random.default_rng(8)
    b = 1 << 17
    cap = 4096
    max_hash = int(0.004 * 2**64)
    state = tuple(np.asarray(a) for a in jbk.empty_state(cap))
    for step in range(2):
        lo, hi = _planes(rng.integers(0, 4 ** K, size=b, dtype=np.uint64),
                         rng.integers(0, 2, size=b, dtype=np.uint64))
        j_state, j_flushed, j_below = jax_step(state, lo, hi, b, max_hash,
                                               has_max_hash=True)
        t_state, t_flushed, t_below, _ = torch_step(state, lo, hi, b,
                                                    max_hash,
                                                    has_max_hash=True)
        assert t_below == j_below > 0
        assert_states_equal(t_state, j_state)
        assert_states_equal(t_flushed, j_flushed)
        state = j_state
