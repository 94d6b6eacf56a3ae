"""The port's sketch_step (kernel path through the plain extract) against
finch_tpu.ops.bottomk.sketch_step with the Pallas kernel in interpret
mode, absorb and dedup tiers off — the port's slice of the main path.

Streams at b = 131072 (two chunks), k = 21: a cold start (tier C), a warm
mid-stream state carried over with state_from_numpy (tier A) and a
shuffled 64x duplicate batch. Integers throughout: flush_state outputs
must be equal array for array (tolerance 0); the unflushed states are
compared too, since the port keeps the JAX paging layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import bottomk as jbk
from finch_tpu_torch import u64
from finch_tpu_torch.ops import bottomk as tbk

torch.set_num_threads(2)

K, SEED, CAP, B = 21, 0, 2000, 1 << 17


def _planes(packed, rc):
    comp = (packed << np.uint64(1)) | rc
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def _batch(seed, dup_shuffle=False):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 4 ** K, size=B, dtype=np.uint64)
    rc = rng.integers(0, 2, size=B, dtype=np.uint64)
    if dup_shuffle:  # every value 64x, copies scattered over all lanes
        perm = rng.permutation(B)
        packed = np.tile(packed[:B // 64], 64)[perm]
        rc = np.tile(rc[:B // 64], 64)[perm]
    return _planes(packed, rc)


def jax_step(state_np, lo, hi, nvalid, max_hash=0, has_max_hash=False):
    state = tuple(jnp.asarray(a) for a in state_np)
    new, below = jbk.sketch_step(
        state, jnp.asarray(lo), jnp.asarray(hi), jnp.uint32(nvalid),
        jnp.uint64(max_hash), k=K, seed=SEED, has_max_hash=has_max_hash,
        use_kernel=True, composite=True, kernel_interpret=True,
        absorb=False, dedup_tier=False)
    return tuple(np.asarray(a) for a in new), int(below)


def jax_flush(state_np, max_hash=0):
    state = tuple(jnp.asarray(a) for a in state_np)
    out, below = jbk.flush_state(state, jnp.uint64(max_hash), k=K, seed=SEED)
    return tuple(np.asarray(a) for a in out), int(below)


def torch_step(state_np, lo, hi, nvalid, max_hash=0, has_max_hash=False,
               use_kernel=True):
    stats = {}
    new, below = tbk.sketch_step(
        tbk.state_from_numpy(state_np), u64.from_numpy(lo),
        u64.from_numpy(hi), nvalid, max_hash, k=K, seed=SEED,
        has_max_hash=has_max_hash, use_kernel=use_kernel, absorb=False,
        dedup_tier=False, stats=stats)
    return tbk.state_to_numpy(new), int(below), stats


def torch_flush(state_np, max_hash=0):
    out, below = tbk.flush_state(tbk.state_from_numpy(state_np), max_hash,
                                 k=K, seed=SEED)
    return tbk.state_to_numpy(out), int(below)


def assert_states_equal(a, b):
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def cold():
    """(empty state, batch, JAX state after the batch)."""
    empty = tuple(np.asarray(a) for a in jbk.empty_state(CAP))
    lo, hi = _batch(1)
    lo[-100:] = 0  # the engine's zero padding beyond nvalid
    hi[-100:] = 0
    after, _ = jax_step(empty, lo, hi, B - 100)
    return empty, (lo, hi, B - 100), after


def _stream(name, cold):
    """(start state, batch, JAX state after the batch)."""
    empty, batch, after = cold
    if name == "cold":
        return empty, batch, after
    lo, hi = _batch(2, dup_shuffle=(name == "dup_shuffle"))
    return after, (lo, hi, B), jax_step(after, lo, hi, B)[0]


@pytest.mark.parametrize("name,tier", [("cold", "tier_C"),
                                       ("warm", "tier_A"),
                                       ("dup_shuffle", "tier_A")])
def test_sketch_step_matches_jax(cold, name, tier):
    start, (lo, hi, nvalid), j_state = _stream(name, cold)
    t_state, _, stats = torch_step(start, lo, hi, nvalid)
    assert stats.get(tier) == 1
    assert_states_equal(t_state, j_state)
    j_flushed, j_below = jax_flush(j_state)
    t_flushed, t_below = torch_flush(t_state)
    assert_states_equal(t_flushed, j_flushed)
    assert t_below == j_below
    # the port without the kernel reaches the same flushed state
    p_state, _, stats = torch_step(start, lo, hi, nvalid, use_kernel=False)
    assert stats.get("two_stage") == 1
    assert_states_equal(torch_flush(p_state)[0], j_flushed)


def test_state_numpy_roundtrip(cold):
    _, _, after = cold
    st = tbk.state_from_numpy(after)
    assert [t.dtype for t in st] == [torch.int64] * 5 + [torch.int32] * 2
    assert_states_equal(tbk.state_to_numpy(st), after)


def test_grow_state_matches_jax(cold):
    _, _, after = cold
    j = jbk.grow_state(tuple(jnp.asarray(a) for a in after),
                       jbk.empty_state(3 * CAP))
    t = tbk.grow_state(tbk.state_from_numpy(after), 3 * CAP)
    assert_states_equal(tbk.state_to_numpy(t), tuple(np.asarray(a) for a in j))


def test_merge_states_matches_jax(cold):
    empty, _, after = cold
    lo, hi = _batch(3)
    other, _, _ = torch_step(empty, lo, hi, B, use_kernel=False)
    j = jbk.merge_states([tuple(jnp.asarray(a) for a in s)
                          for s in (after, other)], k=K, seed=SEED)
    t = tbk.merge_states([tbk.state_from_numpy(s) for s in (after, other)],
                         k=K, seed=SEED)
    assert_states_equal(tbk.state_to_numpy(t), tuple(np.asarray(a) for a in j))


def test_small_batch_path_matches_jax():
    """Batches under 128k lanes take the plain run_small path."""
    rng = np.random.default_rng(4)
    b = 4096
    lo, hi = _planes(rng.integers(0, 4 ** K, size=b, dtype=np.uint64),
                     rng.integers(0, 2, size=b, dtype=np.uint64))
    empty = tuple(np.asarray(a) for a in jbk.empty_state(64))
    j_state, _ = jax_step(empty, lo, hi, b - 5)
    t_state, _, stats = torch_step(empty, lo, hi, b - 5)
    assert stats.get("small") == 1
    assert_states_equal(t_state, j_state)
