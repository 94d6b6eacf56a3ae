"""The port's sketch_step in its default configuration against the JAX
package's (absorb=True, dedup_tier=True, Pallas kernels in interpret
mode) at eight chunks (b = 524288), where tier D2 is open.

* tier D2: after a cold uniform step (tier C), a sparse batch whose
  column 0 holds 40 copies of one surviving value, 5 rows per chunk: the
  accumulator overflows (aovf) with a complete slab (covf = 0), and D2
  collapses the copies into one weighted head.
* the adaptive-absorb hint, 0 -> 1 -> 0: a cold step keeps it 0; a flood
  that D2 collapses by at least a quarter turns it on; the next step runs
  the weighted extract, absorbs nothing and turns it off.

Mirrors test_pallas_extract.py's D2 integration and hint lifecycle tests.
Integers throughout (tolerance 0): the unflushed states (spill, fill and
hint included) and the flushed states must be equal after every step."""

import jax.numpy as jnp
import numpy as np
import torch

from finch_tpu.ops import bottomk as jbk
from finch_tpu_torch import native, u64
from finch_tpu_torch.ops import bottomk as tbk

torch.set_num_threads(2)

K, SEED, CAP = 21, 0, 256
COLH, CHUNK_W, NCH = 32, 2048, 8
B = NCH * COLH * CHUNK_W


def _planes(packed, rc):
    comp = (packed << np.uint64(1)) | rc.astype(np.uint64)
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


def _steps(batches):
    """Run both packages over `batches`; after every step, compare the
    unflushed and the flushed states. Returns (port stats per step, JAX
    states)."""
    state = tuple(np.asarray(a) for a in jbk.empty_state(CAP))
    all_stats, states = [], []
    for packed, rc in batches:
        lo, hi = _planes(packed, rc)
        jnew, _ = jbk.sketch_step(
            tuple(jnp.asarray(a) for a in state), jnp.asarray(lo),
            jnp.asarray(hi), jnp.uint32(B), jnp.uint64(0), k=K, seed=SEED,
            has_max_hash=False, use_kernel=True, composite=True,
            kernel_interpret=True, absorb=True, dedup_tier=True)
        jflushed, _ = jbk.flush_state(jnew, jnp.uint64(0), k=K, seed=SEED)
        stats = {}
        tnew, _ = tbk.sketch_step(
            tbk.state_from_numpy(state), u64.from_numpy(lo),
            u64.from_numpy(hi), B, 0, k=K, seed=SEED, has_max_hash=False,
            use_kernel=True, stats=stats)
        tflushed, _ = tbk.flush_state(tnew, 0, k=K, seed=SEED)
        for t, j in ((tnew, jnew), (tflushed, jflushed)):
            for x, y in zip(tbk.state_to_numpy(t), j):
                assert np.array_equal(x, np.asarray(y))
        state = tuple(np.asarray(a) for a in jnew)
        all_stats.append(stats)
        states.append(state)
    return all_stats, states


def _flood(p2, value):
    """40 copies of `value` in column 0, rows 0..4 of every chunk."""
    for c in range(NCH):
        for r in range(5):
            p2[c * COLH * CHUNK_W + r * CHUNK_W] = value


def test_tier_d2_collapses_a_flood():
    rng = np.random.default_rng(77)
    p1 = rng.integers(0, 4 ** K, size=B, dtype=np.uint64)
    rc1 = rng.integers(0, 2, size=B, dtype=np.uint8)
    p2 = rng.integers(0, 4 ** K, size=B, dtype=np.uint64)
    rc2 = rng.integers(0, 2, size=B, dtype=np.uint8)
    order = np.argsort(native.murmur3_packed(p1, K, SEED), kind="stable")
    _flood(p2, p1[order[0]])  # certainly below the warmed threshold
    rc2[::CHUNK_W] = 0
    stats, states = _steps([(p1, rc1), (p2, rc2)])
    assert stats[0].get("tier_C") == 1 and stats[0].get("D_overflow") == 1
    assert stats[1].get("tier_D2") == 1
    assert [int(s[6][0]) for s in states] == [0, 0]


def test_hint_lifecycle():
    rng = np.random.default_rng(5)
    p1 = rng.integers(0, 4 ** K, size=B, dtype=np.uint64)
    rc1 = rng.integers(0, 2, size=B, dtype=np.uint8)
    order = np.argsort(native.murmur3_packed(p1, K, SEED), kind="stable")
    # (b) background lanes recycle values above the warmed threshold, so
    # the flood is most of the survivor mass: D2 collapses 39 of 40
    p2 = np.tile(p1[order[4 * CAP:]], 2)[:B].copy()
    rc2 = rng.integers(0, 2, size=B, dtype=np.uint8)
    _flood(p2, p1[order[0]])
    rc2[::CHUNK_W] = 0
    # (c) no survivors at all: the weighted extract absorbs nothing
    p3 = np.tile(p1[order[-B // 4:]], 4)[:B]
    rc3 = np.zeros(B, dtype=np.uint8)
    stats, states = _steps([(p1, rc1), (p2, rc2), (p3, rc3)])
    assert [int(s[6][0]) for s in states] == [0, 1, 0]
    assert stats[1].get("tier_D2") == 1
    assert stats[2].get("extract_weighted") == 1
    assert stats[2].get("tier_A") == 1
