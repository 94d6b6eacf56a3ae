"""The port's sketch_step in its default configuration against the JAX
package's (absorb=True, dedup_tier=True, Pallas kernels in interpret
mode) on the step where tier D2 overflows and the slab is paged (tier B).

D2 merges 32 slab rows per step into 96 rows, so it can overflow only
from its fourth step on: sixteen chunks (b = 1048576). A warm state with
the hint on runs the weighted extract; columns 0..3 get 8 distinct
survivors per chunk (128 per column: the weighted accumulator overflows,
no chunk column does), so D2 runs on the complete slab, overflows, and
the step takes tier B. Integers throughout (tolerance 0): the unflushed
state (spill, fill and hint included) and the flushed state must be
equal."""

import jax.numpy as jnp
import numpy as np
import torch

from finch_tpu.ops import bottomk as jbk
from finch_tpu_torch import native, u64
from finch_tpu_torch.ops import bottomk as tbk

torch.set_num_threads(2)

K, SEED, CAP = 21, 0, 256
COLH, CHUNK_W, NCH = 32, 2048, 16
B = NCH * COLH * CHUNK_W


def test_d2_overflow_takes_tier_b():
    rng = np.random.default_rng(41)
    th = int(0.004 * 2**64)
    pool = np.unique(rng.integers(0, 4 ** K, size=1 << 18, dtype=np.uint64))
    h = native.murmur3_packed(pool, K, SEED)
    low, high = pool[h <= np.uint64(th)], pool[h > np.uint64(th)]
    packed = high[rng.integers(0, len(high), size=B)]
    lanes = packed.reshape(NCH, COLH, CHUNK_W)
    lanes[:, :8, :4] = low[:NCH * 8 * 4].reshape(NCH, 8, 4)
    lanes[:, 0, 4] = low[-1]  # 16 copies of one value
    comp = packed << np.uint64(1)
    lo = (comp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (comp >> np.uint64(32)).astype(np.uint32)

    # a warm state: threshold th, an empty spill, the hint on
    hs = np.sort(rng.integers(0, th, size=CAP - 1, dtype=np.uint64))
    state = (np.append(hs, np.uint64(th)),
             rng.integers(1, 4, size=CAP, dtype=np.uint64),
             np.zeros(CAP, dtype=np.uint64),
             rng.integers(0, 4 ** K, size=CAP, dtype=np.uint64),
             np.full(tbk.spill_capacity(CAP), 2**64 - 1, dtype=np.uint64),
             np.zeros(1, dtype=np.int32), np.ones(1, dtype=np.int32))

    jnew, _ = jbk.sketch_step(
        tuple(jnp.asarray(a) for a in state), jnp.asarray(lo),
        jnp.asarray(hi), jnp.uint32(B), jnp.uint64(0), k=K, seed=SEED,
        has_max_hash=False, use_kernel=True, composite=True,
        kernel_interpret=True, absorb=True, dedup_tier=True)
    jflushed, _ = jbk.flush_state(jnew, jnp.uint64(0), k=K, seed=SEED)
    stats = {}
    tnew, _ = tbk.sketch_step(
        tbk.state_from_numpy(state), u64.from_numpy(lo), u64.from_numpy(hi),
        B, 0, k=K, seed=SEED, has_max_hash=False, use_kernel=True,
        stats=stats)
    tflushed, _ = tbk.flush_state(tnew, 0, k=K, seed=SEED)
    assert stats.get("extract_weighted") == 1
    assert stats.get("D2_overflow") == 1 and stats.get("tier_B") == 1
    for t, j in ((tnew, jnew), (tflushed, jflushed)):
        t = tbk.state_to_numpy(t)
        assert len(t) == 7
        for x, y in zip(t, j):
            assert x.dtype == np.asarray(y).dtype
            assert np.array_equal(x, np.asarray(y))
    # 15 absorbed copies of 144 occurrences in the weighted heads: off
    assert int(tnew[6][0]) == 0
