"""HybridEngine at wide k (32 <= k <= 63) on the CPU: the host fold's
state migrates onto TorchEngine's wide step mid-stream.

The same numpy batches, made from a seed (random two-word codes, half with
the code's top bits set, runs within and across batches, mixed strands),
go through HybridEngine(device="cpu"), a TorchEngine(device="cpu") fed
from the first batch, and the JAX package's NumpyEngine. Integers
throughout, so every comparison is exact:

* HybridEngine migrates (its `_dev` is set) once it has seen
  `switch_after` k-mers, and `_seen` counts k-mers, not payload words;
* after the migration its raw state equals TorchEngine's after every
  batch, capacity included, except bit 1 of the phirc word (the is-rc bit
  the host fold does not keep), and that bit reaches no output. A scaled
  TorchEngine also keeps hashes above max_hash past the `size` that the
  retention rule can output, up to its capacity; the host fold drops
  them, so a scaled state is compared on the slots that can be output;
* its finalize_arrays equal NumpyEngine's element for element;
* the scaled runs grow past the initial capacity, at the migration and
  after it;
* xwide k (>= 64) stays on the host fold.
"""

import numpy as np
import pytest
import torch

from finch_tpu.models import params as jparams
from finch_tpu.models.engine import NumpyEngine as JaxNumpyEngine
from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.engine import (HybridEngine, NumpyEngine,
                                           TorchEngine)
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk_wide as tbw

torch.set_num_threads(2)

B, NBATCH, MIGRATE_AFTER = 4096, 10, 4  # lanes, batches, host batches
POOL = 2048          # codes shared by every batch (runs across batches)
SCALE = 0.5          # scaled: half of all hashes are below max_hash
WIDE_KS = [32, 51, 62, 63]


def _batches(k: int, seed: int):
    """NBATCH batches: half of each drawn from a shared pool, half fresh
    codes (so a scaled state keeps growing), with runs inside a batch and
    lengths that vary (no batch fills the engine's lanes exactly)."""
    rng = np.random.default_rng(seed * 100 + k)
    hi_bits = 2 * k - 64

    def codes(n):
        lo = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        hi = rng.integers(0, 2**hi_bits, size=n, dtype=np.uint64)
        if hi_bits:  # at k = 32 the whole code is in lo
            top = rng.integers(0, 2, size=n).astype(bool)
            hi[top] |= np.uint64(1 << (hi_bits - 1))  # base 0 is G or T
        return lo, hi

    pool_lo, pool_hi = codes(POOL)
    out = []
    for i in range(NBATCH):
        n = B - 37 * i
        idx = rng.integers(0, POOL, size=n - n // 2)
        lo, hi = codes(n // 2)
        plo = np.concatenate([pool_lo[idx], lo])
        phi = np.concatenate([pool_hi[idx], hi])
        plo[:64], phi[:64] = plo[-64:], phi[-64:]  # runs inside a batch
        rc = rng.integers(0, 2, size=n, dtype=np.uint8)
        out.append(((plo, phi), rc))
    return out


def _params(cls, k: int, scheme: str):
    """cls is either package's SketchParams."""
    if scheme == "mash":
        return cls.mash(kmers_to_sketch=500, final_size=500,
                        kmer_length=k, no_strict=True)
    return cls.scaled(kmers_to_sketch=64, scale=SCALE, kmer_length=k)


def _raw(state, keep=None):
    """The raw state's first `keep` slots (all with None), with bit 1 of
    phirc cleared."""
    h, c, e, plo, phirc = (a[:keep] for a in tbw.state_to_numpy(state))
    return h, c, e, plo, phirc & ~np.uint64(2)


def _retained(params, state) -> int:
    """The slots of a scaled state that the retention rule can still
    output: all hashes <= max_hash and enough above it to make up the
    size. Below counts only grow, so a slot past them never reaches a
    sketch."""
    h, c = tbw.state_to_numpy(state)[:2]
    below = int(((c > 0) & (h <= np.uint64(params.max_hash()))).sum())
    return max(below, params.kmers_to_sketch)


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
@pytest.mark.parametrize("k", WIDE_KS)
def test_hybrid_wide_migrates_and_matches(k, scheme):
    params = _params(SketchParams, k, scheme)
    batches = _batches(k, 0)
    # the switch point is the k-mers of the first MIGRATE_AFTER batches
    # exactly: the engine migrates once it has seen that many
    switch = sum(len(p[0]) for p, _ in batches[:MIGRATE_AFTER])
    hyb = HybridEngine(params, device="cpu", switch_after=switch)
    ref = TorchEngine(params, device="cpu")
    jax_np = JaxNumpyEngine(_params(jparams.SketchParams, k, scheme))
    cap0 = ref.capacity
    seen = 0
    rc_bit_differs = False
    for i, (packed, rc) in enumerate(batches):
        migrated = hyb._dev is not None
        for eng in (hyb, ref, jax_np):
            eng.update(packed, rc)
        if not migrated:
            seen += len(packed[0])
            assert hyb._seen == seen
        if i < MIGRATE_AFTER - 1:
            assert hyb._dev is None and hyb._host is not None
            continue
        assert hyb._dev is not None and hyb._host is None, f"batch {i}"
        assert hyb._dev.capacity == ref.capacity
        # a mash state is all retained; a scaled TorchEngine also holds
        # hashes past the retained ones, which the host fold dropped
        keep = None if scheme == "mash" else _retained(params, ref.state)
        for a, b in zip(_raw(hyb._dev.state, keep), _raw(ref.state, keep)):
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
        phirc_h = tbw.state_to_numpy(hyb._dev.state)[4]
        phirc_t = tbw.state_to_numpy(ref.state)[4]
        rc_bit_differs |= bool((phirc_h != phirc_t).any())
    assert seen == switch
    # the masked bit did differ, and no output sees it
    assert rc_bit_differs
    steps = NBATCH - MIGRATE_AFTER
    if scheme == "mash":
        assert hyb.stats["wide"] == steps
    else:
        # grew at the migration and after it (a step redone at the new
        # capacity)
        assert hyb.stats["wide"] > steps and hyb._dev.capacity > 2 * cap0
    got = hyb.finalize_arrays()
    for want in (jax_np.finalize_arrays(), ref.finalize_arrays()):
        for a, b in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [51, 63])
def test_hybrid_wide_small_stream_stays_on_host(k):
    params = _params(SketchParams, k, "mash")
    hyb = HybridEngine(params, device="cpu")  # the default switch point
    host = NumpyEngine(params)
    for packed, rc in _batches(k, 1)[:3]:
        hyb.update(packed, rc)
        host.update(packed, rc)
    assert hyb._dev is None and hyb.stats == {}
    for a, b in zip(hyb.finalize(), host.finalize()):
        assert a == b


def test_wide_state_from_numpy_roundtrip():
    """k = 63 codes with the top bits of phi set: state_arrays gives back
    what state_from_numpy was given, pads follow, a state too small
    refuses."""
    rng = np.random.default_rng(5)
    n, cap = 40, 64
    h = np.unique(rng.integers(0, 2**64, size=n, dtype=np.uint64))
    assert len(h) == n
    c = rng.integers(1, 9, size=n, dtype=np.uint64)
    e = rng.integers(0, 2, size=n, dtype=np.uint64)
    plo = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    phi = rng.integers(0, 2**62, size=n, dtype=np.uint64) | np.uint64(3 << 60)
    state = tbw.state_from_numpy(h, c, e, plo, phi, cap)
    for a, b in zip(tbw.state_arrays(state), (h, c, e, plo, phi)):
        np.testing.assert_array_equal(a, b)
    raw = tbw.state_to_numpy(state)
    assert (raw[0][n:] == np.uint64(2**64 - 1)).all()
    assert all((x[n:] == 0).all() for x in raw[1:])
    assert (raw[4][:n] & np.uint64(3) == 1).all()
    assert (u64.shr(state[4], 62)[:n] == 3).all()
    with pytest.raises(FinchMessageError, match="do not fit"):
        tbw.state_from_numpy(h, c, e, plo, phi, n - 1)


def test_hybrid_xwide_stays_on_host():
    k = 70
    params = SketchParams.mash(kmers_to_sketch=50, final_size=50,
                               kmer_length=k, no_strict=True)
    hyb = HybridEngine(params, device="cpu", switch_after=100)
    host = NumpyEngine(params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        kb = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, size=(300, k))]
        rc = rng.integers(0, 2, size=300, dtype=np.uint8)
        hyb.update(kb, rc)
        host.update(kb, rc)
    assert hyb._dev is None
    for a, b in zip(hyb.finalize(), host.finalize()):
        assert a == b
