"""The port's wide step (ops/bottomk_wide.py, 32 <= k <= 63) against
finch_tpu.ops.bottomk_wide on the CPU, on the same numpy inputs made from
a seed: several steps of duplicate-heavy batches with padding lanes
(nvalid < b) and mixed strands, mash and scaled. Integers throughout: the
five state arrays and `below` must be equal element for element after
every step, and so must grow_state, state_arrays and merge_states.

One case departs from the JAX package on purpose: a real hash equal to
u64::MAX keeps its k-mer (the JAX package's hash-only sorts can give it a
pad's zero payload). That case is held against NumpyEngine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finch_tpu.ops import bottomk_wide as jbw
from finch_tpu_torch import u64
from finch_tpu_torch.models import engine as teng
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk_wide as tbw

torch.set_num_threads(2)

CAP, B, STEPS, SEED = 300, 4096, 4, 0
MAX_HASH = (2**64 - 1) // 20  # scaled: 5% of the hash space
MAXU = np.uint64(2**64 - 1)


def _stream(k: int, seed: int, leading_gt: bool = False):
    """STEPS batches of B lanes: codes drawn with repetition from a pool
    (runs within and across batches), rc mixed, nvalid < B."""
    rng = np.random.default_rng(seed + k)
    pool_lo = rng.integers(0, 2**64, size=3 * B, dtype=np.uint64)
    pool_hi = rng.integers(0, 2 ** (2 * k - 64), size=3 * B, dtype=np.uint64)
    if leading_gt:  # base 0 is G or T: the code's top bit is set
        pool_hi |= np.uint64(1 << (2 * k - 65))
    out = []
    for i in range(STEPS):
        idx = rng.integers(0, len(pool_lo), size=B)
        rc = rng.integers(0, 2, size=B, dtype=np.uint8)
        out.append((pool_lo[idx], pool_hi[idx], rc, B - 1 - 97 * i))
    return out


def _jax_state(state):
    return tuple(np.asarray(a) for a in state)


def jax_fold(k, batches, scaled, state=None):
    state = jbw.empty_state(CAP) if state is None else state
    belows = []
    for plo, phi, rc, nv in batches:
        state, below = jbw.sketch_step(
            state, jnp.asarray(plo), jnp.asarray(phi), jnp.asarray(rc),
            jnp.uint32(nv), jnp.uint64(MAX_HASH), k=k, seed=SEED,
            has_max_hash=scaled)
        belows.append(int(below))
    return state, belows


def torch_fold(k, batches, scaled, state=None):
    state = tbw.empty_state(CAP) if state is None else state
    belows = []
    for plo, phi, rc, nv in batches:
        state, below = tbw.sketch_step(
            state, u64.from_numpy(plo), u64.from_numpy(phi),
            torch.from_numpy(rc), nv, MAX_HASH, k=k, seed=SEED,
            has_max_hash=scaled)
        belows.append(int(below))
    return state, belows


def _assert_state_equal(jstate, tstate, what=""):
    for i, (a, b) in enumerate(zip(_jax_state(jstate),
                                   tbw.state_to_numpy(tstate))):
        np.testing.assert_array_equal(b, a, err_msg=f"{what} array {i}")


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("k", [32, 47, 63])
def test_sketch_step_matches_jax(k, scaled):
    batches = _stream(k, 1)
    jstate = jbw.empty_state(CAP)
    tstate = tbw.empty_state(CAP)
    for i, batch in enumerate(batches):
        jstate, jb = jax_fold(k, [batch], scaled, jstate)
        tstate, tb = torch_fold(k, [batch], scaled, tstate)
        _assert_state_equal(jstate, tstate, f"step {i}")
        assert tb == jb, i
    # the state is full and holds runs counted over several batches
    c = tbw.state_to_numpy(tstate)[1]
    assert (c > 0).all() and c.max() > 1
    if scaled:
        assert jb[0] > 0


@pytest.mark.parametrize("k", [47, 62, 63])
def test_grow_and_state_arrays_match_jax(k):
    """grow_state, then a step into the larger state; state_arrays decodes
    the phirc word logically (at k = 63 a leading G/T sets its top bit)."""
    batches = _stream(k, 2, leading_gt=True)
    jstate, _ = jax_fold(k, batches[:2], True)
    tstate, _ = torch_fold(k, batches[:2], True)
    jstate = jbw.grow_state(jstate, 2 * CAP + 7)
    tstate = tbw.grow_state(tstate, 2 * CAP + 7)
    _assert_state_equal(jstate, tstate, "grown")
    jst, _ = jbw.sketch_step(
        jstate, *(jnp.asarray(x) for x in batches[2][:3]),
        jnp.uint32(batches[2][3]), jnp.uint64(MAX_HASH), k=k, seed=SEED,
        has_max_hash=True)
    tst, _ = tbw.sketch_step(
        tstate, u64.from_numpy(batches[2][0]), u64.from_numpy(batches[2][1]),
        torch.from_numpy(batches[2][2]), batches[2][3], MAX_HASH, k=k,
        seed=SEED, has_max_hash=True)
    _assert_state_equal(jst, tst, "after growth")
    got = tbw.state_arrays(tst)
    want = jbw.state_arrays(jst)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    phi = got[4]
    assert len(phi) > CAP
    assert (phi >> np.uint64(2 * k - 65) == 1).all()
    # the phirc word's top set bit is 2k - 63: bit 63 at k = 63
    assert (tbw.state_to_numpy(tst)[4][:len(phi)] >> np.uint64(2 * k - 63)
            == 1).all()


@pytest.mark.parametrize("k", [32, 51])
def test_merge_states_three_shards_equal_one_fold(k):
    batches = _stream(k, 3)[:3]
    jshards = [jax_fold(k, [b], False)[0] for b in batches]
    tshards = [torch_fold(k, [b], False)[0] for b in batches]
    jmerged = jbw.merge_states(jshards)
    tmerged = tbw.merge_states(tshards)
    _assert_state_equal(jmerged, tmerged, "merged")
    jone, _ = jax_fold(k, batches, False)
    tone, _ = torch_fold(k, batches, False)
    _assert_state_equal(jone, tone, "one fold")
    _assert_state_equal(jone, tmerged, "merged vs one fold")


def test_dedup_keeps_payload_of_real_max():
    """Sorted h = [5, 7, MAX, MAX], c = [1, 1, 1, 0]: the real u64::MAX
    entry is followed by a pad in its run and must keep its own payload
    (the JAX package's takes the pad's zeros)."""
    t = lambda v: u64.from_numpy(np.array(v, dtype=np.uint64))
    h = t([5, 7, MAXU, MAXU])
    c = t([1, 1, 1, 0])
    e = t([0, 1, 1, 0])
    plo = t([11, 12, 13, 0])
    phirc = t([3, 3, 7, 0])
    (sh, sc, se, splo, sphirc), below = tbw._dedup_truncate_wide(
        h, c, e, plo, phirc, 4, max_hash=7)
    assert u64.to_numpy(sh).tolist() == [5, 7, MAXU, MAXU]
    assert sc.tolist() == [1, 1, 1, 0]
    assert se.tolist() == [0, 1, 1, 0]
    assert splo.tolist() == [11, 12, 13, 0]
    assert sphirc.tolist() == [3, 3, 7, 0]
    assert int(below) == 2
    # two shards that both hold the real u64::MAX entry, pads after it
    s1 = (h[[0, 2, 3]], c[[0, 2, 3]], e[[0, 2, 3]], plo[[0, 2, 3]],
          phirc[[0, 2, 3]])
    s2 = (h[[1, 2, 3]], c[[1, 2, 3]], e[[1, 2, 3]], plo[[1, 2, 3]],
          phirc[[1, 2, 3]])
    mh, mc, _, mplo, _ = tbw.merge_states([s1, s2])
    assert u64.to_numpy(mh).tolist() == [5, 7, MAXU]
    assert mc.tolist() == [1, 1, 2] and mplo.tolist() == [11, 12, 13]


@pytest.mark.parametrize("scaled", [False, True])
def test_real_max_hash_matches_numpy_engine(monkeypatch, scaled):
    """With a hash that maps one k-mer to u64::MAX, TorchEngine (on the
    CPU) and NumpyEngine give the same sketch, that k-mer's payload
    included, over batches padded to the engine's pow2 lanes."""
    def fake_torch_hash(plo, phi, *, k, seed):
        return plo

    def fake_host_hash(plo, phi, k, seed=0):
        return np.asarray(plo, dtype=np.uint64).copy()

    monkeypatch.setattr(tbw, "hash_packed_kmers_wide", fake_torch_hash)
    monkeypatch.setattr(teng, "murmur3_packed_w", fake_host_hash)
    k = 40
    params = (SketchParams.scaled(kmers_to_sketch=8, scale=0.5,
                                  kmer_length=k) if scaled else
              SketchParams.mash(kmers_to_sketch=4096, final_size=4096,
                                kmer_length=k, no_strict=True))
    rng = np.random.default_rng(7)
    eng_t = teng.TorchEngine(params, device="cpu")
    eng_n = teng.NumpyEngine(params)
    for i in range(3):
        plo = rng.integers(0, 2**63, size=700, dtype=np.uint64)
        phi = rng.integers(0, 2**16, size=700, dtype=np.uint64)
        plo[100 + i] = MAXU          # the u64::MAX k-mer, every batch
        phi[100 + i] = 0xBEEF
        plo[200:260] = plo[300:360]  # runs inside a batch
        phi[200:260] = phi[300:360]
        rc = rng.integers(0, 2, size=700, dtype=np.uint8)
        eng_t.update((plo, phi), rc)
        eng_n.update((plo, phi), rc)
    h_t, c_t, e_t, (lo_t, hi_t) = eng_t.finalize_arrays()
    h_n, c_n, e_n, (lo_n, hi_n) = eng_n.finalize_arrays()
    if not scaled:
        assert h_t[-1] == MAXU and c_t[-1] == 3 and hi_t[-1] == 0xBEEF
    for a, b in ((h_t, h_n), (c_t, c_n), (e_t, e_n), (lo_t, lo_n),
                 (hi_t, hi_n)):
        np.testing.assert_array_equal(a, b)
