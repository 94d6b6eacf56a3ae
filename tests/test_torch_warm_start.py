"""HybridEngine on a warm card, on the CPU.

A card is warm once a TorchEngine step has returned on it in this
process (``engine.card_is_warm``); a CPU TorchEngine never makes a device
warm. These tests force the record for device="cpu" by patching
``card_is_warm``, and cut the warm switch point to a few batches of
random k-mers so that the CPU's plain steps stay small. Integers
throughout, so every comparison is exact:

* on a warm card HybridEngine moves to the TorchEngine before it folds
  the batch that reaches the warm switch point, which the host never
  folds; the batches below it fold on the host and migrate first;
* its sketch equals NumpyEngine's, mash and scaled at k = 21 (composite
  planes, as the parser gives them) and mash at k = 51;
* xwide k stays on the host; an empty record keeps the cold rule, and
  so does a second stream open beside the first;
* ``engine.warm_start`` opens once a warm sketch, around an
  ``engine.migrate`` of no entries;
* the record keeps every device marked from many threads.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import finch_tpu_torch as ft
from finch_tpu_torch.core import sketching
from finch_tpu_torch.models import engine as eng
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.utils import get_meter

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
READS_FQ = os.path.join(HERE, "data", "reads.fastq")
B, NBATCH = 4096, 6          # k-mers a batch, batches a stream
WARM_AT = B + B // 2         # the warm switch point: inside batch 2
SPANS = ("engine.host_fold", "engine.migrate", "engine.warm_start",
         "engine.step")


def _counts() -> dict:
    return {n: (get_meter(n).calls, get_meter(n).items) for n in SPANS}


def _delta(before) -> dict:
    after = _counts()
    return {n: (after[n][0] - before[n][0], after[n][1] - before[n][1])
            for n in SPANS}


@pytest.fixture
def warm(monkeypatch):
    """Every device counts as warm; the warm switch point is WARM_AT."""
    monkeypatch.setattr(eng, "card_is_warm", lambda dev: True)
    for wide in (False, True):
        monkeypatch.setitem(eng.WARM_SWITCH_AFTER, wide, WARM_AT)


def _params(scheme: str, k: int):
    if scheme == "mash":
        return SketchParams.mash(kmers_to_sketch=500, final_size=500,
                                 kmer_length=k, no_strict=True)
    # half of all hashes lie below max_hash: the state grows
    return SketchParams.scaled(kmers_to_sketch=64, scale=0.5, kmer_length=k)


def _batches(k: int, seed: int, first: int = B):
    """NBATCH batches as the readers give them: composite u32 planes for
    k <= 31 (with the (packed, rc) pair NumpyEngine folds), (lo, hi)
    words for wide k. Half of each batch repeats a shared pool; the first
    batch has `first` k-mers."""
    rng = np.random.default_rng(seed * 100 + k)

    def codes(n):
        lo = rng.integers(0, min(4 ** k, 2 ** 64), size=n, dtype=np.uint64)
        if k <= 31:
            return lo
        return lo, rng.integers(0, 2 ** (2 * k - 64), size=n,
                                dtype=np.uint64)

    pool = codes(2048)
    out = []
    for i in range(NBATCH):
        n = first if i == 0 else B - 37 * i
        idx = rng.integers(0, 2048, size=n - n // 2)
        fresh = codes(n // 2)
        rc = rng.integers(0, 2, size=n, dtype=np.uint8)
        if k <= 31:
            packed = np.concatenate([pool[idx], fresh])
            planes = eng.composite_planes(packed, rc)
            out.append((planes, (packed, rc)))
        else:
            packed = tuple(np.concatenate([p[idx], f])
                           for p, f in zip(pool, fresh))
            out.append(((packed, rc), (packed, rc)))
    return out


@pytest.mark.parametrize("first", [WARM_AT, B], ids=["first_batch",
                                                     "second_batch"])
def test_warm_card_hands_off_before_the_batch(warm, first):
    params = _params("mash", 21)
    hyb = eng.HybridEngine(params, device="cpu")
    host = eng.NumpyEngine(params)
    before = _counts()
    folded = on_card = 0
    for i, (planes, pair) in enumerate(_batches(21, 1, first)):
        below = folded + len(pair[1]) < WARM_AT and hyb._dev is None
        hyb.update(*planes)
        host.update(*pair)
        if below:  # the host folds what stays below the point
            folded += len(pair[1])
            assert hyb._dev is None and hyb._seen == folded
        else:
            on_card += 1
            assert hyb._dev is not None and hyb._host is None, f"batch {i}"
    d = _delta(before)
    assert d["engine.step"][0] == on_card == NBATCH - (first < WARM_AT)
    assert d["engine.warm_start"] == (1, 1)
    assert d["engine.host_fold"] == ((0, 0) if first == WARM_AT
                                     else (1, folded))
    assert d["engine.migrate"][0] == 1
    # the migration carries what the host folded: nothing, or batch 1's
    # distinct k-mers
    assert (d["engine.migrate"][1] == 0) == (first == WARM_AT)
    for a, b in zip(hyb.finalize_arrays(), host.finalize_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme,k", [("mash", 21), ("scaled", 21),
                                      ("mash", 51)])
def test_warm_start_equals_numpy_engine(warm, scheme, k):
    params = _params(scheme, k)
    hyb, host = eng.HybridEngine(params, device="cpu"), eng.NumpyEngine(
        params)
    for packed, pair in _batches(k, 2, WARM_AT):
        hyb.update(*packed)
        host.update(*pair)
        assert hyb._dev is not None and hyb._host is None
    if scheme == "scaled":  # grew from an empty state, as torch does
        assert hyb._dev.capacity > max(2 * params.kmers_to_sketch, 1 << 12)
    got, want = hyb.finalize_arrays(), host.finalize_arrays()
    if k > 31:
        got, want = (*got[:3], *got[3]), (*want[:3], *want[3])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_xwide_stays_on_host_when_warm(warm):
    k = 70
    params = SketchParams.mash(kmers_to_sketch=50, final_size=50,
                               kmer_length=k, no_strict=True)
    hyb, host = eng.HybridEngine(params, device="cpu"), eng.NumpyEngine(
        params)
    rng = np.random.default_rng(3)
    before = _counts()
    for _ in range(3):
        kb = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, size=(WARM_AT, k))]
        rc = rng.integers(0, 2, size=WARM_AT, dtype=np.uint8)
        hyb.update(kb, rc)
        host.update(kb, rc)
    assert hyb._dev is None
    assert _delta(before)["engine.warm_start"] == (0, 0)
    for a, b in zip(hyb.finalize(), host.finalize()):
        assert a == b


def test_empty_record_keeps_the_cold_rule(monkeypatch):
    monkeypatch.setattr(eng, "_warm_cards", set())
    for wide in (False, True):
        monkeypatch.setitem(eng.WARM_SWITCH_AFTER, wide, 1)
    assert eng.HybridEngine(_params("mash", 21),
                            device="cpu").switch_after == 4 << 20
    params = _params("mash", 21)
    switch = 3 * B
    hyb = eng.HybridEngine(params, device="cpu", switch_after=switch)
    host = eng.NumpyEngine(params)
    before = _counts()
    seen = folds = 0
    for planes, pair in _batches(21, 3):
        hyb.update(*planes)
        host.update(*pair)
        if seen < switch:  # folded on the host, migrated once past it
            seen += len(pair[1])
            folds += 1
            assert (hyb._dev is not None) == (seen >= switch)
    d = _delta(before)
    assert d["engine.warm_start"] == (0, 0)
    assert d["engine.host_fold"] == (folds, seen) and folds < NBATCH
    assert d["engine.migrate"][0] == 1
    for a, b in zip(hyb.finalize_arrays(), host.finalize_arrays()):
        np.testing.assert_array_equal(a, b)
    # a CPU TorchEngine's steps warm no device
    assert hyb.stats and eng._warm_cards == set()
    assert not eng.card_is_warm(torch.device("cpu"))


def test_streams_side_by_side_keep_the_cold_rule(warm):
    """While a second HybridEngine stream is open the first folds on the
    host past the warm point; once the other finalizes, the first moves
    to the card before its next batch, and finalizes as NumpyEngine."""
    params = _params("mash", 21)
    opened = eng._open_streams
    hyb, host = eng.HybridEngine(params, device="cpu"), eng.NumpyEngine(
        params)
    other = eng.HybridEngine(params, device="cpu")
    assert eng._open_streams == opened + 2
    before = _counts()
    batches = _batches(21, 4, WARM_AT)
    for planes, pair in batches[:2]:
        hyb.update(*planes)
        host.update(*pair)
        assert hyb._dev is None
    other.finalize_arrays()
    for planes, pair in batches[2:]:
        hyb.update(*planes)
        host.update(*pair)
        assert hyb._dev is not None
    d = _delta(before)
    assert d["engine.host_fold"][0] == 2 and d["engine.warm_start"] == (1, 1)
    assert d["engine.migrate"][0] == 1 and d["engine.migrate"][1] > 0
    for a, b in zip(hyb.finalize_arrays(), host.finalize_arrays()):
        np.testing.assert_array_equal(a, b)
    assert eng._open_streams == opened


def test_warm_start_opens_once_a_sketch(warm, monkeypatch):
    """Two sketches through sketch_stream with auto's engine (which
    device="cpu" would route to the fused host fold), each on a warm card
    from its first batch: one warm start, one empty migration and no host
    fold apiece, and the torch backend's sketch."""
    params = ft.SketchParams.mash(kmers_to_sketch=2000, final_size=100)
    filters = ft.FilterParams(filter_on=None, err_filter=0.21,
                              strand_filter=0.1)
    batch = 1 << 14

    def sketch(engines):
        return sketching.sketch_stream(
            READS_FQ, "reads", params, filters, backend="torch",
            batch_size=batch, device="cpu", engine_out=engines)

    want = sketch([])
    monkeypatch.setattr(
        sketching, "_make_engine",
        lambda p, backend, batch_size, device: eng.HybridEngine(
            p, batch_size=batch_size, device=device))
    for _ in range(2):
        engines = []
        before = _counts()
        got = sketch(engines)
        d = _delta(before)
        assert d["engine.warm_start"] == (1, 1)
        assert d["engine.migrate"] == (1, 0)
        assert d["engine.host_fold"] == (0, 0)
        assert engines[0]._dev is not None
        assert got.hashes == want.hashes


def test_warm_record_by_device_under_threads(monkeypatch):
    """64 devices marked from 16 threads at a 1 us switch interval: every
    one is in the record, and only those."""
    monkeypatch.setattr(eng, "_warm_cards", set())
    assert not eng.card_is_warm(torch.device("cuda", 0))
    errors = []

    def mark(offset):
        try:
            for i in range(64):
                eng.mark_card_warm(torch.device("cuda", (i + offset) % 64))
        except Exception as e:  # surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mark, args=(7 * t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert eng._warm_cards == set(range(64))
    assert eng.card_is_warm(torch.device("cuda", 63))
    assert not eng.card_is_warm(torch.device("cuda", 64))
    eng.mark_card_warm(torch.device("cpu"))
    assert not eng.card_is_warm(torch.device("cpu"))
