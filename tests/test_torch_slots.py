"""The slot path of TorchEngine and HybridEngine (k <= 31) on the CPU.

`sketch_stream` has the reader parse each batch into one of the engine's
slots (`next_slot`, on the parse thread) and hands it back with
`submit(slot, n)`, which copies the slot's first n lanes to the device
planes and zeroes their padding there. Against the `NumpyEngine` oracle,
integers throughout, so every comparison is exact:

* slot-fed sketches equal the oracle's, mash and scaled at k = 15, 21
  and 31, with every slot's tail past n filled with garbage before
  `submit` and a last batch shorter than its padded width, so that the
  device planes' tail holds the batch before it unless zeroed;
* HybridEngine fed by slots host-folds on the cold rule and migrates, or
  moves at once on a warm card, to the same result, its ring kept across
  the move;
* at k = 51 neither engine takes slots and `stats["slot_steps"]` stays 0;
* through `sketch_stream` at k = 21, `stats["slot_steps"]` equals the
  `engine.step` calls and `engine.slot_wait` counts every slot handed out;
* a batch that raises closes the ring and ends the stream.
"""

import os

import numpy as np
import pytest
import torch

from finch_tpu_torch.core import sketching
from finch_tpu_torch.models import engine as eng
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.utils import get_meter

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
READS_FQ = os.path.join(HERE, "data", "reads.fastq")
B = 4096                      # lanes a batch (the engines' batch_size)
SIZES = (B, 3000, B, 1500)    # the last batch pads to 2048 lanes


def _params(scheme: str, k: int):
    if scheme == "mash":
        return SketchParams.mash(kmers_to_sketch=500, final_size=500,
                                 kmer_length=k, no_strict=True)
    # half of all hashes lie below max_hash: the state grows
    return SketchParams.scaled(kmers_to_sketch=64, scale=0.5, kmer_length=k)


def _batches(k: int, seed: int):
    """(packed, rc) batches of SIZES k-mers, half of each drawn from a
    pool shared by all (counts across batches)."""
    rng = np.random.default_rng(seed * 100 + k)
    pool = rng.integers(0, 4 ** k, size=B // 2, dtype=np.uint64)
    out = []
    for n in SIZES:
        pk = rng.integers(0, 4 ** k, size=n, dtype=np.uint64)
        pk[: n // 2] = pool[rng.integers(0, len(pool), size=n // 2)]
        out.append((pk, rng.integers(0, 2, size=n, dtype=np.uint8)))
    return out


def _feed(engine, batches, rng) -> None:
    """Each batch through a slot, as sketch_stream does, with the slot's
    planes filled with garbage before the batch's lanes go in."""
    for packed, rc in batches:
        n = len(packed)
        slot = engine.next_slot()
        for plane in (slot.lo, slot.hi):
            plane[:] = rng.integers(0, 2 ** 32, size=len(plane),
                                    dtype=np.uint32)
        slot.lo[:n], slot.hi[:n] = eng.composite_planes(packed, rc)
        engine.submit(slot, n)
    engine.submit(engine.next_slot(), 0)  # the stream's end gives one back


def _oracle(params, batches):
    ref = eng.NumpyEngine(params)
    for packed, rc in batches:
        ref.update(packed, rc)
    return ref.finalize_arrays()


def _assert_arrays_equal(got, want) -> None:
    for a, b in zip((*got[:3], got[3]), (*want[:3], want[3])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_slot_path_matches_oracle(k, scheme):
    params = _params(scheme, k)
    batches = _batches(k, seed=1)
    engine = eng.TorchEngine(params, batch_size=B, device="cpu")
    assert engine.takes_slots
    _feed(engine, batches, np.random.default_rng(7))
    assert engine.stats["slot_steps"] == len(batches)
    # the last step's device planes: its lanes, then zeros to the padded
    # width (no garbage from the slot, no lane of the batch before)
    n = SIZES[-1]
    lo, hi = engine._planes[:, :2048].numpy().view(np.uint32)
    want_lo, want_hi = eng.composite_planes(*batches[-1])
    np.testing.assert_array_equal(lo[:n], want_lo)
    np.testing.assert_array_equal(hi[:n], want_hi)
    assert not lo[n:].any() and not hi[n:].any()
    _assert_arrays_equal(engine.finalize_arrays(), _oracle(params, batches))
    assert engine._ring is None  # finalize released it


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
@pytest.mark.parametrize("rule", ["cold", "warm"])
def test_hybrid_slot_path_folds_then_migrates(rule, scheme, monkeypatch):
    """Cold: the host folds the slots of the first two batches, migrates
    after them and steps the rest on the device. Warm: it moves before the
    first batch and folds nothing on the host."""
    params = _params(scheme, 21)
    batches = _batches(21, seed=2)
    if rule == "warm":
        monkeypatch.setattr(eng, "card_is_warm", lambda dev: True)
        monkeypatch.setitem(eng.WARM_SWITCH_AFTER, False, 1)
    folds = get_meter("engine.host_fold").calls
    hyb = eng.HybridEngine(params, batch_size=B, switch_after=B + 3000,
                           device="cpu")
    assert hyb.takes_slots
    first = hyb.next_slot()
    hyb.submit(first, 0)
    ring = hyb._ring
    _feed(hyb, batches, np.random.default_rng(8))
    on_host = 2 if rule == "cold" else 0
    assert get_meter("engine.host_fold").calls - folds == on_host
    assert hyb._seen == sum(SIZES[:on_host])
    assert hyb._dev is not None
    assert hyb.stats["slot_steps"] == len(batches) - on_host
    # the move kept the ring; plain memory on the CPU
    assert hyb._ring is ring and not first.planes.is_pinned()
    _assert_arrays_equal(hyb.finalize_arrays(), _oracle(params, batches))
    assert hyb._ring is None


def _sketch(params, backend, engine_out=None):
    filters = FilterParams(filter_on=None, err_filter=0.21,
                           strand_filter=0.1)
    return sketching.sketch_stream(READS_FQ, "reads", params, filters,
                                   backend=backend, batch_size=1 << 14,
                                   device="cpu", engine_out=engine_out)


@pytest.mark.parametrize("k", [21, 51])
def test_sketch_stream_slot_steps(k):
    """k = 21 steps every batch from a slot: one `engine.step` and one
    `slot_steps` a batch, and one `engine.slot_wait` a slot handed out
    (the batches and the empty one that ends the stream). k = 51 takes
    the wide update path: no slot, no slot step."""
    params = _params("mash", k)
    names = ("engine.step", "engine_kmers", "engine.slot_wait")
    before = {n: get_meter(n).calls for n in names}
    engines = []
    sk = _sketch(params, "torch", engines)
    calls = {n: get_meter(n).calls - before[n] for n in names}
    stats = engines[0].stats
    if k == 21:
        assert engines[0].takes_slots
        assert stats["slot_steps"] == calls["engine.step"] \
            == calls["engine_kmers"] >= 3
        assert calls["engine.slot_wait"] == calls["engine_kmers"] + 1
    else:
        assert not engines[0].takes_slots
        assert not eng.HybridEngine(params, device="cpu").takes_slots
        assert stats.get("slot_steps", 0) == 0 and stats["wide"] >= 3
        assert calls["engine.slot_wait"] == 0
    assert sk.hashes == _sketch(params, "numpy").hashes


@pytest.mark.parametrize("which", ["torch", "hybrid"])
def test_raising_batch_closes_the_ring(which, monkeypatch):
    made = []

    def make(sketch_params, backend, batch_size, device):
        cls = eng.TorchEngine if which == "torch" else eng.HybridEngine
        kw = {} if which == "torch" else {"switch_after": 1}
        made.append(cls(sketch_params, batch_size=batch_size, device=device,
                        **kw))
        return made[-1]

    steps = []
    step_planes = eng.TorchEngine.step_planes

    def step(self, lo, hi, n):
        steps.append(n)
        if len(steps) == 2:
            raise RuntimeError("step failed")
        step_planes(self, lo, hi, n)

    monkeypatch.setattr(sketching, "_make_engine", make)
    monkeypatch.setattr(eng.TorchEngine, "step_planes", step)
    open_before = eng._open_streams
    with pytest.raises(RuntimeError, match="step failed"):
        _sketch(_params("mash", 21), "torch")
    engine = made[0]
    assert engine._ring is None
    # the stream that raised no longer counts as open, though the
    # traceback still holds its engine
    assert eng._open_streams == open_before
    card = engine if which == "torch" else engine._dev
    assert len(steps) == 2 and card._planes is None
