"""The mesh's lockstep step (ShardedSketchEngine._lockstep over
bottomk.sketch_step_gen) against each shard stepped alone through
bottomk.sketch_step, on 8 CPU shards: one host wait a round, the round's
count the most reads any one shard made, the same states and tallies as
the solo steps, and a shard's error out of update()."""

import numpy as np
import pytest
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.models import engine as teng
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk as tbk
from finch_tpu_torch.parallel import ShardedSketchEngine, make_mesh

torch.set_num_threads(2)

SHARD = 1 << 17   # the kernel path's narrowest shard (its plain versions)


def _params(scheme):
    if scheme == "mash":
        return SketchParams.mash(kmers_to_sketch=200, final_size=200)
    return SketchParams.scaled(kmers_to_sketch=100, scale=0.002)


def _stream(seed):
    """Three batches at k = 21: 4 full 128k-lane shards and part of a
    fifth of random k-mers (shards 5-7 get no lane, so their steps take
    another tier and fewer reads); 8 full shards of random ones (the cold
    shards 5-7 now take more reads than the warm ones); 312,144
    duplicates from a small pool, which split into 64k-lane shards (the
    plain path)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4 ** 21, size=1 << 12, dtype=np.uint64)
    out = []
    for n, dup in ((4 * SHARD + 70_000, False), (8 * SHARD, False),
                   (2 * SHARD + 50_000, True)):
        pk = (pool[rng.integers(0, len(pool), size=n)] if dup
              else rng.integers(0, 4 ** 21, size=n, dtype=np.uint64))
        out.append((pk, rng.integers(0, 2, size=n, dtype=np.uint8)))
    return out


def _spy(monkeypatch):
    """Record the arguments of every step coroutine the mesh starts."""
    calls = []
    step_gen = tbk.sketch_step_gen

    def spy(state, lo, hi, nvalid, max_hash, **kw):
        calls.append((state, lo, hi, nvalid, max_hash, kw))
        return step_gen(state, lo, hi, nvalid, max_hash, **kw)

    monkeypatch.setattr(tbk, "sketch_step_gen", spy)
    return calls


def _same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
def test_lockstep_equals_solo_shard_steps(monkeypatch, scheme):
    params = _params(scheme)
    mesh = ShardedSketchEngine(params, make_mesh(8, device="cpu"),
                               batch_size_per_device=SHARD)
    calls = _spy(monkeypatch)
    for pk, rc in _stream(3):
        mesh.update(pk, rc)
    monkeypatch.undo()
    assert len(calls) % 8 == 0
    want = {}
    rounds = 0
    spread = False
    for g in range(0, len(calls), 8):
        outs, reads = [], []
        for state, lo, hi, nvalid, mh, kw in calls[g:g + 8]:
            solo = {}
            outs.append(tbk.sketch_step(state, lo, hi, nvalid, mh,
                                        **{**kw, "stats": solo}))
            reads.append(solo.pop("syncs"))
            for name, n in solo.items():
                want[name] = want.get(name, 0) + n
        rounds += max(reads)
        want["shard_reads"] = want.get("shard_reads", 0) + sum(reads)
        spread |= min(reads) != max(reads)
        if g + 8 < len(calls) and scheme == "mash":
            # the next step starts from what the solo steps made
            for (st, _), nxt in zip(outs, calls[g + 8:g + 16]):
                assert _same_state(st, nxt[0])
    assert spread   # shards made different numbers of reads
    # a scaled step attempt also reads its summed `below` once
    want["syncs"] = rounds + (len(calls) // 8 if scheme == "scaled" else 0)
    assert mesh.stats == want
    assert want["shard_reads"] > want["syncs"]
    for got, (st, _) in zip(mesh.state, outs):
        assert _same_state(got, st)


def test_shard_error_propagates_out_of_update(monkeypatch):
    """A shard whose step raises after its first read stops the update;
    every shard keeps its state from before the step, and the engine
    steps on from there."""
    params = _params("mash")
    mesh = ShardedSketchEngine(params, make_mesh(8, device="cpu"),
                               batch_size_per_device=512)
    rng = np.random.default_rng(4)
    batches = [(rng.integers(0, 4 ** 21, size=3000, dtype=np.uint64),
                rng.integers(0, 2, size=3000, dtype=np.uint8))
               for _ in range(3)]
    mesh.update(*batches[0])
    before = mesh.state
    step_gen = tbk.sketch_step_gen
    started = []

    def failing(gen):
        yield next(gen)
        raise RuntimeError("shard 2: kernel launch failed")

    def spy(*a, **kw):
        started.append(1)
        gen = step_gen(*a, **kw)
        return failing(gen) if len(started) == 3 else gen

    monkeypatch.setattr(tbk, "sketch_step_gen", spy)
    with pytest.raises(RuntimeError, match="shard 2"):
        mesh.update(*batches[1])
    monkeypatch.undo()
    assert mesh.state is before and len(started) == 8
    mesh.update(*batches[2])
    nump = teng.NumpyEngine(params)
    for pk, rc in (batches[0], batches[2]):
        nump.update(pk, rc)
    assert [(x.hash, x.count) for x in mesh.finalize()] == [
        (x.hash, x.count) for x in nump.finalize()]


def test_one_shard_mesh_waits_once_a_read():
    """A one-shard mesh is one coroutine: its syncs are its reads, the
    count sketch_step makes for the same step."""
    params = _params("mash")
    mesh = ShardedSketchEngine(params, make_mesh(1, device="cpu"),
                               batch_size_per_device=SHARD)
    pk, rc = _stream(5)[0]
    pk, rc = pk[:SHARD], rc[:SHARD]
    solo = {}
    lo, hi = teng.composite_planes(pk, rc)
    tbk.sketch_step(tbk.empty_state(mesh.capacity), u64.from_numpy(lo),
                    u64.from_numpy(hi), SHARD, 0, k=21, seed=0,
                    has_max_hash=False, use_kernel=True, stats=solo)
    mesh.update(pk, rc)
    assert mesh.stats["syncs"] == mesh.stats["shard_reads"] == solo["syncs"]


@pytest.mark.parametrize("scheme,want", [
    ("mash", {"small": 4, "syncs": 35, "tier_A": 7, "tier_D": 1}),
    ("scaled", {"small": 5, "syncs": 60, "tier_D": 12}),
])
def test_torch_engine_stats_unchanged(scheme, want):
    """TorchEngine's tallies and host syncs on a fixed stream, as they
    were before the step became a coroutine (sketch_step reads each
    request at once)."""
    params = (SketchParams.mash(kmers_to_sketch=1000, final_size=1000)
              if scheme == "mash" else
              SketchParams.scaled(kmers_to_sketch=100, scale=0.02))
    eng = teng.TorchEngine(params, batch_size=1 << 17, device="cpu")
    rng = np.random.default_rng(8)
    pool = rng.integers(0, 4 ** 21, size=1 << 15, dtype=np.uint64)
    for i in range(4):
        n = 300_000
        pk = (pool[rng.integers(0, len(pool), size=n)] if i % 2
              else rng.integers(0, 4 ** 21, size=n, dtype=np.uint64))
        eng.update(pk, rng.integers(0, 2, size=n, dtype=np.uint8))
    assert eng.stats == want
