"""The mesh (ShardedSketchEngine) on CPU shards, and the kernels' launch
counters under threads: every shard reaches its read before the round's one wait, the
kernel wrappers' launch counters lose no increment under 8 threads, the
engine leaves no thread behind, the persistent upload buffers are
reused, the CLI's 4-shard mesh gives the golden bytes, and the mesh's
states equal the JAX package's mesh program on the same batches."""

import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

from finch_tpu.models.params import SketchParams as JSketchParams
from finch_tpu.native import KmerReader
from finch_tpu.ops import bottomk as jbk
from finch_tpu.parallel import ShardedSketchEngine as JSharded
from finch_tpu.parallel import make_mesh as jmake_mesh
from finch_tpu_torch import cli as tcli
from finch_tpu_torch import parallel as tparallel
from finch_tpu_torch.core import sketching
from finch_tpu_torch.models import engine as teng
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk as tbk
from finch_tpu_torch.ops import cuda_lib, dedup, extract
from finch_tpu_torch.parallel import ShardedSketchEngine, make_mesh
from finch_tpu_torch.parallel import sharded_sketch
from finch_tpu_torch.parallel.sharded_sketch import sharded_state_to_numpy

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_SK = os.path.join(HERE, "data", "goldens", "query_mash_n10.sk")
TIMEOUT = 60


def _random_batches(seed, n, size):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 4 ** 21, size=size, dtype=np.uint64),
             rng.integers(0, 2, size=size, dtype=np.uint8))
            for _ in range(n)]


def _rows(kmers):
    return [(x.hash, x.kmer, x.count, x.extra_count) for x in kmers]


def test_shards_step_at_once(monkeypatch):
    """The lockstep's rounds: each runs all 8 shards' steps to their next
    read before the one host wait that answers them all, so the first
    round asks 8 values at once (a serial loop of shards would ask one).
    The sketch is NumpyEngine's."""
    params = SketchParams.mash(kmers_to_sketch=100, final_size=100)
    mesh = ShardedSketchEngine(params, make_mesh(8, device="cpu"),
                               batch_size_per_device=512)
    read = sharded_sketch._read_together
    asked = []

    def spy(tensors):
        asked.append(len(tensors))
        return read(tensors)

    monkeypatch.setattr(sharded_sketch, "_read_together", spy)
    batches = _random_batches(1, 2, 3000)
    for pk, rc in batches:
        mesh.update(pk, rc)
    monkeypatch.undo()
    # 2 updates of 3000 k-mers, each one step of 8 shards
    assert asked[0] == 8 and len(asked) == mesh.stats["syncs"]
    assert sum(asked) == mesh.stats["shard_reads"]
    nump = teng.NumpyEngine(params)
    for pk, rc in batches:
        nump.update(pk, rc)
    assert _rows(mesh.finalize()) == _rows(nump.finalize())


def test_launch_counters_lose_no_increment():
    """8 threads add to the four launch counters through cuda_lib.count
    with the interpreter switching threads every microsecond: no
    increment is lost."""
    counters = [(extract.extract_candidates, "launches"),
                (extract.extract_candidates, "launches_weighted"),
                (dedup.dedup_candidates, "launches"),
                (dedup.dedup_slab_candidates, "launches")]
    saved = [getattr(f, n) for f, n in counters]
    per_thread = 5000

    def launch():
        for j in range(per_thread):
            cuda_lib.count(*counters[j % 4])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for f, n in counters:
            setattr(f, n, 0)
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        got = [getattr(f, n) for f, n in counters]
    finally:
        sys.setswitchinterval(interval)
        for (f, n), v in zip(counters, saved):
            setattr(f, n, v)
    assert got == [8 * per_thread // 4] * 4


def test_finalize_leaves_no_thread():
    """The engine steps its shards from the caller's thread: updates and
    finalize start no thread, so engines made in a pool (sketch_files)
    leave none behind."""
    params = SketchParams.mash(kmers_to_sketch=50, final_size=50)
    before = set(threading.enumerate())
    mesh = ShardedSketchEngine(params, make_mesh(4, device="cpu"),
                               batch_size_per_device=512)
    batches = _random_batches(2, 2, 2000)
    for pk, rc in batches:
        mesh.update(pk, rc)
    got = mesh.finalize_arrays()
    assert set(threading.enumerate()) == before
    nump = teng.NumpyEngine(params)
    for pk, rc in batches:
        nump.update(pk, rc)
    for g, w in zip(got, nump.finalize_arrays()):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
def test_upload_buffers_reused(scheme):
    """Batches of 6000, 700, 8192, 10 and 5000 k-mers over 4 CPU shards:
    the two upload buffers are made at the first two steps and reused
    after (a step of 1024-lane shards uses the front of the 2048-lane
    buffer), and whatever a shard's lanes past its k-mers held from an
    earlier step, the sketch is NumpyEngine's."""
    params = (SketchParams.mash(kmers_to_sketch=60, final_size=60)
              if scheme == "mash"
              else SketchParams.scaled(kmers_to_sketch=10, scale=0.05))
    mesh = ShardedSketchEngine(params, make_mesh(4, device="cpu"),
                               batch_size_per_device=2048)
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 4 ** 21, size=n, dtype=np.uint64),
                rng.integers(0, 2, size=n, dtype=np.uint8))
               for n in (6000, 700, 8192, 10, 5000)]
    made = []
    for pk, rc in batches:
        mesh.update(pk, rc)
        made.append(tuple(b.data_ptr() if b is not None else None
                          for b in mesh._bufs))
    assert made[1][0] is not None and made[1][1] is not None
    assert made[1:] == [made[1]] * 4
    assert "upload_waits" not in mesh.stats
    nump = teng.NumpyEngine(params)
    for pk, rc in batches:
        nump.update(pk, rc)
    assert _rows(mesh.finalize()) == _rows(nump.finalize())


def test_cli_four_shard_mesh_matches_golden(monkeypatch, tmp_path):
    """`finch sketch --backend mesh --device cpu` over a 4-shard CPU mesh:
    the mesh takes the JAX package's split of the CLI's 2M batch (4
    shards of 512k lanes, the reader asked for the batch itself), its
    lockstep rounds ask every shard, and the bytes are the golden's."""
    monkeypatch.chdir(REPO)   # the golden names its input by this path
    monkeypatch.setattr(tparallel, "make_mesh",
                        lambda device: make_mesh(4, device=device))
    asked, built = [], []
    choose = sketching._choose_reader
    make = teng._mesh_engine

    def spy_reader(source, k, canonical, batch_size, **kw):
        asked.append(batch_size)
        return choose(source, k, canonical, batch_size, **kw)

    def spy_engine(*a, **kw):
        built.append(make(*a, **kw))
        return built[-1]

    monkeypatch.setattr(sketching, "_choose_reader", spy_reader)
    monkeypatch.setattr(teng, "_mesh_engine", spy_engine)
    out = tmp_path / "mesh4"
    tcli.run(["sketch", "--n-hashes", "10", "--backend", "mesh", "--device",
              "cpu", "tests/data/query.fa", "-o", str(out)])
    [eng] = built
    assert eng.n_local == 4 and eng.bpd == 1 << 19
    assert asked == [1 << 21]
    assert eng.stats["shard_reads"] > eng.stats["syncs"] > 0
    with open(GOLDEN_SK, "rb") as f:
        assert (tmp_path / "mesh4.sk").read_bytes() == f.read()


def _random_fasta(seed, nrec, lo=50, hi=800):
    rnd = random.Random(seed)
    seqs = ["".join(rnd.choice("ACGTN") for _ in range(rnd.randint(lo, hi)))
            for _ in range(nrec)]
    return "".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)).encode()


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
def test_threaded_states_equal_jax_mesh(scheme):
    """The JAX package's mesh program on 4 virtual devices and the port's
    lockstep mesh on 4 CPU shards fold the same batches: every shard's
    flushed state is equal row for row, and so are the sketches."""
    kw = (dict(kmers_to_sketch=40, final_size=40, no_strict=True,
               kmer_length=11) if scheme == "mash"
          else dict(kmers_to_sketch=10, kmer_length=11, scale=0.05))
    jp = getattr(JSketchParams, scheme)(**kw)
    tp = getattr(SketchParams, scheme)(**kw)
    batches = list(KmerReader(_random_fasta(31, 5), k=11, batch_size=2500))
    jeng = JSharded(jp, jmake_mesh(4), batch_size_per_device=512)
    port = ShardedSketchEngine(tp, make_mesh(4, device="cpu"),
                               batch_size_per_device=512)
    for pk, rc in batches:
        jeng.update(pk, rc)
        port.update(pk, rc)
    mh = tp.max_hash() or 0
    # flushed from host rows (indexing the sharded state is a program over
    # every device: see test_torch_parallel.py's fixture)
    raw = [np.asarray(x) for x in jeng.state]
    jflushed = [jbk.flush_state(tuple(x[i] for x in raw), np.uint64(mh),
                                k=11, seed=0)[0] for i in range(4)]
    saved = port.state
    port.state = [tbk.flush_state(s, mh, k=11, seed=0)[0] for s in saved]
    got = sharded_state_to_numpy(port)
    port.state = saved
    for j, g in enumerate(got):
        w = np.stack([np.asarray(s[j]) for s in jflushed])
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert port.capacity == jeng.capacity
    assert _rows(port.finalize()) == _rows(jeng.finalize())
