"""The process mesh (parallel/process_mesh.py) on the CPU: one pool of two
CPU worker processes (logical cards) for the module, its sketches held
against the frozen golden, the JAX package's CLI and the port's torch
backend, byte for byte; a scaled run in which every worker grows its own
state; two files through sketch_files on one pool; a worker that raises
and a worker that is killed, each making the parent raise in time and
leave no process and no shared memory behind; the readers' fill in place
against their plain iteration; the route on several cards."""

import os
import signal
import threading

import numpy as np
import pytest
import torch

from finch_tpu import cli as jcli
from finch_tpu_torch import cli as tcli
from finch_tpu_torch.core import sketching
from finch_tpu_torch.errors import FinchError
from finch_tpu_torch.models import engine as teng
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.native import KmerReader, StreamingParallelReader
from finch_tpu_torch.parallel import ShardedSketchEngine, make_mesh
from finch_tpu_torch.parallel import process_mesh
from finch_tpu_torch.parallel.process_mesh import ProcessMeshEngine, get_pool
from finch_tpu_torch.tools.mesh_cards import busy_overlap, parse_alone

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "data", "goldens")
QUERY_REL = "tests/data/query.fa"
READS_REL = "tests/data/reads.fastq"
DEVICES = ("cpu", "cpu")
BATCH = 1 << 14     # reads.fastq's 96,000 k-mers: 6 batches, 3 a worker
FAIL_BATCH = 1 << 12  # the failure tests' own pools
TIMEOUT = 60        # a failure must surface well inside this


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    # inputs are named by repo-relative paths, as in the goldens
    monkeypatch.chdir(REPO)


@pytest.fixture(scope="module")
def pool():
    """The module's pool of two CPU workers, started once."""
    p = get_pool(DEVICES, BATCH)
    p.wait_ready()
    yield p
    p.close()


def _route(monkeypatch) -> list:
    """From here on in the test, sketch_stream folds with a
    ProcessMeshEngine on the module's pool; returns the engines built."""
    built = []

    def make(params, *a, **kw):
        built.append(ProcessMeshEngine(params, DEVICES, batch_size=BATCH))
        return built[-1]

    monkeypatch.setattr(sketching, "_make_engine", make)
    return built


def _sk(cli, tmp_path, name, args) -> bytes:
    out = tmp_path / name
    cli.run(["sketch", *args, "-o", str(out)])
    return (tmp_path / f"{name}.sk").read_bytes()


def _alive(pids) -> list:
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        alive.append(pid)
    return alive


def test_mash_query_matches_golden(pool, monkeypatch, tmp_path):
    built = _route(monkeypatch)
    got = _sk(tcli, tmp_path, "pm", ["--n-hashes", "10", "--backend", "mesh",
                                     "--device", "cpu", QUERY_REL])
    with open(os.path.join(GOLD, "query_mash_n10.sk"), "rb") as f:
        assert got == f.read()
    assert len(built) == 1 and built[0].pool is pool


def test_reads_cli_defaults_match_jax_and_torch(pool, monkeypatch,
                                                tmp_path):
    want = _sk(jcli, tmp_path, "jax", ["--backend", "numpy", READS_REL])
    torch_cpu = _sk(tcli, tmp_path, "torch", ["--backend", "torch",
                                              "--device", "cpu", READS_REL])
    built = _route(monkeypatch)
    got = _sk(tcli, tmp_path, "pm", ["--backend", "mesh", "--device", "cpu",
                                     READS_REL])
    assert got == want == torch_cpu
    stats = built[0].stats
    # batch i went to worker i mod 2; this process launched no kernel
    assert stats["worker_steps"] == [3, 3]
    assert stats["launches"] == dict.fromkeys(process_mesh.KERNELS, 0)


def test_scaled_workers_grow_apart_and_match_jax(pool, monkeypatch,
                                                 tmp_path):
    args = ["-s", "scaled", "--scale", "0.5", "--n-hashes", "64", READS_REL]
    want = _sk(jcli, tmp_path, "jax", ["--backend", "numpy", *args])
    built = _route(monkeypatch)
    got = _sk(tcli, tmp_path, "pm", ["--backend", "mesh", "--device", "cpu",
                                     *args])
    assert got == want
    first = max(2 * 64, 1 << 12)
    caps = built[0].stats["capacities"]
    # the lockstep mesh over two CPU shards, the JAX package's growth
    # rule: every shard grows to the `below` summed over the shards
    lockstep = []
    monkeypatch.setattr(sketching, "_make_engine", lambda p, *a, **kw: (
        lockstep.append(ShardedSketchEngine(p, make_mesh(2, device="cpu"),
                                            batch_size_per_device=BATCH // 2))
        or lockstep[-1]))
    assert _sk(tcli, tmp_path, "lockstep", ["--backend", "mesh", "--device",
                                            "cpu", *args]) == want
    # each worker grew on its own `below`, to less than that
    assert len(caps) == 2 and all(first < c < lockstep[0].capacity
                                  for c in caps), (caps, lockstep[0].capacity)


def test_two_files_share_one_pool(pool, monkeypatch):
    pids = list(pool.worker_pids)
    params = SketchParams.mash(kmers_to_sketch=100, final_size=100)
    filters = FilterParams(filter_on=None, err_filter=0.0, strand_filter=0.0)
    want = sketching.sketch_files([QUERY_REL, READS_REL], params, filters,
                                  backend="numpy", device="cpu")
    built = _route(monkeypatch)
    # two threads, a serial reader each, on the one pool
    got = sketching.sketch_files([QUERY_REL, READS_REL], params, filters,
                                 backend="mesh", device="cpu", max_workers=2)
    assert [[(h.hash, h.kmer, h.count) for h in s.hashes] for s in got] == \
        [[(h.hash, h.kmer, h.count) for h in s.hashes] for s in want]
    assert len(built) == 2 and all(e.pool is pool for e in built)
    assert pool.worker_pids == pids and not pool.closed
    assert get_pool(DEVICES, BATCH) is pool


def test_update_arrays_match_numpy_engine(pool):
    """update() with packed arrays (no parse into slots), mash, several
    batches a call: NumpyEngine's sketch."""
    rng = np.random.default_rng(5)
    params = SketchParams.mash(kmers_to_sketch=500, final_size=500)
    eng = ProcessMeshEngine(params, DEVICES, batch_size=BATCH)
    ref = teng.NumpyEngine(params)
    for _ in range(2):
        pk = rng.integers(0, 4 ** 21, size=3 * BATCH + 77, dtype=np.uint64)
        rc = rng.integers(0, 2, size=len(pk), dtype=np.uint8)
        eng.update(pk, rc)
        ref.update(pk, rc)
    got = eng.finalize_arrays()
    assert all(np.array_equal(x, y) for x, y in zip(got, ref.finalize_arrays()))
    assert sum(eng.stats["worker_steps"]) == 8


def test_merge_flushed_equals_merge_states():
    """The parent's NumPy merge against bottomk.merge_states on four
    flushed TorchEngine states that share k-mers (mash, equal
    capacities)."""
    from finch_tpu_torch import u64
    from finch_tpu_torch.ops import bottomk

    rng = np.random.default_rng(7)
    params = SketchParams.mash(kmers_to_sketch=300, final_size=300)
    common = rng.integers(0, 4 ** 21, size=2000, dtype=np.uint64)
    parts, states = [], []
    for w in range(4):
        eng = teng.TorchEngine(params, batch_size=4096, device="cpu")
        pk = np.concatenate([common, rng.integers(0, 4 ** 21, size=3000,
                                                  dtype=np.uint64)])
        eng.update(pk, rng.integers(0, 2, size=len(pk), dtype=np.uint8))
        parts.append(eng._host_state())
        states.append(bottomk.flush_state(eng.state, eng._mh, k=21,
                                          seed=params.hash_seed)[0])
    want = bottomk.merge_states(states, k=21, seed=params.hash_seed)
    got = process_mesh.merge_flushed(parts, 300)
    real = u64.to_numpy(want[1]) > 0
    assert all(np.array_equal(g, u64.to_numpy(w)[real])
               for g, w in zip(got, want[:4]))
    assert (got[1] == 4).any()  # the shared k-mers' counts added up


def _bounded(fn):
    """fn() in a thread; its exception, which must come within TIMEOUT."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as err:  # handed to the test
            out["err"] = err

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), f"no error within {TIMEOUT} s"
    return out.get("err")


def _assert_gone(pool, pids, names) -> None:
    assert pool.closed
    assert not _alive(pids), "a worker outlived the pool"
    for name in names:
        assert not os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))
    assert pool not in process_mesh._pools.values()


def test_killed_worker_raises_and_leaves_nothing():
    params = SketchParams.mash(kmers_to_sketch=100, final_size=100)
    eng = ProcessMeshEngine(params, DEVICES, batch_size=FAIL_BATCH)
    pool = eng.pool
    names = pool.shm_names()
    try:
        pool.wait_ready()
        pids = list(pool.worker_pids)
        rng = np.random.default_rng(1)
        pk = rng.integers(0, 4 ** 21, size=2 * FAIL_BATCH, dtype=np.uint64)
        rc = np.zeros(len(pk), dtype=np.uint8)
        eng.update(pk, rc)
        os.kill(pids[0], signal.SIGKILL)

        def go_on():
            for _ in range(64):  # more batches than the slots hold
                eng.update(pk, rc)
            eng.finalize_arrays()

        err = _bounded(go_on)
        assert isinstance(err, FinchError) and "died" in str(err), err
        _assert_gone(pool, pids, names)
    finally:
        pool.close()


def test_raising_worker_raises_with_its_traceback():
    pool = get_pool(DEVICES, FAIL_BATCH)
    names = pool.shm_names()
    try:
        pool.wait_ready()
        pids = list(pool.worker_pids)
        # TorchEngine refuses k = 64 in the worker (ProcessMeshEngine
        # refuses k > 31 before it gets there)
        pool.open(SketchParams.mash(kmers_to_sketch=10, final_size=10,
                                    kmer_length=64))

        def hand_offs():
            for _ in range(pool.nslots + 1):  # the last waits for a slot
                pool.take_slot(0)

        err = _bounded(hand_offs)
        assert isinstance(err, FinchError), err
        assert "TorchEngine folds k <= 63" in str(err)
        assert "Traceback" in str(err)
        _assert_gone(pool, pids, names)
    finally:
        pool.close()


@pytest.mark.parametrize("reader", ["serial", "parallel"])
def test_fill_in_place_equals_iteration(reader):
    def make():
        if reader == "serial":
            return KmerReader(READS_REL, 21, batch_size=4096, composite=True)
        return StreamingParallelReader(READS_REL, 21, batch_size=4096,
                                       threads=3, composite=True)

    it = make()
    want = [(a.copy(), b.copy()) for a, b in it]
    filled = make()
    lo = np.empty(4096, dtype=np.uint32)
    hi = np.empty(4096, dtype=np.uint32)
    got = []
    while n := filled.fill(lo, hi):
        got.append((lo[:n].copy(), hi[:n].copy()))
    assert filled.fill(lo, hi) == 0
    assert len(got) == len(want) > 20
    assert all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(got, want))
    assert filled.totals == it.totals and filled.format == it.format
    with pytest.raises(FinchError, match="at least 4096"):
        make().fill(lo[:100], hi[:100])


def test_route_over_several_cards(monkeypatch):
    """mesh on two or more cards takes the process mesh over every card;
    auto stays on one card (HybridEngine)."""
    made = []

    class Stub:
        def __init__(self, params, devices, batch_size):
            made.append((list(map(str, devices)), batch_size))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(process_mesh, "ProcessMeshEngine", Stub)
    monkeypatch.setattr(teng, "HybridEngine", lambda p, **kw: "hybrid")
    params = SketchParams.mash(kmers_to_sketch=10, final_size=10)
    assert isinstance(teng.make_engine(params, backend="mesh"), Stub)
    assert teng.make_engine(params) == "hybrid"
    assert made == [([f"cuda:{i}" for i in range(4)], 1 << 21)]
    with pytest.raises(FinchError, match="k <= 31"):
        teng.make_engine(SketchParams.mash(kmers_to_sketch=10, final_size=10,
                                           kmer_length=33), backend="mesh")


def test_busy_overlap_and_parse_alone():
    """mesh_cards' measures: the cards' busy and busy-at-once time from
    each worker's intervals, and the parse alone (every k-mer of the
    file, as plain iteration counts them)."""
    assert busy_overlap([[(0, 10), (5, 20)], [(15, 30)], [(40, 50)]]) == \
        (40, 5)
    got = parse_alone(READS_REL, 21, batch_size=4096)
    assert (got["kmers"], got["batches"]) == (96_000, 24)
