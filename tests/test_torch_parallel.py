"""The port's mesh layer (finch_tpu_torch.parallel: ShardedSketchEngine,
sharded_common, all_vs_all_arrays(mesh=), the mesh backend, graft_entry)
against the JAX package's mesh programs on conftest's 8 virtual CPU
devices and against the port's single-device results, on a mesh of CPU
shards in one process. Equality is exact throughout: every output is an
integer."""

import os
import random

import numpy as np
import pytest
import torch

from finch_tpu.models.params import SketchParams as JSketchParams
from finch_tpu.native import KmerReader
from finch_tpu.ops import bottomk as jbk
from finch_tpu.parallel import ShardedSketchEngine as JSharded
from finch_tpu.parallel import make_mesh as jmake_mesh
from finch_tpu.parallel import mxu_dist as jmx
from finch_tpu.parallel import sharded_dist as jsd
from finch_tpu_torch import cli as tcli
from finch_tpu_torch import graft_entry
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models import engine as teng
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.ops import bottomk as tbk
from finch_tpu_torch.parallel import (Mesh, ShardedSketchEngine, make_mesh,
                                      mxu_dist as tmx, sharded_dist as tsd)
from finch_tpu_torch.parallel.sharded_sketch import (sharded_state_from_numpy,
                                                     sharded_state_to_numpy)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
QUERY_REL = "tests/data/query.fa"
GOLDEN_SK = os.path.join(HERE, "data", "goldens", "query_mash_n10.sk")
U64_TOP = np.uint64(2**64 - 1)


def _random_fasta(seed, nrec=4, lo=50, hi=800):
    """tests/test_parallel.py's input."""
    rnd = random.Random(seed)
    seqs = ["".join(rnd.choice("ACGTN") for _ in range(rnd.randint(lo, hi)))
            for _ in range(nrec)]
    return "".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)).encode()


SCHEMES = {
    "mash": dict(kmers_to_sketch=50, final_size=50, no_strict=True,
                 kmer_length=11),
    "scaled": dict(kmers_to_sketch=10, kmer_length=11, scale=0.05),
}


def _params(scheme):
    kw = SCHEMES[scheme]
    return (getattr(JSketchParams, scheme)(**kw),
            getattr(SketchParams, scheme)(**kw))


def _batches(fa, k, batch_size, composite=False):
    return list(KmerReader(fa, k=k, batch_size=batch_size,
                           composite=composite))


def _rows(kmers):
    return [(x.hash, x.kmer, x.count, x.extra_count) for x in kmers]


@pytest.fixture(scope="module", params=sorted(SCHEMES))
def run(request):
    """One stream through the JAX package's sharded engine on 8 virtual
    devices, the port's on 8 CPU shards and NumpyEngine; the JAX engine's
    flushed per-shard rows."""
    scheme = request.param
    jp, tp = _params(scheme)
    batches = _batches(_random_fasta(99, nrec=6), 11, 3000)
    jeng = JSharded(jp, jmake_mesh(8), batch_size_per_device=512)
    teng_ = ShardedSketchEngine(tp, make_mesh(8, device="cpu"),
                                batch_size_per_device=512)
    neng = teng.NumpyEngine(tp)
    for pk, rc in batches:
        for e in (jeng, teng_, neng):
            e.update(pk, rc)
    mh = tp.max_hash() or 0
    # flush host rows: indexing the sharded state (x[i]) is a program over
    # all 8 devices with an all-reduce, whose 8-thread rendezvous a loaded
    # host can hold past XLA's 40 s limit, which aborts the process
    raw = [np.asarray(x) for x in jeng.state]
    jflushed = [jbk.flush_state(tuple(x[i] for x in raw),
                                np.uint64(mh), k=11, seed=0)[0]
                for i in range(8)]
    jrows = tuple(np.stack([np.asarray(s[j]) for s in jflushed])
                  for j in range(7))
    return dict(scheme=scheme, params=tp, jax=_rows(jeng.finalize()),
                jrows=jrows, raw=raw,
                torch=teng_, numpy=_rows(neng.finalize()), batches=batches)


def test_sharded_sketch_equals_jax_and_numpy(run):
    got = _rows(run["torch"].finalize())
    assert got == run["jax"]
    assert got == run["numpy"]
    assert len(got) == (50 if run["scheme"] == "mash" else 10)


def test_per_shard_flushed_states_equal_jax(run):
    eng = run["torch"]
    mh = run["params"].max_hash() or 0
    saved = eng.state
    eng.state = [tbk.flush_state(s, mh, k=11, seed=0)[0] for s in saved]
    try:
        got = sharded_state_to_numpy(eng)
    finally:
        eng.state = saved
    for g, w in zip(got, run["jrows"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_jax_mid_stream_state_carries_into_the_port(run):
    """The JAX engine's raw rows after the stream seed the port's shards
    (sharded_state_from_numpy round-trips them bit for bit); both engines
    then fold one more batch and finalize alike."""
    jp, tp = _params(run["scheme"])
    mesh = make_mesh(8, device="cpu")
    states = sharded_state_from_numpy(run["raw"], mesh)
    port = ShardedSketchEngine(tp, mesh, batch_size_per_device=512)
    port.state = states
    port.capacity = states[0][0].shape[0]
    for g, w in zip(sharded_state_to_numpy(port), run["raw"]):
        assert np.array_equal(g, w)
    jeng = JSharded(jp, jmake_mesh(8), batch_size_per_device=512)
    jeng.state = tuple(jeng._put(r) for r in run["raw"])
    jeng.capacity = port.capacity
    extra = _batches(_random_fasta(5, nrec=2), 11, 3000)
    for pk, rc in extra:
        port.update(pk, rc)
        jeng.update(pk, rc)
    assert _rows(port.finalize()) == _rows(jeng.finalize())
    with pytest.raises(FinchMessageError, match="rows must number 4"):
        sharded_state_from_numpy(run["raw"], make_mesh(4, device="cpu"))


def test_scaled_growth_equals_jax_and_numpy():
    """tests/test_parallel.py's growth case: capacity 16 on 4 shards."""
    fa = _random_fasta(7, nrec=3, lo=300, hi=900)
    kw = dict(kmers_to_sketch=4, kmer_length=7, scale=0.5)
    jeng = JSharded(JSketchParams.scaled(**kw), jmake_mesh(4),
                    batch_size_per_device=256)
    jeng.capacity = 16
    jeng.state = jeng._empty_state(16)
    params = SketchParams.scaled(**kw)
    port = ShardedSketchEngine(params, make_mesh(4, device="cpu"),
                               batch_size_per_device=256)
    port.capacity = 16
    port.state = port._empty_state(16)
    neng = teng.NumpyEngine(params)
    for pk, rc in _batches(fa, 7, 1500):
        for e in (jeng, port, neng):
            e.update(pk, rc)
    assert port.capacity > 16 and port.capacity == jeng.capacity
    assert {s[0].shape[0] for s in port.state} == {port.capacity}
    got = _rows(port.finalize())
    assert got == _rows(jeng.finalize()) == _rows(neng.finalize())


def test_composite_input_equals_packed():
    params = SketchParams.mash(kmers_to_sketch=64, final_size=64,
                               no_strict=True)
    mesh = make_mesh(8, device="cpu")
    e1 = ShardedSketchEngine(params, mesh, batch_size_per_device=512)
    e2 = ShardedSketchEngine(params, mesh, batch_size_per_device=512)
    rng = np.random.default_rng(12)
    for _ in range(2):
        pk = rng.integers(0, 4 ** 21, size=6000, dtype=np.uint64)
        rc = rng.integers(0, 2, size=6000, dtype=np.uint8)
        comp = (pk << np.uint64(1)) | rc
        e1.update(pk, rc)
        e2.update((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                  (comp >> np.uint64(32)).astype(np.uint32))
    assert _rows(e1.finalize()) == _rows(e2.finalize())
    # 2 updates of 6000 k-mers, each 2 steps of 8 shards
    assert sum(e2.stats.get(t, 0) for t in ("small", "two_stage")) == 32


def _db(seed, n, pool=400, kmax=60):
    """n sorted distinct sketches over the full u64 range (a quarter of
    the pool >= 2^63), drawn from a shared pool; one empty sketch."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, U64_TOP, size=pool, dtype=np.uint64)
    p[: pool // 4] |= np.uint64(1 << 63)
    out = [np.unique(rng.choice(p, size=int(rng.integers(1, kmax))))
           for _ in range(n - 1)]
    return out + [np.empty(0, dtype=np.uint64)]


@pytest.mark.parametrize("shards,run_block", [(8, 2048), (8, 16), (3, 16)])
def test_sharded_common_equals_jax_and_unsharded(shards, run_block):
    H, L = jmx.pack_db(_db(4, 30))
    want = tmx.all_pairs_common(H, L, device="cpu")
    got = tmx.sharded_common(H, L, make_mesh(shards, device="cpu"),
                             run_block=run_block)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if run_block == 2048:   # one JAX compile serves the file
        assert np.array_equal(got, jmx.sharded_common(H, L, jmake_mesh(8)))


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_all_vs_all_mesh_equals_jax(scale):
    db = _db(9, 20)
    qs, rs = db[:5], db[5:]   # 15 refs: not a multiple of 8
    mesh = make_mesh(8, device="cpu")
    got = tsd.all_vs_all_arrays(qs, rs, scale=scale, mesh=mesh)
    want = jsd.all_vs_all_arrays(qs, rs, scale=scale, mesh=jmake_mesh(8))
    flat = tsd.all_vs_all_arrays(qs, rs, scale=scale, device="cpu")
    for g, w, f in zip(got, want, flat):
        assert g.shape == (5, 15) and g.dtype == np.uint64
        assert np.array_equal(g, w) and np.array_equal(g, f)


@pytest.fixture
def at_repo_root(monkeypatch):
    # the goldens name their input by its repo-relative path
    monkeypatch.chdir(REPO)


@pytest.fixture
def built(monkeypatch):
    """Record the sharded engines the CLI builds."""
    made = []
    init = ShardedSketchEngine.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(ShardedSketchEngine, "__init__", spy)
    return made


def _cli(tmp_path, name, *args) -> bytes:
    out = tmp_path / name
    tcli.run(["sketch", *args, QUERY_REL, "-o", str(out)])
    return (tmp_path / f"{name}.sk").read_bytes()


def test_cli_mesh_backend_on_cpu(tmp_path, at_repo_root, built):
    got = _cli(tmp_path, "mesh", "--n-hashes", "10", "--backend", "mesh",
               "--device", "cpu")
    with open(GOLDEN_SK, "rb") as f:
        assert got == f.read()
    scaled = ["-s", "scaled", "--n-hashes", "10"]
    assert _cli(tmp_path, "mesh_s", *scaled, "--backend", "mesh",
                "--device", "cpu") == _cli(tmp_path, "numpy_s", *scaled,
                                           "--backend", "numpy")
    assert len(built) == 2 and all(e.mesh.size == 1 for e in built)
    assert all(e.mesh.devices[0].type == "cpu" for e in built)


def test_mesh_routes(monkeypatch, tmp_path):
    params = SketchParams.mash(kmers_to_sketch=10, final_size=10)
    wide = SketchParams.mash(kmers_to_sketch=10, final_size=10,
                             kmer_length=51)
    with pytest.raises(FinchMessageError, match="mesh backend supports k "
                                                "<= 31"):
        teng.make_engine(wide, backend="mesh", device="cpu")
    eng = teng.make_engine(params, backend="mesh", device="cpu")
    assert isinstance(eng, ShardedSketchEngine)
    assert eng.bpd == (1 << 21) and eng.mesh.size == 1
    # no card and no --device cpu: the mesh raises, never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: teng.make_engine(params, backend="mesh"),
                 lambda: make_mesh(),
                 lambda: tcli.run(["sketch", "--backend", "mesh", "-o",
                                   str(tmp_path / "never"),
                                   os.path.join(HERE, "data", "query.fa")])):
        with pytest.raises(FinchMessageError, match="no CUDA device"):
            call()
    # auto stays on one card where several are present (in fresh
    # processes HybridEngine on one card beat both meshes); mesh takes them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(teng, "_mesh_engine",
                        lambda p, b, d: ("mesh", b // 4))
    monkeypatch.setattr(teng, "HybridEngine", lambda p, **kw: "hybrid")
    assert teng.make_engine(params) == "hybrid"
    assert teng.make_engine(params, backend="mesh") == ("mesh", 1 << 19)
    assert teng.make_engine(wide) == "hybrid"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert teng.make_engine(params) == "hybrid"


def test_mesh_and_engine_contracts():
    mesh = Mesh(["cpu", "cpu", "cpu"], axis_name="shards")
    assert mesh.size == 3 and mesh.axis_names == ("shards",)
    assert mesh.rank == 0 and mesh.world_size == 1 and mesh.group is None
    with pytest.raises(FinchMessageError, match="at least one device"):
        Mesh([])
    params = SketchParams.mash(kmers_to_sketch=10, final_size=10)
    with pytest.raises(FinchMessageError, match="process group"):
        ShardedSketchEngine(params, mesh, process_local=True)


def test_graft_entry_on_cpu(capsys):
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out[0].shape == (1024,) and len(out) == 7
    assert int(out[5][0]) > 0   # the step's candidates wait in the spill
    graft_entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4) OK" in capsys.readouterr().out
