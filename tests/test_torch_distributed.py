"""The port's mesh layer across real processes: one pair of worker
processes joined by torch.distributed over gloo (file:// rendezvous in
the test's own directory, so parallel test workers never share a port),
each holding 2 CPU shards of a 4-shard mesh. The workers import only
finch_tpu_torch. Each rank saves what it computed; the parent holds both
ranks' results against NumpyEngine and against the single-process port.

Covered: the process-local mash sketch and the scaled sketch (grown from
capacity 16; both ranks step equally often, so their all_reduces meet),
sharded_common (all_reduce of the int32 Gram partials; over the 4-shard
mesh and over the global mesh of one shard a process) and
all_vs_all_arrays(mesh=) (all_gather of the ref shards)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from finch_tpu_torch.models.engine import NumpyEngine
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.parallel import make_mesh, mxu_dist, sharded_dist
from finch_tpu_torch.parallel import ShardedSketchEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

# the inputs: each rank folds its own part of the stream in 8 updates of
# one step each (2 shards of 256 lanes); rank 1's first update is
# shorter, so from the first step the ranks' local `below` sums differ
# and only the all_reduce keeps their growth alike. The DB is shared.
INPUTS = '''
import numpy as np

def stream():
    rng = np.random.default_rng(77)
    pk = rng.integers(0, 4 ** 21, size=7980, dtype=np.uint64)
    rc = rng.integers(0, 2, size=7980, dtype=np.uint8)
    return pk, rc

def updates(rank):
    """Rank 0: k-mers [0, 4096) in 8 updates of 512; rank 1: the rest,
    one update of 300, then 7 of 512."""
    pk, rc = stream()
    cuts = ([512 * i for i in range(9)] if rank == 0 else
            [4096] + [4396 + 512 * i for i in range(8)])
    return [(pk[a:b], rc[a:b]) for a, b in zip(cuts, cuts[1:])]

def db():
    rng = np.random.default_rng(31)
    pool = rng.integers(0, 2**64 - 1, size=600, dtype=np.uint64)
    return [np.unique(rng.choice(pool, size=int(rng.integers(1, 80))))
            for _ in range(19)]

MASH = dict(kmers_to_sketch=64, final_size=64, no_strict=True)
SCALED = dict(kmers_to_sketch=8, scale=0.05)
'''

WORKER = '''
import sys
rank, pg, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.parallel import Mesh, ShardedSketchEngine, distributed
from finch_tpu_torch.parallel import mxu_dist, sharded_dist
from inputs import updates, db, MASH, SCALED

distributed.initialize(f"file://{pg}", num_processes=2, process_id=rank,
                       device="cpu")
assert distributed.global_mesh().size == 2
assert distributed.is_primary() == (rank == 0)
mesh = Mesh(["cpu", "cpu"], group=tdist.group.WORLD)
assert mesh.size == 4 and mesh.rank == rank
res = {}
for name, params in (("mash", SketchParams.mash(**MASH)),
                     ("scaled", SketchParams.scaled(**SCALED))):
    eng = ShardedSketchEngine(params, mesh, batch_size_per_device=256,
                              process_local=True)
    if name == "scaled":
        eng.capacity = 16
        eng.state = eng._empty_state(16)
    for pk, rc in updates(rank):
        eng.update(pk, rc)
    h, c, e, p = eng.finalize_arrays()
    res.update({f"{name}_h": h, f"{name}_c": c, f"{name}_e": e,
                f"{name}_p": p, f"{name}_cap": np.array(eng.capacity)})
H, L = mxu_dist.pack_db(db())
res["common"] = mxu_dist.sharded_common(H, L, mesh, run_block=16)
# one shard per process: each rank's partial is a single Gram
res["common_global"] = mxu_dist.sharded_common(
    H, L, distributed.global_mesh(), run_block=16)
sk = db()
for scale in (0.0, 0.5):
    for n, a in zip("cij", sharded_dist.all_vs_all_arrays(
            sk[:4], sk[4:], scale=scale, mesh=mesh)):
        res[f"{n}_{scale}"] = a
np.savez(out, **res)
tdist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' saved results."""
    tmp = tmp_path_factory.mktemp("gloo")
    (tmp / "inputs.py").write_text(INPUTS)
    (tmp / "worker.py").write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, str(tmp)]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(tmp / "pg"),
         str(tmp / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    sys.path.insert(0, str(tmp))
    try:
        import inputs
    finally:
        sys.path.remove(str(tmp))
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("scheme", ["mash", "scaled"])
def test_process_local_sketch(ranks, scheme):
    inputs, res = ranks
    kw = inputs.MASH if scheme == "mash" else inputs.SCALED
    params = getattr(SketchParams, scheme)(**kw)
    pk, rc = inputs.stream()
    ref = NumpyEngine(params)
    ref.update(pk, rc)
    one = ShardedSketchEngine(params, make_mesh(4, device="cpu"),
                              batch_size_per_device=256)
    one.update(pk, rc)
    for want in (ref.finalize_arrays(), one.finalize_arrays()):
        for r in res:   # every rank returns the merged sketch
            got = [r[f"{scheme}_{x}"] for x in "hcep"]
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
    if scheme == "scaled":
        assert res[0]["scaled_cap"] > 16
        assert res[0]["scaled_cap"] == res[1]["scaled_cap"]


def test_sharded_common_across_processes(ranks):
    inputs, res = ranks
    H, L = mxu_dist.pack_db(inputs.db())
    want = mxu_dist.all_pairs_common(H, L, device="cpu")
    assert want.sum() > np.trace(want)   # the DB shares hashes
    for r in res:
        assert np.array_equal(r["common"], want)


def test_sharded_common_one_shard_per_process(ranks):
    inputs, res = ranks
    H, L = mxu_dist.pack_db(inputs.db())
    want = mxu_dist.all_pairs_common(H, L, device="cpu")
    for r in res:
        assert np.array_equal(r["common_global"], want)


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_all_vs_all_across_processes(ranks, scale):
    inputs, res = ranks
    sk = inputs.db()
    want = sharded_dist.all_vs_all_arrays(sk[:4], sk[4:], scale=scale,
                                          device="cpu")
    for r in res:
        for n, w in zip("cij", want):
            got = r[f"{n}_{scale}"]
            assert got.shape == (4, 15) and np.array_equal(got, w)
