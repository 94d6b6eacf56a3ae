"""The port's `dist`, `hist` and `info` against the JAX package's CLI,
byte for byte, on the CPU (`--device cpu`), and against the frozen
`dist_query_reads.json` golden.

Both CLIs run in this process through their `run`; a pairwise DB of 72
sketches (5184 pairs) takes the Gram route and 64 queries of it the tile
route, each checked to have run."""

import json
import os

import numpy as np
import pytest
import torch

from finch_tpu import cli as jcli
from finch_tpu_torch import cli as tcli
from finch_tpu_torch.core.sketch import LazyKmerCounts, Sketch
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.parallel import mxu_dist, sharded_dist
from finch_tpu_torch.serialization.finch_bsk import write_finch_file

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "data", "goldens")
QUERY_REL = "tests/data/query.fa"
READS_REL = "tests/data/reads.fastq"
SK_REL = "tests/data/goldens/query_mash_n10.sk"


@pytest.fixture(autouse=True)
def at_repo_root(monkeypatch):
    # inputs are named by repo-relative paths, as in the goldens
    monkeypatch.chdir(REPO)


def _run(mod, tmp_path, args, capsys=None) -> bytes:
    """One CLI run; its output (file or stdout) as bytes."""
    if mod == "torch" and "--backend" not in args:
        args = [*args, "--device", "cpu"]
    if args[0] == "info":
        capsys.readouterr()
        (tcli if mod == "torch" else jcli).run(args)
        return capsys.readouterr().out.encode()
    out = tmp_path / f"{mod}_out"
    (tcli if mod == "torch" else jcli).run([*args, "-o", str(out)])
    return (tmp_path / f"{mod}_out.json").read_bytes()


def _same(tmp_path, args, capsys=None) -> bytes:
    got = _run("torch", tmp_path, args, capsys)
    assert got == _run("jax", tmp_path, args, capsys)
    return got


def test_dist_golden(tmp_path):
    got = _same(tmp_path, ["dist", "-N", SK_REL, READS_REL])
    with open(os.path.join(GOLD, "dist_query_reads.json"), "rb") as f:
        assert got == f.read()


def test_hist_and_info(tmp_path, capsys):
    assert _same(tmp_path, ["hist", "--n-hashes", "10", QUERY_REL]) == \
        b'{"tests/data/query.fa":[8,2]}'
    info = _same(tmp_path, ["info", "--n-hashes", "10", QUERY_REL], capsys)
    assert info.startswith(b"tests/data/query.fa (from 405bp)\n")
    assert b"Estimated % GC:" in info


@pytest.fixture
def other_fa(tmp_path):
    p = tmp_path / "other.fa"
    p.write_bytes(b">o\n" + b"TTAGGCCATCAGGACCA" * 10 + b"\n")
    return str(p)


@pytest.mark.parametrize("flags", [
    ["-p"], ["-q", "QUERY"], ["--max-dist", "0.5"], ["-p", "--old-dist"],
    ["--old-dist", "--max-dist", "0.2"]])
def test_dist_flags(tmp_path, other_fa, flags):
    flags = [QUERY_REL if f == "QUERY" else f for f in flags]
    got = _same(tmp_path, ["dist", *flags, "--n-hashes", "10", "-N",
                           QUERY_REL, other_fa, READS_REL])
    assert got.startswith(b"[")


def test_pairwise_conflicts_with_queries(tmp_path, other_fa):
    args = ["dist", "-p", "-q", other_fa, "--n-hashes", "10", "-N",
            QUERY_REL, other_fa]
    for mod, cli in (("torch", tcli), ("jax", jcli)):
        with pytest.raises(cli.CliError, match="cannot be used with"):
            _run(mod, tmp_path, args)


def _db_file(tmp_path, n=72, size=40):
    """A .bsk of n mash sketches over a shared full-range u64 pool (pairs
    overlap), one of them present twice (the self-skip) and one empty."""
    rng = np.random.default_rng(12)
    params = SketchParams.mash(kmers_to_sketch=size, final_size=size,
                               no_strict=True)
    pool = rng.integers(0, 2**64 - 1, size=400, dtype=np.uint64)
    pool[:100] |= np.uint64(1 << 63)
    sks = []
    for i in range(n - 2):
        hs = np.sort(rng.choice(pool, size=size, replace=False))
        c = rng.integers(1, 4, size=size, dtype=np.uint32)
        sks.append(Sketch(name=f"s{i}", seq_length=9, num_valid_kmers=12,
                          comment="",
                          hashes=LazyKmerCounts(hs, [b""] * size, c, c // 2),
                          filter_params=FilterParams(filter_on=False),
                          sketch_params=params))
    sks.append(sks[3])
    e = np.empty(0, dtype=np.uint64)
    sks.append(Sketch(name="empty", seq_length=0, num_valid_kmers=0,
                      comment="", hashes=LazyKmerCounts(e, [], e, e),
                      filter_params=FilterParams(filter_on=False),
                      sketch_params=params))
    path = tmp_path / "db.bsk"
    path.write_bytes(write_finch_file(sks))
    return str(path), [s.name for s in sks]


@pytest.fixture
def spies(monkeypatch):
    calls = []
    for mod, name in ((mxu_dist, "all_pairs_survivors"),
                      (mxu_dist, "all_pairs_stats"),
                      (sharded_dist, "all_vs_all_arrays")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, k.get("device")))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    import finch_tpu_torch.parallel as par
    monkeypatch.setattr(par, "all_vs_all_arrays",
                        sharded_dist.all_vs_all_arrays)
    return calls


def _same_as_serial(tmp_path, args, got):
    """The device route's rows equal the serial loop's (--backend numpy).
    Compared as parsed JSON: for a pair with an empty sketch (total 0,
    jaccard 1) both packages' vectorized routes print mashDistance -0.0
    where their serial loops print 0.0."""
    want = _run("torch", tmp_path, [*args, "--backend", "numpy"])
    assert json.loads(got) == json.loads(want)
    assert got.count(b'"query"') > 1000
    assert got.replace(b"-0.0,", b"0.0,") == want


@pytest.mark.parametrize("max_dist,refused,route", [
    ("0.9", False, ["all_pairs_survivors"]),
    # out of the survivors' contract: the full-matrix path takes over
    ("1.0", False, ["all_pairs_survivors", "all_pairs_stats"]),
    # survivors past the cap (refused here): the full matrix with the cut
    ("0.9", True, ["all_pairs_survivors", "all_pairs_stats"])])
def test_pairwise_gram_route(tmp_path, monkeypatch, spies, max_dist,
                             refused, route):
    if refused:
        def out_of_contract(*a, **k):
            spies.append(("all_pairs_survivors", k.get("device")))
            return None
        monkeypatch.setattr(mxu_dist, "all_pairs_survivors",
                            out_of_contract)
    db, _ = _db_file(tmp_path)
    args = ["dist", "-p", "--max-dist", max_dist, db]
    got = _same(tmp_path, args)
    assert spies == [(r, "cpu") for r in route]
    _same_as_serial(tmp_path, args, got)


def test_query_db_tile_route(tmp_path, spies):
    db, names = _db_file(tmp_path)
    args = ["dist", db, "--max-dist", "0.95", "-q", *names[:64]]
    got = _same(tmp_path, args)
    assert spies == [("all_vs_all_arrays", "cpu")]
    _same_as_serial(tmp_path, args, got)


def test_library_routes_and_refusal(tmp_path, monkeypatch, spies):
    db, _ = _db_file(tmp_path)
    sks = tcli.open_sketch_file(db)
    rows = tcli.calc_sketch_distances(sks, sks, False, 0.9, device="cpu")
    assert spies == [("all_pairs_survivors", "cpu")]
    serial = tcli.calc_sketch_distances(sks, sks, False, 0.9,
                                        use_device=False)
    assert [d.to_json_dict() for d in rows] == \
        [d.to_json_dict() for d in serial]
    # under 4096 pairs the serial loop runs, as in the JAX package
    tcli.calc_sketch_distances(sks[:8], sks, False, 0.9)
    assert len(spies) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FinchMessageError, match="no CUDA device"):
        tcli.calc_sketch_distances(sks, sks, False, 0.9)
    with pytest.raises(FinchMessageError, match="no CUDA device"):
        tcli.run(["dist", SK_REL, SK_REL])
    # the serial host loop stays an explicit choice
    out = tmp_path / "n"
    tcli.run(["dist", "--backend", "numpy", SK_REL, SK_REL, "-o", str(out)])
    assert (tmp_path / "n.json").read_bytes() == b"[]"
