"""The port's bindings surface (finch_tpu_torch.api) against
finch_tpu.api on the same files: sketch_file on the CPU, merge, compare,
compare_counts, compare_matrix, and Multisketch open/save/best_match/
filter_to_* over the frozen goldens. Every result must be equal (integers
and the same f64 operations). Also the profiler hook,
finch_tpu_torch.utils.trace, on the CPU."""

import glob
import json
import os

import numpy as np
import pytest

import finch_tpu.api as jfinch
import finch_tpu_torch.api as tfinch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
QUERY_FA = os.path.join(DATA, "query.fa")
READS_FQ = os.path.join(DATA, "reads.fastq")
GOLDENS = sorted(p for p in glob.glob(os.path.join(DATA, "goldens", "*"))
                 if p.endswith((".sk", ".bsk", ".msh")))


def _both(fn):
    return fn(jfinch), fn(tfinch)


def _db(api):
    """Every golden's sketches, then two sketch_file sketches of each
    fixture file (mash k = 21, n = 100), in one Multisketch."""
    ms = api.Multisketch([])
    for p in GOLDENS:
        for s in api.Multisketch.open(p):
            ms.add(s)
    kw = {} if api is jfinch else {"device": "cpu"}
    for path in (QUERY_FA, READS_FQ):
        ms.add(api.sketch_file(path, n_hashes=100, no_strict=True,
                               filter=False, **kw))
    return ms


@pytest.fixture(scope="module")
def dbs():
    return _both(_db)


@pytest.mark.parametrize("kwargs", [
    dict(n_hashes=10, no_strict=True),
    dict(n_hashes=10, no_strict=True, filter=False),
    dict(n_hashes=50, kmer_length=51, filter=False, seed=7),
    dict(n_hashes=10, kmer_length=101, filter=False),
])
@pytest.mark.parametrize("path", [QUERY_FA, READS_FQ])
def test_sketch_file_matches_jax(path, kwargs):
    try:
        j = jfinch.sketch_file(path, **kwargs)
    except jfinch.FinchError as e:  # reads.fastq's reads are under 101 bp
        with pytest.raises(tfinch.FinchError) as t:
            tfinch.sketch_file(path, device="cpu", **kwargs)
        assert str(t.value) == str(e) and "too few kmers" in str(e)
        return
    t = tfinch.sketch_file(path, device="cpu", **kwargs)
    assert t.hashes == j.hashes
    assert t.counts.tolist() == j.counts.tolist()
    assert (t.name, t.seq_length, t.num_valid_kmers, t.sketch_params) == \
        (j.name, j.seq_length, j.num_valid_kmers, j.sketch_params)


def test_sketch_file_without_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tfinch.FinchError, match="no CUDA device"):
        tfinch.sketch_file(QUERY_FA, n_hashes=10)


def test_multisketch_open_matches_jax(dbs):
    jdb, tdb = dbs
    assert len(tdb) == len(jdb) == len(GOLDENS) + 2
    assert repr(tdb) == repr(jdb)
    for j, t in zip(jdb, tdb):
        assert (t.name, t.hashes, t.sketch_params) == \
            (j.name, j.hashes, j.sketch_params)


def test_compare_matches_jax(dbs):
    jdb, tdb = dbs
    n = len(jdb)
    for a in range(n):
        for b in range(n):
            for old in (False, True):
                assert tdb[a].compare(tdb[b], old) == \
                    jdb[a].compare(jdb[b], old)
            got = tdb[a].compare_counts(tdb[b])
            want = jdb[a].compare_counts(jdb[b])
            assert np.array_equal(np.array(got), np.array(want),
                                  equal_nan=True)
        np.testing.assert_array_equal(
            tdb[a].compare_matrix(*list(tdb)),
            jdb[a].compare_matrix(*list(jdb)))


@pytest.mark.parametrize("size", [None, 5, 500])
def test_merge_matches_jax(dbs, size):
    jdb, tdb = dbs
    for a, b in ((0, 1), (len(jdb) - 2, len(jdb) - 1), (3, 0)):
        if jdb[a].sketch_params["sketch_type"] != \
                jdb[b].sketch_params["sketch_type"]:
            continue
        j, t = jdb[a].copy(), tdb[a].copy()
        j.merge(jdb[b], size)
        t.merge(tdb[b], size)
        assert t.hashes == j.hashes
        assert (t.seq_length, t.num_valid_kmers) == \
            (j.seq_length, j.num_valid_kmers)


def test_merge_incompatible_raises_the_same():
    errs = []
    for api in (jfinch, tfinch):
        kw = {} if api is jfinch else {"device": "cpu"}
        a = api.sketch_file(QUERY_FA, n_hashes=10, filter=False, **kw)
        b = api.sketch_file(QUERY_FA, n_hashes=10, filter=False,
                            kmer_length=31, **kw)
        with pytest.raises(api.FinchError) as e:
            a.merge(b)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "k 21" in errs[1]


def test_best_match_and_filters_match_jax(dbs, tmp_path):
    jdb, tdb = dbs
    for qi in range(len(jdb)):
        ji, js = jdb.best_match(jdb[qi])
        ti, ts = tdb.best_match(tdb[qi])
        assert (ti, ts.name, ts.hashes) == (ji, js.name, js.hashes)
    for thr in (0.0, 0.3, 1.0):
        jm, tm = jfinch.Multisketch(list(jdb.sketches)), \
            tfinch.Multisketch(list(tdb.sketches))
        jm.filter_to_matches(jdb[-1], thr)
        tm.filter_to_matches(tdb[-1], thr)
        assert [s.name for s in tm] == [s.name for s in jm]
    jm, tm = jfinch.Multisketch(list(jdb.sketches)), \
        tfinch.Multisketch(list(tdb.sketches))
    names = ["tests/data/reads.fastq", READS_FQ]
    jm.filter_to_names(names)
    tm.filter_to_names(names)
    assert [s.name for s in tm] == [s.name for s in jm]
    assert len(tm) == 2
    # save writes finch .bsk, read back equal by either package
    tdb.save(str(tmp_path / "t.bsk"))
    jdb.save(str(tmp_path / "j.bsk"))
    assert (tmp_path / "t.bsk").read_bytes() == \
        (tmp_path / "j.bsk").read_bytes()
    back = tfinch.Multisketch.open(str(tmp_path / "t.bsk"))
    assert [s.hashes for s in back] == [s.hashes for s in tdb]


def test_container_semantics():
    """Indexing, deletion, membership, the copy-on-write views and the
    counts setter, as in the pyo3 bindings."""
    s = tfinch.sketch_file(QUERY_FA, n_hashes=10, filter=False,
                           device="cpu")
    ms = tfinch.Multisketch.from_sketches([s, s.copy()])
    assert QUERY_FA in ms and ms[-1].name == QUERY_FA
    view = ms[0]
    view.name = "changed"
    assert ms[0].name == QUERY_FA
    view.counts = [0] * 9 + [3]
    assert len(view) == 1 and len(ms[0]) == 10
    with pytest.raises(tfinch.FinchError, match="same length"):
        view.counts = [1, 2]
    del ms[0]
    assert len(ms) == 1
    with pytest.raises(KeyError):
        ms["nope"]


def test_trace_writes_a_chrome_trace(tmp_path):
    """The profiler hook on the CPU: a wide-k sketch on the torch backend
    under trace() writes one Chrome trace holding the wide step's ranges;
    the yielded profile reads them in process too."""
    from finch_tpu_torch.utils import trace

    with trace(str(tmp_path)) as prof:
        s = tfinch.sketch_file(READS_FQ, n_hashes=10, kmer_length=51,
                               filter=False, device="cpu")
        assert len(s) == 10
        from finch_tpu_torch import FilterParams, SketchParams
        from finch_tpu_torch.core.sketching import sketch_stream

        sketch_stream(READS_FQ, "r", SketchParams.mash(
            kmers_to_sketch=10, final_size=10, kmer_length=51,
            no_strict=True), FilterParams(filter_on=False),
            backend="torch", device="cpu")
    [path] = list(tmp_path.iterdir())
    assert path.name.startswith("finch_trace_") and path.suffix == ".json"
    doc = json.loads(path.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"wide.hash", "wide.batch_sort", "wide.merge_sort"} <= names
    assert any(e.key == "wide.hash" for e in prof.key_averages())
