"""Arbitrary-k (k >= 64) sketching through the port's entry points: the
mirror of tests/test_xwide.py with the torch backend on the CPU in place
of the jax one, numpy and native kept. The xwide path folds on the host
by design (the torch backend's make_engine returns a NumpyEngine, as the
JAX package's engine delegates to one); every backend must equal the streaming oracle and the JAX
package's sketch of the same bytes."""

import gzip
import json
import os

import numpy as np
import pytest

from finch_tpu.core.sketching import sketch_bytes as jax_sketch_bytes
from finch_tpu.models import oracle
from finch_tpu.models import params as jparams
from finch_tpu_torch.core.sketching import sketch_bytes, sketch_files
from finch_tpu_torch.models.params import FilterParams, SketchParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERY_FA = os.path.join(REPO, "tests", "data", "query.fa")
BACKENDS = ["numpy", "native", "torch"]


def _oracle_records(data: bytes):
    """Raw sequence regions per FASTA record (incl. internal newlines,
    minus the trailing newline run, matching seq.sequence() /
    mash.rs:72)."""
    recs = []
    for chunk in data.split(b">")[1:]:
        parts = chunk.split(b"\n", 1)
        recs.append(parts[1].rstrip(b"\n") if len(parts) > 1 else b"")
    return recs


def _oracle_mash(data: bytes, size: int, k: int, seed: int = 0):
    om = oracle.OracleMashSketcher(size=size, k=k, seed=seed)
    for rec in _oracle_records(data):
        om.process(rec)
    return om


def _tuples(sketch):
    return [(kc.hash, kc.kmer, kc.count, kc.extra_count)
            for kc in sketch.hashes]


def _jax(data: bytes, params: SketchParams):
    jp = getattr(jparams.SketchParams, params.sketch_type)
    if params.sketch_type == "mash":
        p = jp(kmers_to_sketch=params.kmers_to_sketch,
               final_size=params.final_size, kmer_length=params.k,
               no_strict=True)
    else:
        p = jp(kmers_to_sketch=params.kmers_to_sketch,
               kmer_length=params.k, scale=params.scale)
    return _tuples(jax_sketch_bytes(data, "t", p,
                                    jparams.FilterParams(filter_on=False),
                                    backend="jax"))


@pytest.mark.parametrize("k", [64, 101])
@pytest.mark.parametrize("backend", BACKENDS)
def test_xwide_mash_matches_oracle_and_jax(k, backend):
    params = SketchParams.mash(kmers_to_sketch=10, final_size=10,
                               kmer_length=k, no_strict=True)
    [s] = sketch_files([QUERY_FA], params, FilterParams(filter_on=False),
                       backend=backend, device="cpu")
    data = open(QUERY_FA, "rb").read()
    om = _oracle_mash(data, 10, k)
    assert _tuples(s) == om.to_vec() == _jax(data, params)
    assert s.num_valid_kmers == om.total_kmers
    assert s.seq_length == om.total_bases
    assert len(s.hashes[0].kmer) == k


@pytest.mark.parametrize("backend", BACKENDS)
def test_xwide_scaled_matches_oracle_and_jax(backend):
    k = 75
    params = SketchParams.scaled(kmers_to_sketch=5, kmer_length=k,
                                 scale=0.05)
    [s] = sketch_files([QUERY_FA], params, FilterParams(filter_on=False),
                       backend=backend, device="cpu")
    data = open(QUERY_FA, "rb").read()
    os_ = oracle.OracleScaledSketcher(size=5, scale=0.05, k=k, seed=0)
    for rec in _oracle_records(data):
        os_.process(rec)
    assert _tuples(s) == os_.to_vec() == _jax(data, params)


def test_xwide_messy_fasta_matches_oracle_and_jax():
    """Ns break windows, lowercase/U normalize, multi-line wraps and
    intra-line spaces are spanned."""
    rec1 = (b"acgtACGTacgtACGTacgtACGTacgtACGTacgtACGT\n"
            b"acgtACGTacgtACGTacgtACGTacgtNACGTacgtACGT\n"
            b"ac gtACGTucgtACGTacgtACGTacgtACGTacgtACGT\n")
    rec2 = b"A" * 40 + b"\n" + b"C" * 50 + b"\n"
    rec3 = b"ACGT" * 15  # 60 bases < k: no kmers
    data = b">r1\n" + rec1 + b">r2\n" + rec2 + b">r3 tail\n" + rec3 + b"\n"
    k = 64
    params = SketchParams.mash(kmers_to_sketch=50, final_size=50,
                               kmer_length=k, no_strict=True)
    s = sketch_bytes(data, "m", params, FilterParams(filter_on=False),
                     backend="torch", device="cpu")
    om = oracle.OracleMashSketcher(size=50, k=k, seed=0)
    for rec in (rec1, rec2, rec3 + b"\n"):
        om.process(rec.rstrip(b"\n"))
    assert _tuples(s) == om.to_vec() == _jax(data, params)
    assert s.num_valid_kmers == om.total_kmers
    assert s.seq_length == om.total_bases


def test_xwide_fastq_and_batch_stitching():
    """FASTQ records + a tiny parser batch cap force runs to straddle
    batches; the k-1 carry must stitch windows exactly once."""
    from finch_tpu_torch.native import XWideReader

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    k = 80
    lines, seqs = [], []
    for i in range(6):
        seq = bases[rng.integers(0, 4, size=300)].tobytes()
        seqs.append(seq)
        lines += [b"@r%d" % i, seq, b"+", b"I" * len(seq)]
    data = b"\n".join(lines) + b"\n"
    rd = XWideReader(data, k=k, batch_size=256)
    got = []
    for win, is_rc in rd:
        got += [(bytes(win[i]), int(is_rc[i])) for i in range(len(win))]
    want = []
    for seq in seqs:
        want += list(oracle.canonical_kmers(oracle.normalize(seq), k))
    assert got == [(km, int(rc)) for km, rc in want]
    assert rd.totals[1] == len(want)


def test_xwide_palindrome_tie_takes_rc_branch():
    """A reverse-complement palindrome (fwd == rc) must set is_rc."""
    half = b"ACGTTGCAACGTTGCAACGTTGCAACGTTGCA"  # 32 bases
    pal = half + bytes(reversed(half.translate(
        bytes.maketrans(b"ACGT", b"TGCA"))))  # 64-base palindrome
    params = SketchParams.mash(kmers_to_sketch=5, final_size=5,
                               kmer_length=64, no_strict=True)
    s = sketch_bytes(b">p\n" + pal + b"\n", "p", params,
                     FilterParams(filter_on=False), backend="torch",
                     device="cpu")
    row = [kc for kc in s.hashes if kc.kmer == pal]
    assert row and row[0].extra_count == 1  # the tie counted as rc


def test_xwide_serialization_roundtrip(tmp_path):
    """k = 101 k-mer strings survive .sk and .bsk round trips."""
    from finch_tpu_torch.serialization import open_sketch_file
    from finch_tpu_torch.serialization.finch_bsk import write_finch_file
    from finch_tpu_torch.serialization.json_sk import \
        multisketch_to_json_bytes

    params = SketchParams.mash(kmers_to_sketch=10, final_size=10,
                               kmer_length=101, no_strict=True)
    [s] = sketch_files([QUERY_FA], params, FilterParams(filter_on=False),
                       backend="torch", device="cpu")
    p_sk = tmp_path / "x.sk"
    p_sk.write_bytes(multisketch_to_json_bytes([s]))
    p_bsk = tmp_path / "x.bsk"
    p_bsk.write_bytes(write_finch_file([s]))
    # .sk deserialization rebuilds extra_count = count/2 (json.rs:122-129)
    [r] = open_sketch_file(str(p_sk))
    assert _tuples(r) == [(h, km, c, c // 2) for h, km, c, _ in _tuples(s)]
    [r] = open_sketch_file(str(p_bsk))
    assert _tuples(r) == _tuples(s)
    assert r.sketch_params.k == 101


def test_xwide_cli_sketch(capsys):
    """`sketch -k 101 --backend torch --device cpu` end to end (an
    explicit err-filter: the default exceeds 100/k at k = 101)."""
    from finch_tpu_torch import cli

    cli.run(["sketch", "-k", "101", "--n-hashes", "10", "-N",
             "--err-filter", "0.5", "-O", "--backend", "torch",
             "--device", "cpu", QUERY_FA])
    ms = json.loads(capsys.readouterr().out)
    assert ms["kmer"] == 101
    om = _oracle_mash(open(QUERY_FA, "rb").read(), 10 * 200, 101)
    want = om.to_vec()
    got = ms["sketches"][0]
    assert [int(h) for h in got["hashes"]][:5] == [t[0] for t in want[:5]]
    assert got["kmers"][0] == want[0][1].decode()


def test_xwide_hypothesis_fuzz_vs_oracle():
    """Random messy FASTA records and parser batch caps: the xwide window
    stream equals the oracle's canonical_kmers, rc flags included."""
    from hypothesis import given, settings, strategies as st

    from finch_tpu_torch.native import XWideReader

    base = st.sampled_from(list(b"ACGTacgtNn"))
    rec = st.lists(base, min_size=0, max_size=260).map(bytes)

    @settings(max_examples=60, deadline=None)
    @given(st.lists(rec, min_size=1, max_size=4),
           st.integers(min_value=64, max_value=90),
           st.sampled_from([4096, 5000, 8192]))
    def run(recs, k, cap):
        data = b"".join(b">r%d\n%s\n" % (i, r) for i, r in enumerate(recs))
        rd = XWideReader(data, k=k, batch_size=cap)
        got = []
        for win, is_rc in rd:
            got += [(bytes(win[i]), int(is_rc[i]))
                    for i in range(len(win))]
        want = []
        for r in recs:
            want += [(km, int(rc)) for km, rc in
                     oracle.canonical_kmers(oracle.normalize(r), k)]
        assert got == want
        assert rd.totals[1] == len(want)

    run()


def test_xwide_gzip_input(tmp_path):
    """.gz sources flow through the same parser on the xwide path."""
    data = open(QUERY_FA, "rb").read()
    gz = tmp_path / "q.fa.gz"
    gz.write_bytes(gzip.compress(data))
    params = SketchParams.mash(kmers_to_sketch=10, final_size=10,
                               kmer_length=75, no_strict=True)
    [s_gz] = sketch_files([str(gz)], params, FilterParams(filter_on=False),
                          backend="torch", device="cpu")
    [s_raw] = sketch_files([QUERY_FA], params,
                           FilterParams(filter_on=False), backend="numpy")
    assert _tuples(s_gz) == _tuples(s_raw)
    assert s_gz.seq_length == s_raw.seq_length
