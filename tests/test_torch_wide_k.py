"""Wide k-mer sketching (32 <= k <= 63) through the port's entry points:
the mirror of tests/test_wide_k.py with the torch backend on the CPU in
place of the jax one, numpy and native kept. Every sketch is held against
the streaming oracle (finch_tpu.models.oracle) and against the JAX
package's sketch of the same bytes; the k = 51 golden is pinned; a scaled
run grows the device state; the CLI's `sketch -k 51` round-trips through
`dist -p`. Without a card, `--backend torch` without `--device cpu` exits
1 at any k; `--sketch-type none` refuses k > 31."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from finch_tpu.core.sketching import sketch_bytes as jax_sketch_bytes
from finch_tpu.models import params as jparams
from finch_tpu.models.oracle import (OracleMashSketcher,
                                     OracleScaledSketcher)
from finch_tpu_torch import FilterParams, SketchParams
from finch_tpu_torch.core.sketching import sketch_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERY_FA = os.path.join(REPO, "tests", "data", "query.fa")
READS_FQ = os.path.join(REPO, "tests", "data", "reads.fastq")
BACKENDS = ["numpy", "native", "torch"]


def _records(data: bytes):
    """Raw sequence regions, as the reference's record loop sees them
    (FASTA: includes internal newlines; FASTQ: the sequence line)."""
    if data.startswith(b">"):
        return [block.partition(b"\n")[2].rstrip(b"\n")
                for block in data.split(b">")[1:]]
    lines = data.split(b"\n")
    return [lines[i + 1] for i in range(0, len(lines) - 3, 4)]


def _oracle_vec(data, k, scheme, size, scale=0.01):
    if scheme == "mash":
        orc = OracleMashSketcher(size, k, 0)
    else:
        orc = OracleScaledSketcher(size, scale, k, 0)
    for rec in _records(data):
        orc.process(rec)
    return orc.to_vec()


def _tuples(s):
    return [(kc.hash, kc.kmer, kc.count, kc.extra_count) for kc in s.hashes]


def _mash(k, n):
    return dict(kind="mash", kmers_to_sketch=n, final_size=n,
                kmer_length=k, no_strict=True)


def _scaled(k, n, scale):
    return dict(kind="scaled", kmers_to_sketch=n, scale=scale, kmer_length=k)


def _params(cls, spec):
    """cls is either package's SketchParams."""
    spec = dict(spec)
    return getattr(cls, spec.pop("kind"))(**spec)


@functools.lru_cache(maxsize=None)
def _jax_tuples(data: bytes, spec: tuple):
    s = jax_sketch_bytes(data, "t", _params(jparams.SketchParams, dict(spec)),
                         jparams.FilterParams(filter_on=False),
                         backend="jax")
    return _tuples(s)


def _port(data, spec, backend):
    return sketch_bytes(data, "t", _params(SketchParams, spec),
                        FilterParams(filter_on=False), backend=backend,
                        device="cpu")


def _check(data, spec, backend, want):
    s = _port(data, spec, backend)
    got = _tuples(s)
    assert got == want
    assert got == _jax_tuples(data, tuple(sorted(spec.items())))
    return s


@pytest.mark.parametrize("path", [QUERY_FA, READS_FQ])
@pytest.mark.parametrize("backend", BACKENDS)
def test_wide_mash_k51_matches_oracle_and_jax(path, backend):
    data = open(path, "rb").read()
    _check(data, _mash(51, 16), backend,
           _oracle_vec(data, 51, "mash", 16)[:16])


@pytest.mark.parametrize("backend", BACKENDS)
def test_wide_scaled_k51_matches_oracle_and_jax(backend):
    data = open(QUERY_FA, "rb").read()
    spec = _scaled(51, 8, 0.05)
    exp = _oracle_vec(data, 51, "scaled", 8, 0.05)
    mh = _params(SketchParams, spec).max_hash()
    below = sum(1 for h, *_ in exp if h <= mh)
    _check(data, spec, backend, exp[: below + max(0, 8 - below)])


@pytest.mark.parametrize("k", [32, 33, 47, 63])
def test_wide_boundary_k_matches_oracle_and_jax(k):
    data = open(QUERY_FA, "rb").read()
    s = _check(data, _mash(k, 12), "torch",
               _oracle_vec(data, k, "mash", 12)[:12])
    assert all(len(kc.kmer) == k for kc in s.hashes)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wide_k51_golden_pinned(backend):
    """Frozen first-hashes golden for k = 51 on query.fa."""
    from finch_tpu_torch.native import murmur3_x64_128

    s = _port(open(QUERY_FA, "rb").read(), _mash(51, 4), backend)
    got = [(k.hash, k.kmer) for k in s.hashes]
    assert got[0] == (35002788879755192,
                      b"CTACAGCTAGCTAGCTAGCATCGCTAGCTACGATCGATCGACTAGCATGAC")
    assert [h for h, _ in got] == sorted(h for h, _ in got)
    for h, km in got:
        assert murmur3_x64_128(km, 0)[0] == h


def test_wide_scaled_growth_matches_oracle_and_jax():
    """A seeded 20 kb random sequence at scale 0.5: about 10,000 distinct
    51-mers below max_hash, past the device state's first capacity of
    4,096, so the torch engine grows it (grow-and-redo)."""
    from finch_tpu_torch.core.sketching import sketch_stream

    rng = np.random.default_rng(51)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=20_000)].tobytes()
    data = b">r\n" + seq + b"\n"
    spec = _scaled(51, 100, 0.5)
    params = _params(SketchParams, spec)
    engines = []
    s = sketch_stream(data, "t", params, FilterParams(filter_on=False),
                      backend="torch", device="cpu", engine_out=engines)
    assert engines[0].capacity > 4096 and engines[0].stats["syncs"] >= 2
    exp = _oracle_vec(data, 51, "scaled", 100, 0.5)
    below = sum(1 for h, *_ in exp if h <= params.max_hash())
    assert below > 4096
    exp = exp[: below + max(0, 100 - below)]
    assert _tuples(s) == exp
    assert exp == _jax_tuples(data, tuple(sorted(spec.items())))
    assert _tuples(_port(data, spec, "numpy")) == exp


def test_k_64_routes_to_xwide():
    s = _port(b">r\n" + b"ACGT" * 40 + b"\n", _mash(64, 4), "torch")
    # the period-4 repeat has exactly 3 distinct canonical 64-mers
    assert len(s.hashes) == 3 and len(s.hashes[0].kmer) == 64
    assert sum(kc.count for kc in s.hashes) == s.num_valid_kmers == 97


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "-m", "finch_tpu_torch.cli",
                           *args], capture_output=True, cwd=REPO, env=env)


def test_wide_cli_sketch_and_dist(tmp_path, capsys):
    """`sketch -k 51 --device cpu` writes a valid .sk whose bytes equal
    the JAX CLI's; `dist -p` of the file against itself is empty."""
    from finch_tpu import cli as jax_cli

    args = ["sketch", "-k", "51", "--n-hashes", "10", "-N", "-O",
            "tests/data/query.fa"]
    out = _cli(*args, "--backend", "torch", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["kmer"] == 51
    assert len(doc["sketches"][0]["kmers"][0]) == 51
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        jax_cli.run(args + ["--backend", "numpy"])
    finally:
        os.chdir(cwd)
    assert out.stdout == capsys.readouterr().out.encode()
    skp = tmp_path / "q51.sk"
    skp.write_bytes(out.stdout)
    out2 = _cli("dist", "-p", "--device", "cpu", str(skp), str(skp))
    assert out2.returncode == 0, out2.stderr
    assert json.loads(out2.stdout) == []  # self-pairs skipped


@pytest.mark.parametrize("k", ["21", "51", "101"])
def test_torch_backend_without_card_exits_1(k, monkeypatch, capsys):
    """The CLI's main with no card visible: exit 1, the message, no
    output, nothing run on the CPU instead."""
    import torch

    from finch_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [
        "finch", "sketch", "-k", k, "--n-hashes", "10", "-N", "-O",
        "--err-filter", "0.5", "--backend", "torch", QUERY_FA])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert "no CUDA device is available" in out.err
    assert out.out == ""


@pytest.mark.parametrize("k", ["40", "101"])
@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_sketch_type_none_refuses_wide_k(k, backend, monkeypatch, capsys):
    """AllCounts keeps one-word codes: `--sketch-type none` at k > 31
    exits 1 with its message and writes no sketch."""
    from finch_tpu_torch import cli

    monkeypatch.setattr(sys, "argv", [
        "finch", "sketch", "--sketch-type", "none", "-k", k, "-O",
        "--err-filter", "0.5", "--backend", backend, "--device", "cpu",
        QUERY_FA])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert f"sketch type `none` supports k <= 31, not {k}" in out.err
    assert out.out == ""


def test_wide_reader_roundtrip_unpack():
    """Parser two-word codes decode back to the exact window bytes."""
    from finch_tpu_torch.native import KmerReader, unpack_kmers_w

    fa = b">r\n" + b"ACGTTGCAGTACGTACCGGTTAACGTACGATCGATCCGTACGTAACGTAC" * 3 \
        + b"\n"
    k = 51
    reader = KmerReader(fa, k=k, canonical=False, batch_size=1024)
    [(pk, _rc)] = list(reader)
    plo, phi = pk
    seq = fa.split(b"\n")[1]
    kmers = unpack_kmers_w(plo, phi, k)
    exp = [seq[i:i + k] for i in range(len(seq) - k + 1)]
    assert [bytes(r) for r in kmers] == exp
    assert reader.totals == (len(seq), len(exp), 1)
