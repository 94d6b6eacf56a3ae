"""The port's wide-k sketch (32 <= k <= 63) against the benchmark's plain
wide reference (``portbench/reference/sketch_wide.py``), on the CPU.

* ``finch sketch`` through ``cli.run`` (``--device cpu``; the torch
  backend's ``TorchEngine`` wide step, and auto's host fold) writes the
  .sk the reference computes from the same FASTQ, entry for entry, at
  k = 32, 51 and 63 on two isolate FASTQs of 2,000 reads;
* the reference's canonical form, strand counts and hash equal a
  brute-force Python MurmurHash3_x64_128 of hand-picked k-mers, among
  them k-mers whose reverse complement is smaller only in the low word
  (at k = 51, equal high words), and one where a signed comparison of the
  low word would pick the other strand;
* the wide control (the reference with a mash state of n_hashes
  entries, not n_hashes x oversketch) is not correct.
"""

import json

import pytest

from finch_tpu_torch import cli
from portbench.controls import finch_sketch_wide as control
from portbench.gen.isolate_fastq import make_fastq
from portbench.reference import sketch_wide as ref

KS = (32, 51, 63)
SEEDS = (7, 2**31 + 9)
N_HASHES, OVERSKETCH = 100, 20
# 2,000 reads of 150 bp at 30x, the cell's depth: enough copies that the
# error filter at k = 63 (0.63%) keeps more than N_HASHES entries
GENOME, COVERAGE = 10_000, 30

M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def fastqs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide")
    paths = {}
    for seed in SEEDS:
        paths[seed] = d / f"reads_{seed}.fastq"
        make_fastq(str(paths[seed]), seed, GENOME, COVERAGE)
    return paths


@pytest.fixture(scope="module")
def references(fastqs):
    cache = {}

    def get(seed, k):
        if (seed, k) not in cache:
            cache[seed, k] = ref.reference_sketch(
                fastqs[seed], k=k, n_hashes=N_HASHES,
                kmers_to_sketch=N_HASHES * OVERSKETCH, seed=0,
                strand_filter=0.1, err_filter=1.0)
        return cache[seed, k]
    return get


@pytest.mark.parametrize("backend", ["torch", "auto"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", KS)
def test_port_sk_equals_wide_reference(fastqs, references, tmp_path, k,
                                       seed, backend):
    out = tmp_path / "out.sk"
    cli.run(["sketch", str(fastqs[seed]), "-o", str(out), "-k", str(k),
             "-n", str(N_HASHES), "--oversketch", str(OVERSKETCH),
             "--seed", "0", "--err-filter", "1", "--strand-filter", "0.1",
             "--backend", backend, "--device", "cpu"])
    want = references(seed, k)
    assert len(want["hashes"]) == N_HASHES
    assert ref.compare(json.loads(out.read_bytes()), want) == {
        "header_fields_differing": 0, "entries_differing": 0}


def _murmur3_x64_128_h1(data: bytes, seed: int) -> int:
    """MurmurHash3_x64_128's first word, byte by byte in Python ints."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M64

    def fmix(x):
        x ^= x >> 33
        x = (x * 0xFF51AFD7ED558CCD) & M64
        x ^= x >> 33
        x = (x * 0xC4CEB9FE1A85EC53) & M64
        return x ^ (x >> 33)

    def mix1(k1):
        return (rotl((k1 * c1) & M64, 31) * c2) & M64

    def mix2(k2):
        return (rotl((k2 * c2) & M64, 33) * c1) & M64

    h1 = h2 = seed & M64
    n = len(data)
    for i in range(0, n - n % 16, 16):
        h1 ^= mix1(int.from_bytes(data[i:i + 8], "little"))
        h1 = (rotl(h1, 27) + h2) & M64
        h1 = (h1 * 5 + 0x52DCE729) & M64
        h2 ^= mix2(int.from_bytes(data[i + 8:i + 16], "little"))
        h2 = (rotl(h2, 31) + h1) & M64
        h2 = (h2 * 5 + 0x38495AB5) & M64
    tail = data[n - n % 16:]
    if len(tail) > 8:
        h2 ^= mix2(int.from_bytes(tail[8:], "little"))
    if tail:
        h1 ^= mix1(int.from_bytes(tail[:8], "little"))
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & M64
    h2 = (h2 + h1) & M64
    h1, h2 = fmix(h1), fmix(h2)
    return (h1 + h2) & M64


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _kmers(k: int) -> list:
    """Hand-picked k-mers: a palindrome at k = 32 (reverse on the tie),
    a reverse complement smaller only in the low word (at k > 32 its
    first (2k - 64) / 2 bases equal the forward's, and the forward's low
    word has its sign bit set where the reverse's has not), one whose
    forward strand starts with T against an A (the sign bit again), and
    repeats."""
    x = "GATTACAGGCATCGATCGT"[: max(1, k - 32)]
    mid = k - 2 * len(x)
    return [
        ("ACGT" * 16)[:k],
        ("TGCA" * 16)[:k],
        x + "T" * mid + _revcomp(x),          # RC: x + A... + revcomp(x)
        "T" + "C" * (k - 2) + "T",            # RC: A + G... + A
        "A" * k,
        ("CAGT" * 16)[:k],
    ]


@pytest.mark.parametrize("k", [32, 51])
def test_wide_reference_matches_brute_force(tmp_path, k):
    kmers = _kmers(k)
    # one read a k-mer, and two of them once more as their reverse
    # complement: every k-mer is the one window of its read
    reads = kmers + [_revcomp(s) for s in kmers[1:3]]
    path = tmp_path / "kmers.fastq"
    path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * k}\n"
                            for i, s in enumerate(reads)))
    want = {}
    for s in reads:
        rc = _revcomp(s)
        canon = min(s, rc)
        h = _murmur3_x64_128_h1(canon.encode(), 0)
        n, r, _ = want.get(h, (0, 0, canon))
        want[h] = (n + 1, r + (rc <= s), canon)
    seq, lens, _ = ref.read_fastq(path, "cpu")
    keys, counts, revs, his, los, total = ref.bottom_k_wide(
        ref.canonical_kmers_wide(seq, lens, k), k, 0, 64)
    assert total == len(reads)
    got = {}
    for key, n, r, hi, lo in zip(keys.tolist(), counts.tolist(),
                                 revs.tolist(), his.tolist(), los.tolist()):
        got[(key ^ (1 << 63)) & M64] = (n, r, ref.kmer_string(hi, lo, k))
    assert got == want
    assert list(got) == sorted(got)
    # the reverse-smaller-in-the-low-word k-mer is counted under its RC
    low = kmers[2]
    assert _revcomp(low) < low
    assert low[: (2 * k - 64) // 2] == _revcomp(low)[: (2 * k - 64) // 2]


def test_wide_control_is_not_correct(fastqs):
    config = {"kmer_length": 51, "n_hashes": N_HASHES,
              "oversketch": OVERSKETCH, "hash_seed": 0,
              "strand_filter": 0.1, "err_filter_percent": 1}
    nums = control.numbers(config, {}, {"fastq": fastqs[SEEDS[0]]}, "cpu")
    assert nums["entries_differing"] > 0, nums
