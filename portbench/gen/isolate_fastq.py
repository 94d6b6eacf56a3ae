"""Generator `isolate_fastq`: a simulated bacterial isolate run.

Reads of a random genome with substitution errors, half of them
reverse-complemented, in 4-line FASTQ records with fixed-width names.
The sizes come from the traffic file (genome length, coverage, read
length, error rate) and never from the seed; the seed picks the genome,
the read starts, the errors and the strands.

``make_fastq`` is a frozen copy of ``chip_smoke.make_fastq`` (the
repository's chip smoke script), kept here so that the yardstick does not
move when that script does.
"""

from __future__ import annotations

from pathlib import Path


def make_fastq(path: str, seed: int, genome_len: int, coverage: int,
               read_len: int = 150, err: float = 0.005) -> int:
    """Simulated isolate run: reads of a random genome with substitution
    errors, half reverse-complemented, fixed-width names. Returns reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    n = genome_len * coverage // read_len
    starts = rng.integers(0, genome_len - read_len + 1, size=n)
    ascii_ = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = read_len
    rec_len = 10 + L + 3 + L + 1  # "@r0000000\n" seq "\n+\n" qual "\n"
    with open(path, "wb") as f:
        for lo in range(0, n, 100_000):
            m = min(100_000, n - lo)
            reads = genome[starts[lo:lo + m, None] + np.arange(L)]
            errs = rng.random((m, L)) < err
            reads[errs] = (reads[errs] + rng.integers(
                1, 4, size=int(errs.sum()), dtype=np.uint8)) % 4
            rev = rng.random(m) < 0.5
            reads[rev] = 3 - reads[rev, ::-1]
            rec = np.empty((m, rec_len), dtype=np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            ids = lo + np.arange(m)
            for d in range(7):
                rec[:, 2 + d] = ord("0") + (ids // 10 ** (6 - d)) % 10
            rec[:, 9] = ord("\n")
            rec[:, 10:10 + L] = ascii_[reads]
            rec[:, 10 + L] = ord("\n")
            rec[:, 11 + L] = ord("+")
            rec[:, 12 + L] = ord("\n")
            rec[:, 13 + L:13 + 2 * L] = ord("I")
            rec[:, 13 + 2 * L] = ord("\n")
            f.write(rec.tobytes())
    return n


def generate(config: dict, traffic: dict, seed: int, workdir: Path) -> dict:
    """The FASTQ under `workdir`, with the counts the rate is made of:
    every read is pure ACGT, so each holds read_len - k + 1 k-mers."""
    p = traffic["params"]
    path = Path(workdir) / "reads.fastq"
    reads = make_fastq(str(path), seed % (1 << 64), p["genome_len"],
                       p["coverage"], p["read_len"], p["err"])
    k = config["kmer_length"]
    return {"fastq": path, "reads": reads,
            "kmers": reads * max(0, p["read_len"] - k + 1),
            "bytes": path.stat().st_size}
