"""Plain reference of `finch sketch` on a FASTQ file at wide k
(mash scheme, 32 <= k <= 63).

The k <= 31 reference (``sketch.py``) packs a k-mer into one int64; at
wide k its 2k-bit code is two int64 words, ``hi`` (bits [64, 2k) of the
code) and ``lo`` (bits [0, 64)), with base 0 in the highest bits, so the
pair (hi, lo) in u64 order is lexicographic order. Plain PyTorch on int64
lanes as there (``*`` and ``+`` wrap mod 2**64), so that it runs on the
card after the window and on the CPU in the tests. It imports nothing of
the port; it shares with ``sketch.py`` the FASTQ reader, the
MurmurHash3_x64_128, the error filter's cutoff and the comparison:

* k-mers: every window of k bases of a sequence line that holds only
  A, C, G, T (case folded, U read as T); its canonical form is the
  smaller of the window and its reverse complement by u64 comparison of
  (hi, lo), and it is "reverse" when the reverse complement is not
  larger;
* hash: MurmurHash3_x64_128 of the canonical k-mer's k ASCII bytes with
  the sketch's seed, its first 64-bit word (finch-rs
  sketch_schemes/hashing.rs); at k = 51 three 16-byte blocks and a
  3-byte tail;
* mash state: the ``kmers_to_sketch`` smallest distinct hashes (u64
  order), each with every occurrence counted and the reverse ones apart,
  and the k-mer of its first occurrence;
* filters (finch-rs filtering.rs): the strand filter, the error filter's
  adaptive cutoff from the count histogram at ``err_filter x k / 100``,
  the abundance filter; then the first ``n_hashes`` entries, each with
  its k-mer as k letters.

Departures from finch-rs, none of which the benchmark's FASTQ reaches:

* it reads 4-line FASTQ records only: no FASTA, no multi-line records,
  no gzip, and the whole file is held in memory;
* it takes 32 <= k <= 63 only (``sketch.py`` takes k <= 31; finch-rs
  any k);
* a count is written clipped to 2**32 - 1.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.sketch import (ASCII, SIGN, compare,  # noqa: F401
                                        error_cutoff, murmur3_x64_128_h1,
                                        read_fastq)


def _check_k(k: int) -> None:
    if not 32 <= k <= 63:
        raise ValueError(f"the wide reference takes 32 <= k <= 63, not {k}")


def hash_codes_wide(hi, lo, k: int, seed: int):
    """Hashes of k-mers given as two-word 2-bit codes (int64 hi and lo,
    base 0 highest)."""
    _check_k(k)
    lut = torch.tensor(ASCII, dtype=torch.int64, device=lo.device)
    nwords = 2 * (k // 16 + 1)
    words = [torch.zeros_like(lo) for _ in range(nwords)]
    for j in range(k):
        p = 2 * (k - 1 - j)  # the bit of base j in the 2k-bit code
        code = (hi >> (p - 64)) & 3 if p >= 64 else (lo >> p) & 3
        words[j // 8] = words[j // 8] | (lut[code] << (8 * (j % 8)))
    return murmur3_x64_128_h1(words, k, seed)


def canonical_kmers_wide(seq, lens, k: int, chunk: int = 1 << 24):
    """Yield (hi, lo, reverse) of every valid window's canonical k-mer,
    chunk by chunk, in file order."""
    _check_k(k)
    dev = seq.device
    lut = torch.full((256,), 4, dtype=torch.int64, device=dev)
    for ch, v in zip(b"ACGTacgtUu", (0, 1, 2, 3, 0, 1, 2, 3, 3, 3)):
        lut[ch] = v
    codes = lut[seq.long()]
    n = codes.numel()
    bad = torch.cat([codes.new_zeros(1), torch.cumsum(codes > 3, 0)])
    ends = torch.repeat_interleave(torch.cumsum(lens, 0), lens)
    codes = codes.clamp(max=3)
    for p0 in range(0, n, chunk):
        p1 = min(n, p0 + chunk)
        pos = torch.arange(p0, p1, device=dev)
        top = torch.clamp(pos + k, max=n)
        ok = (pos + k <= ends[p0:p1]) & (bad[top] == bad[pos])
        seg = codes[p0:min(n, p1 + k - 1)]
        seg = torch.cat([seg, seg.new_zeros(p1 - p0 + k - 1 - seg.numel())])
        fhi, flo, rhi, rlo = (torch.zeros(p1 - p0, dtype=torch.int64,
                                          device=dev) for _ in range(4))
        for j in range(k):
            c = seg[j:j + p1 - p0]
            # the 128-bit window shifted left by one base
            fhi = (fhi << 2) | ((flo >> 62) & 3)
            flo = (flo << 2) | c
            if 2 * j < 64:
                rlo = rlo | ((3 - c) << (2 * j))
            else:
                rhi = rhi | ((3 - c) << (2 * j - 64))
        fhi, flo, rhi, rlo = fhi[ok], flo[ok], rhi[ok], rlo[ok]
        # hi holds at most 62 bits, so int64 order is u64 order there
        rev = (rhi < fhi) | ((rhi == fhi) & ((rlo ^ SIGN) <= (flo ^ SIGN)))
        yield (torch.where(rev, rhi, fhi), torch.where(rev, rlo, flo), rev)


def bottom_k_wide(chunks, k: int, seed: int, size: int):
    """(hash keys ascending, counts, reverse counts, hi, lo) of the `size`
    smallest distinct hashes of the stream, every occurrence counted, the
    k-mer of the first occurrence kept. Keys are hash ^ (1 << 63): int64
    order is u64 order."""
    keys = None
    total = 0
    for hi, lo, rev in chunks:
        total += lo.numel()
        hk = hash_codes_wide(hi, lo, k, seed) ^ SIGN
        if keys is not None and keys.numel() >= size:
            keep = hk <= keys[size - 1]
            hk, hi, lo, rev = hk[keep], hi[keep], lo[keep], rev[keep]
        if keys is None:
            keys, counts, revs, his, los = (hk.new_empty(0)
                                            for _ in range(5))
        allk = torch.cat([keys, hk])
        allc = torch.cat([counts, torch.ones_like(hk)])
        allr = torch.cat([revs, rev.long()])
        allhi = torch.cat([his, hi])
        alllo = torch.cat([los, lo])
        sk, order = torch.sort(allk, stable=True)
        uniq, inv = torch.unique_consecutive(sk, return_inverse=True)
        u = uniq.numel()
        counts = torch.zeros(u, dtype=torch.int64, device=sk.device
                             ).index_add_(0, inv, allc[order])
        revs = torch.zeros_like(counts).index_add_(0, inv, allr[order])
        first = order[torch.full((u,), sk.numel(), dtype=torch.int64,
                                 device=sk.device).scatter_reduce_(
            0, inv, torch.arange(sk.numel(), device=sk.device), "amin")]
        keys, counts, revs = uniq[:size], counts[:size], revs[:size]
        his, los = allhi[first][:size], alllo[first][:size]
    return keys, counts, revs, his, los, total


def kmer_string(hi: int, lo: int, k: int) -> str:
    """The k letters of a two-word code."""
    code = (hi << 64) | (lo & ((1 << 64) - 1))
    return "".join("ACGT"[(code >> (2 * (k - 1 - j))) & 3] for j in range(k))


def reference_sketch(path, *, k: int, n_hashes: int, kmers_to_sketch: int,
                     seed: int, strand_filter: float, err_filter: float,
                     device="cpu", strict: bool = True) -> dict:
    """The expected sketch of the FASTQ `path`, as the fields of its .sk
    JSON (hashes as ints), in the form ``sketch.reference_sketch`` gives.
    `err_filter` is the CLI's percentage."""
    seq, lens, seq_length = read_fastq(path, device)
    keys, counts, revs, his, los, total = bottom_k_wide(
        canonical_kmers_wide(seq, lens, k), k, seed, kmers_to_sketch)
    h = (keys ^ SIGN).cpu().numpy().view(np.uint64)
    c = counts.cpu().numpy()
    r = revs.cpu().numpy()
    idx = np.arange(len(h))
    # strand filter, then the error filter's cutoff, then abundance
    keep = (c < 16) | (np.minimum(r, c - r) / c >= strand_filter)
    idx = idx[keep]
    err = err_filter * (k / 100.0)
    cutoff = error_cutoff(c[idx], err) if err > 0 else None
    if cutoff is not None:
        idx = idx[c[idx] >= cutoff]
    if strict and len(idx) < n_hashes:
        raise ValueError(f"too few k-mers ({len(idx)}) to sketch")
    idx = idx[:n_hashes]
    hi, lo = his.cpu().numpy()[idx], los.cpu().numpy()[idx]
    filters = {"strandFilter": strand_filter, "errFilter": err}
    if cutoff is not None:
        filters["minCopies"] = cutoff
    return {"kmer": k, "sketchSize": n_hashes, "hashSeed": seed,
            "hashType": "MurmurHash3_x64_128", "hashBits": 64,
            "canonical": True, "scale": None, "name": str(path),
            "seqLength": seq_length, "numValidKmers": total,
            "comment": "", "filters": filters,
            "hashes": [int(x) for x in h[idx]],
            "kmers": [kmer_string(int(a), int(b), k)
                      for a, b in zip(hi, lo)],
            "counts": [int(x) for x in np.minimum(c[idx], (1 << 32) - 1)]}
