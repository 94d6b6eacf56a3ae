"""Plain reference of `finch sketch` on a FASTQ file (mash scheme, k <= 31).

Written from the published algorithms, in plain PyTorch on int64 lanes
(``*`` and ``+`` wrap mod 2**64 as u64 arithmetic does; a logical right
shift is an arithmetic one and a mask), so that it runs on the card
after the window and on the CPU in the tests. It imports nothing of the
port and reads only the FASTQ the benchmark wrote:

* k-mers: every window of k bases of a sequence line that holds only
  A, C, G, T (case folded, U read as T); its canonical form is the
  smaller of the window and its reverse complement (2-bit codes, base 0
  in the high bits, so integer order is lexicographic order), and it is
  "reverse" when the reverse complement is not larger;
* hash: MurmurHash3_x64_128 of the canonical k-mer's ASCII bytes with the
  sketch's seed, its first 64-bit word (finch-rs sketch_schemes/hashing.rs);
* mash state: the ``kmers_to_sketch`` smallest distinct hashes (u64
  order), each with every occurrence counted and the reverse ones apart;
* filters (finch-rs filtering.rs): the strand filter, the error filter's
  adaptive cutoff from the count histogram, the abundance filter; then
  the first ``n_hashes`` entries.
"""

from __future__ import annotations

import numpy as np
import torch

M64 = (1 << 64) - 1
SIGN = -(1 << 63)


def _i64(v: int) -> int:
    v &= M64
    return v - (1 << 64) if v >> 63 else v


C1, C2 = _i64(0x87C37B91114253D5), _i64(0x4CF5AD432745937F)
F1, F2 = _i64(0xFF51AFD7ED558CCD), _i64(0xC4CEB9FE1A85EC53)
ASCII = (65, 67, 71, 84)  # A C G T


def _shr(x, s: int):
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x, r: int):
    return (x << r) | _shr(x, 64 - r)


def _fmix(x):
    x = x ^ _shr(x, 33)
    x = x * F1
    x = x ^ _shr(x, 33)
    x = x * F2
    return x ^ _shr(x, 33)


def murmur3_x64_128_h1(words, nbytes: int, seed: int):
    """First 64-bit word of MurmurHash3_x64_128 over byte strings of
    length `nbytes`, given as little-endian 8-byte words (zero past the
    end; at least 2 * (nbytes // 16 + 1) of them)."""
    h1 = torch.full_like(words[0], _i64(seed))
    h2 = torch.full_like(words[0], _i64(seed))
    nblocks = nbytes // 16
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * C1, 31) * C2
        h1 = h1 ^ k1
        h1 = _rotl(h1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl(words[2 * b + 1] * C2, 33) * C1
        h2 = h2 ^ k2
        h2 = _rotl(h2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    rem = nbytes & 15
    if rem > 8:
        h2 = h2 ^ (_rotl(words[2 * nblocks + 1] * C2, 33) * C1)
    if rem > 0:
        h1 = h1 ^ (_rotl(words[2 * nblocks] * C1, 31) * C2)
    h1 = h1 ^ nbytes
    h2 = h2 ^ nbytes
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix(h1)
    h2 = _fmix(h2)
    return h1 + h2


def hash_codes(codes, k: int, seed: int):
    """Hashes of k-mers given as 2-bit codes (int64, base 0 highest)."""
    lut = torch.tensor(ASCII, dtype=torch.int64, device=codes.device)
    nwords = 2 * (k // 16 + 1)
    words = [torch.zeros_like(codes) for _ in range(nwords)]
    for j in range(k):
        byte = lut[(codes >> (2 * (k - 1 - j))) & 3]
        words[j // 8] = words[j // 8] | (byte << (8 * (j % 8)))
    return murmur3_x64_128_h1(words, k, seed)


def read_fastq(path, device):
    """(sequence bytes of every record, concatenated; each record's length;
    the summed length) of a 4-line-record FASTQ file."""
    raw = np.fromfile(str(path), dtype=np.uint8)
    buf = torch.from_numpy(raw).to(device)
    nl = torch.nonzero(buf == 10).squeeze(1)
    if nl.numel() % 4 or int(buf[-1]) != 10:
        raise ValueError("the reference reads 4-line FASTQ records")
    start = torch.cat([nl.new_zeros(1), nl[:-1] + 1])
    if not (bool((buf[start[0::4]] == ord("@")).all())
            and bool((buf[start[2::4]] == ord("+")).all())):
        raise ValueError("the reference reads 4-line FASTQ records")
    s, e = start[1::4], nl[1::4]
    delta = torch.zeros(buf.numel() + 1, dtype=torch.int32, device=device)
    delta.index_add_(0, s, torch.ones_like(s, dtype=torch.int32))
    delta.index_add_(0, e, -torch.ones_like(e, dtype=torch.int32))
    seq = buf[torch.cumsum(delta, 0)[:-1] > 0]
    lens = e - s
    return seq, lens, int(lens.sum())


def canonical_kmers(seq, lens, k: int, chunk: int = 1 << 24):
    """Yield (codes, reverse) of every valid window, chunk by chunk, in
    file order."""
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
        fwd = torch.zeros(p1 - p0, dtype=torch.int64, device=dev)
        rev = torch.zeros_like(fwd)
        for j in range(k):
            c = seg[j:j + p1 - p0]
            fwd = (fwd << 2) | c
            rev = rev | ((3 - c) << (2 * j))
        fwd, rev = fwd[ok], rev[ok]
        yield torch.minimum(fwd, rev), rev <= fwd


def bottom_k(chunks, k: int, seed: int, size: int):
    """(hash keys ascending, counts, reverse counts, codes) of the `size`
    smallest distinct hashes of the stream, every occurrence counted.
    Keys are hash ^ (1 << 63): int64 order is u64 order."""
    keys = counts = revs = codes = None
    total = 0
    for canon, rev in chunks:
        total += canon.numel()
        hk = hash_codes(canon, k, seed) ^ SIGN
        if keys is not None and keys.numel() >= size:
            keep = hk <= keys[size - 1]
            hk, canon, rev = hk[keep], canon[keep], rev[keep]
        if keys is None:
            keys = hk.new_empty(0)
            counts, revs, codes = (hk.new_empty(0) for _ in range(3))
        allk = torch.cat([keys, hk])
        allc = torch.cat([counts, torch.ones_like(hk)])
        allr = torch.cat([revs, rev.long()])
        allp = torch.cat([codes, canon])
        sk, order = torch.sort(allk, stable=True)
        uniq, inv = torch.unique_consecutive(sk, return_inverse=True)
        u = uniq.numel()
        counts = torch.zeros(u, dtype=torch.int64, device=sk.device
                             ).index_add_(0, inv, allc[order])
        revs = torch.zeros_like(counts).index_add_(0, inv, allr[order])
        first = torch.full((u,), sk.numel(), dtype=torch.int64,
                           device=sk.device).scatter_reduce_(
            0, inv, torch.arange(sk.numel(), device=sk.device), "amin")
        codes = allp[order][first]
        keys = uniq
        keys, counts, revs, codes = (t[:size] for t in
                                     (keys, counts, revs, codes))
    return keys, counts, revs, codes, total


def error_cutoff(counts: np.ndarray, level: float) -> int:
    """The error filter's adaptive minimum count (finch-rs filtering.rs,
    guess_filter_threshold): the histogram's weighted cut, then the
    lowest window of the histogram below it."""
    hist = np.bincount(counts.astype(np.int64))[1:].tolist() \
        if len(counts) else []
    total = sum((i + 1) * c for i, c in enumerate(hist))
    cut = level * total
    wgt = 0
    cum = 0
    for c in hist:
        cum += wgt * c
        if cum > cut:
            break
        wgt += 1
    if wgt == 0:
        return 1
    win = max(1, wgt // 20)
    s = sum(hist[:win])
    low_val, low_idx = s, win - 1
    for i, j in zip(range(wgt - win), range(win, wgt)):
        if s <= low_val:
            low_val, low_idx = s, j
        s -= hist[i]
        s += hist[j]
    return low_idx + 1


def reference_sketch(path, *, k: int, n_hashes: int, kmers_to_sketch: int,
                     seed: int, strand_filter: float, err_filter: float,
                     device="cpu", strict: bool = True) -> dict:
    """The expected sketch of the FASTQ `path`, as the fields of its .sk
    JSON (hashes as ints). `err_filter` is the CLI's percentage."""
    seq, lens, seq_length = read_fastq(path, device)
    keys, counts, revs, codes, total = bottom_k(
        canonical_kmers(seq, lens, k), k, seed, kmers_to_sketch)
    h = (keys ^ SIGN).cpu().numpy().view(np.uint64)
    c = counts.cpu().numpy()
    r = revs.cpu().numpy()
    pk = codes.cpu().numpy()
    # strand filter, then the error filter's cutoff, then abundance
    keep = (c < 16) | (np.minimum(r, c - r) / c >= strand_filter)
    h, c, pk = h[keep], c[keep], pk[keep]
    err = err_filter * (k / 100.0)
    cutoff = error_cutoff(c, err) if err > 0 else None
    if cutoff is not None:
        keep = c >= cutoff
        h, c, pk = h[keep], c[keep], pk[keep]
    if strict and len(h) < n_hashes:
        raise ValueError(f"too few k-mers ({len(h)}) to sketch")
    h, c, pk = h[:n_hashes], c[:n_hashes], pk[:n_hashes]
    kmers = ["".join("ACGT"[(int(v) >> (2 * (k - 1 - j))) & 3]
                     for j in range(k)) for v in pk]
    filters = {"strandFilter": strand_filter, "errFilter": err}
    if cutoff is not None:
        filters["minCopies"] = cutoff
    return {"kmer": k, "sketchSize": n_hashes, "hashSeed": seed,
            "hashType": "MurmurHash3_x64_128", "hashBits": 64,
            "canonical": True, "scale": None, "name": str(path),
            "seqLength": seq_length, "numValidKmers": total,
            "comment": "", "filters": filters,
            "hashes": [int(x) for x in h], "kmers": kmers,
            "counts": [int(x) for x in np.minimum(c, (1 << 32) - 1)]}


def compare(doc: dict, ref: dict) -> dict:
    """Numbers compared for one .sk document (parsed JSON) against the
    reference: header fields that differ, and entries (hash, k-mer,
    count, position by position) that differ or are missing."""
    bad = 0
    for key in ("kmer", "sketchSize", "hashSeed", "hashType", "hashBits",
                "canonical", "scale"):
        bad += doc.get(key) != ref[key]
    sk = doc.get("sketches") or [{}]  # an empty document differs in all
    bad += len(sk) != 1
    s = sk[0]
    for key in ("name", "seqLength", "numValidKmers", "comment"):
        bad += s.get(key) != ref[key]
    f = s.get("filters") or {}
    want = ref["filters"]
    bad += set(f) != set(want)
    for key, v in want.items():
        try:
            bad += (int(f[key]) if key == "minCopies"
                    else float(f[key])) != v
        except (KeyError, ValueError):
            bad += 1
    got = list(zip([int(x) for x in s.get("hashes", [])],
                   s.get("kmers", []), s.get("counts", [])))
    want_e = list(zip(ref["hashes"], ref["kmers"], ref["counts"]))
    n = max(len(got), len(want_e))
    diff = sum(1 for i in range(n)
               if i >= len(got) or i >= len(want_e) or got[i] != want_e[i])
    return {"header_fields_differing": int(bad), "entries_differing": diff}
