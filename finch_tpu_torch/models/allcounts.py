"""AllCounts ("sketch-type none") — dense 4^k k-mer spectrum.

Contract: finch-rs/lib/src/sketch_schemes/counts.rs. Quirks faithfully
reproduced:
  * counts use forward-strand (non-canonical) bit_kmers (counts.rs:30)
  * total_bases is never updated — stays 0 (counts.rs:8)
  * to_vec folds reverse-complement counts into the first-encountered
    orientation with wrapping u32 addition; for even-k palindromes the count
    doubles (counts.rs:42-63)
"""

from __future__ import annotations

import numpy as np

from finch_tpu_torch.core.sketch import KmerCount
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.params import SketchParams
from finch_tpu_torch.native import unpack_kmers


def revcomp_packed(idx: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed 2-bit codes (vectorized)."""
    idx = np.asarray(idx, dtype=np.uint64)
    rc = np.zeros_like(idx)
    v = idx.copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | (np.uint64(3) - (v & np.uint64(3)))
        v >>= np.uint64(2)
    return rc


class AllCountsEngine:
    """Dense 4^k table for k <= 15 (the reference's layout, counts.rs:14);
    a sparse native count table for 15 < k <= 31, where the reference's
    dense Vec would need >= 17 GB — same results on the distinct k-mers
    actually present (to_vec only ever emits nonzero entries). Its codes
    are one u64 word, so k > 31 is refused."""

    DENSE_MAX_K = 15

    def __init__(self, params: SketchParams):
        self.params = params
        self.k = params.kmer_length
        if self.k > 31:
            raise FinchMessageError(
                f"sketch type `none` supports k <= 31, not {self.k}")
        if self.k <= self.DENSE_MAX_K:
            self.counts = np.zeros(4 ** self.k, dtype=np.uint64)
            self._fold = None
        else:
            from finch_tpu_torch.native import NativeFold

            self.counts = None
            self._fold = NativeFold(2, self.k, 0, 0, 0)

    def update(self, packed: np.ndarray, rc: np.ndarray) -> None:
        # forward-strand codes; rc unused by this scheme
        if self._fold is not None:
            self._fold.fold(np.asarray(packed, dtype=np.uint64),
                            np.zeros(len(packed), dtype=np.uint8))
            return
        self.counts += np.bincount(
            np.asarray(packed, dtype=np.int64),
            minlength=len(self.counts)).astype(np.uint64)

    def num_valid_kmers(self) -> int:
        """Sum of saturated per-index counts (sketch_stream accounting)."""
        if self._fold is not None:
            _, c, _, _ = self._fold.result()
            return int(np.minimum(c, 0xFFFFFFFF).sum())
        return int(np.minimum(self.counts, 0xFFFFFFFF).sum())

    def finalize(self):
        if self._fold is not None:
            return self._finalize_sparse()
        # saturating u32 per-index counts (counts.rs:31 saturating_add)
        counts = np.minimum(self.counts, 0xFFFFFFFF).astype(np.uint32)
        nz = np.flatnonzero(counts).astype(np.uint64)
        if len(nz) == 0:
            return []
        rc = revcomp_packed(nz, self.k)
        # the reference's ascending scan emits index ix unless its RC
        # partner was emitted earlier (rc < ix with a nonzero count), in
        # which case the partner already folded ix's count (counts.rs:42-63)
        partner_first = (rc < nz) & (counts[rc] > 0)
        emit = nz[~partner_first]
        erc = rc[~partner_first]
        base = counts[emit].astype(np.uint64)
        extra = counts[erc].astype(np.uint64)
        total = (base + extra) & np.uint64(0xFFFFFFFF)  # wrapping u32 add
        kmers = unpack_kmers(emit, self.k)
        return [
            KmerCount(hash=int(ix), kmer=bytes(kmers[i]),
                      count=int(total[i]), extra_count=int(extra[i]))
            for i, ix in enumerate(emit)
        ]

    def _finalize_sparse(self):
        """RC folding over the sparse (code, count) table — identical
        output to the dense ascending scan (counts.rs:42-63)."""
        codes, c, _, _ = self._fold.result()  # ascending codes
        counts = np.minimum(c, 0xFFFFFFFF).astype(np.uint32)
        if len(codes) == 0:
            return []
        rc = revcomp_packed(codes, self.k)
        # partner count lookup in the sparse set
        pos = np.searchsorted(codes, rc)
        pos_c = np.minimum(pos, len(codes) - 1)
        present = codes[pos_c] == rc
        partner_counts = np.where(present, counts[pos_c], 0).astype(np.uint64)
        partner_first = (rc < codes) & present
        emit = ~partner_first
        base = counts[emit].astype(np.uint64)
        extra = partner_counts[emit]
        total = (base + extra) & np.uint64(0xFFFFFFFF)  # wrapping u32 add
        kmers = unpack_kmers(codes[emit], self.k)
        return [
            KmerCount(hash=int(ix), kmer=bytes(kmers[i]),
                      count=int(total[i]), extra_count=int(extra[i]))
            for i, ix in enumerate(codes[emit])
        ]
