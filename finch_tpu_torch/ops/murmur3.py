"""MurmurHash3_x64_128 over 2-bit packed k-mer lanes, on int64 tensors.

The counterpart of ``finch_tpu/ops/murmur3.py``: finch hashes the ASCII
bytes of each canonical k-mer with MurmurHash3_x64_128 and keeps the low
u64 (finch-rs/lib/src/sketch_schemes/hashing.rs:9-12). The k ASCII bytes
are rebuilt from the packed code (A=0 C=1 G=2 T=3, base 0 in the most
significant bits) as little-endian u64 words, and the hash runs on int64
lanes, whose `*` and `+` wrap mod 2**64 exactly as u64 arithmetic does
(see ``finch_tpu_torch.u64``). The JAX package's u32-pair arithmetic was a
TPU workaround and has no counterpart here.

This is plain PyTorch: it serves the flush rehash, the plain version of
the extract kernel (ops/extract.py) and the wide step (ops/bottomk_wide.py),
whose two-word codes ``packed2_to_words`` reads; the JAX package's
u32-quarter form of them (``packed2_to_u32_words``) has no counterpart.
"""

from __future__ import annotations

import torch

from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.u64 import rotl, shr, to_i64

C1 = to_i64(0x87C37B91114253D5)
C2 = to_i64(0x4CF5AD432745937F)
F1 = to_i64(0xFF51AFD7ED558CCD)
F2 = to_i64(0xC4CEB9FE1A85EC53)
A1 = 0x52DCE729
A2 = 0x38495AB5

# ASCII 'A','C','G','T' packed little-endian, indexed by (code << 3) shift
_BASE_LUT = 0x54474341


def packed_to_words(packed: torch.Tensor, k: int):
    """Little-endian u64 words of the ASCII k-mer string (int64 lanes).

    Returns 2*ceil(k/16) words (whole 16-byte murmur blocks); bytes
    beyond k are zero. Bits of `packed` above 2k are ignored."""
    nwords = 2 * ((k + 15) // 16)
    words = []
    for w in range(nwords):
        acc = torch.zeros_like(packed)
        for j in range(w * 8, min(k, w * 8 + 8)):
            code = shr(packed, 2 * (k - 1 - j)) & 3
            byte = (_BASE_LUT >> (code << 3)) & 0xFF
            acc = acc | (byte << (8 * (j - w * 8)))
        words.append(acc)
    return words


def packed2_to_words(plo: torch.Tensor, phi: torch.Tensor, k: int):
    """``packed_to_words`` for wide two-word codes (32 <= k <= 63): `plo`
    holds bits [0, 64) of the code and `phi` bits [64, 2k). Base j's code
    sits at shift 2(k-1-j), which is even, so it lies wholly in one word."""
    nwords = 2 * ((k + 15) // 16)
    words = []
    for w in range(nwords):
        acc = torch.zeros_like(plo)
        for j in range(w * 8, min(k, w * 8 + 8)):
            shift = 2 * (k - 1 - j)
            if shift >= 64:
                code = shr(phi, shift - 64) & 3
            else:
                code = shr(plo, shift) & 3
            byte = (_BASE_LUT >> (code << 3)) & 0xFF
            acc = acc | (byte << (8 * (j - w * 8)))
        words.append(acc)
    return words


def _fmix64(x):
    x = x ^ shr(x, 33)
    x = x * F1
    x = x ^ shr(x, 33)
    x = x * F2
    return x ^ shr(x, 33)


def _mix_k1(k1):
    return rotl(k1 * C1, 31) * C2


def _mix_k2(k2):
    return rotl(k2 * C2, 33) * C1


def murmur3_x64_words(words, length: int, seed: int) -> torch.Tensor:
    """MurmurHash3_x64_128 h1 over byte strings given as LE u64 word lanes.

    `length` is the byte length; bytes past it must be zero."""
    s = to_i64(seed)
    h1 = torch.full_like(words[0], s)
    h2 = torch.full_like(words[0], s)
    nblocks = length // 16
    for i in range(nblocks):
        h1 = h1 ^ _mix_k1(words[2 * i])
        h1 = rotl(h1, 27) + h2
        h1 = h1 * 5 + A1
        h2 = h2 ^ _mix_k2(words[2 * i + 1])
        h2 = rotl(h2, 31) + h1
        h2 = h2 * 5 + A2
    t = length & 15
    if t > 8:
        h2 = h2 ^ _mix_k2(words[2 * nblocks + 1])
    if t > 0:
        h1 = h1 ^ _mix_k1(words[2 * nblocks])
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    # h2 += h1 omitted; finch keeps only h1
    return h1 + h2


def hash_packed_kmers(packed: torch.Tensor, *, k: int,
                      seed: int = 0) -> torch.Tensor:
    """u64 hash lanes (int64 bit patterns) for packed canonical k-mer codes
    (k <= 31); the counterpart of ``finch_tpu.ops.murmur3.hash_packed_kmers``."""
    if not 1 <= k <= 31:
        raise FinchMessageError("packed murmur path supports k in 1..=31")
    if packed.dtype != torch.int64:
        raise FinchMessageError("packed k-mer codes must be int64 lanes")
    return murmur3_x64_words(packed_to_words(packed, k), k, seed)


def hash_packed_kmers_wide(plo: torch.Tensor, phi: torch.Tensor, *, k: int,
                           seed: int = 0) -> torch.Tensor:
    """u64 hash lanes (int64 bit patterns) for wide two-word packed codes
    (32 <= k <= 63); the counterpart of
    ``finch_tpu.ops.murmur3.hash_packed_kmers_wide``."""
    if not 32 <= k <= 63:
        raise FinchMessageError("wide murmur path supports k in 32..=63")
    if plo.dtype != torch.int64 or phi.dtype != torch.int64:
        raise FinchMessageError("packed k-mer codes must be int64 lanes")
    return murmur3_x64_words(packed2_to_words(plo, phi, k), k, seed)
