"""Fused extract: murmur3 + threshold prefilter + per-column selection.

The counterpart of ``finch_tpu/ops/pallas_extract.py``: it replaces the
Pallas TPU kernel ``_extract_kernel`` (``pallas_extract.py:133``, reached
through ``_extract_candidates``) in both its forms, unweighted and
weighted (duplicate-absorbing, ``weighted=True``, k <= 25). The kernel
itself is hand-written CUDA for Hopper (``csrc/extract.cu``), built with
``nvcc`` at first use (``ops/cuda_lib.py``) and called through a plain C
interface with ctypes. Beside it, ``extract_candidates_plain`` computes the
same function with PyTorch ops; the wrapper takes it only for CPU tensors,
and for CUDA tensors launches the kernel or raises.

Contract (the TPU kernel's, pinned by tests/test_torch_extract.py and
tests/test_torch_weighted.py). Lanes are viewed as (nchunks, COLH=32,
CHUNK_W=2048); a column is one of the CHUNK_W positions of a chunk, 32
lanes tall.

* per lane: v = (hi << 32) | lo is the composite (packed << 1) | is_rc;
  a lane with both planes 0xFFFFFFFF is padding. The hash planes hold the
  murmur3 of packed = v >> 1 for every lane; a lane survives iff it is not
  padding and hash <= thresh (u64 order).
* per (chunk, column): the slab holds v + 1 of the up to ROWS_OUT=8
  smallest survivors, ordered by (v, row) with the 5-bit row index
  appended so that equal k-mers stay distinct lanes and counts stay exact;
  slab rows are written descending (row 7 holds the smallest), empty rows
  are u64::MAX. covf = 1 if any chunk-column kept more than 8. The slab
  is the same in both forms.
* per column, unweighted: cand holds the ACC_H=32 smallest of that
  column's slab entries over every chunk, ascending down the rows,
  u64::MAX padded; aovf = 1 if a column's real slab entries exceed 32.
* per column, weighted: cand holds the 32 smallest DISTINCT slab values of
  the column, ascending, each as value + ((count - 1) << (2k + 2)) mod
  2**64 with count its number of slab entries, u64::MAX padded; aovf = 1
  if a column holds more than 32 distinct values, or if a kept count - 1
  does not fit the 64 - (2k + 2) bit weight field (checked only when that
  field is under 32 bits). This is what the TPU kernel's absorb pass,
  in-slab run collapse, half-cleaner and bitonic merge compute: after
  every chunk its accumulator holds the 32 smallest distinct values seen
  so far, a value pushed out never returns (32 smaller ones stay), so a
  kept value was never dropped and its count is exact.

Outputs: cand int64[32*2048], slab int64[b/4], hash_lo/hash_hi int32[b]
(u32 bits), covf/aovf int32 scalars. All u64 values are int64 bit patterns
(``finch_tpu_torch.u64``).

What bounds the kernel on the H100, and what the design does about it:
bytes. Per lane the function reads 8 bytes of lane planes and writes 8
bytes of hash planes (plus 2 bytes of slab); at its fewest integer
instructions (about 115 per lane at k=21, a byte permute assembling four
ASCII bases) it is memory-bound (``chip_smoke.py`` prices both bounds).
So the kernel keeps every intermediate out of device memory and keeps
every SM busy. Launch 1 (``extract_select``, one thread per (chunk,
column)) loads its 32 lanes 8 at a time, hashes them with the ASCII words
assembled by byte permutes, and keeps its 8 smallest survivors in a
register insertion list: only the slab and the hash planes are written.
GPU blocks run in no order, so the TPU's sequential cross-chunk
accumulator is launch 2 over the slab, which sits in L2 after launch 1.
Unweighted (``extract_warp_merge``, 256 blocks of 8 warps), one warp owns
one column and keeps its 32 smallest entries sorted across the lanes; the
block streams its 8 columns' slab rows through a shared-memory ring, 32
rows a step; a step in which no value is below the running 32nd smallest
is skipped with one ballot, and any other is sorted across the warp and
merged by a half-cleaner and a bitonic merge (the TPU kernel's own merge).
Weighted (``extract_weighted_merge``, the same grid and ring), one warp
per column keeps the 32 smallest distinct values sorted across the lanes,
each with its count: a step's copies collapse into one value with a count,
which adds to its equal among the held values or is inserted (one at a
time when few, else sorted and merged as the unweighted merge does).
"""

from __future__ import annotations

import ctypes

import torch

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops import cuda_lib
from finch_tpu_torch.ops.murmur3 import hash_packed_kmers

COLH = 32
ROWS_OUT = 8
ROW_BITS = (COLH - 1).bit_length()
CHUNK_W = 2048
ACC_H = 32
CHUNK = COLH * CHUNK_W


def supports(k: int, b: int) -> bool:
    """Kernel preconditions (``pallas_extract.supports``): the row-index
    encoding fits strictly below u64::MAX (k <= 28) and whole chunks."""
    return 2 * k + 1 + ROW_BITS < 64 and b % CHUNK == 0 and b >= CHUNK


def supports_weighted(k: int) -> bool:
    """The weighted form's precondition (``pallas_extract.supports_weighted``):
    the (count - 1) << (2k+2) field must have at least 12 bits (k <= 25)."""
    return 64 - (2 * k + 2) >= 12


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.finch_extract.restype = ctypes.c_int
    lib.finch_extract.argtypes = [
        p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, p]


def _check(vlo, vhi, thresh, k: int) -> None:
    if vlo.dtype != torch.int32 or vhi.dtype != torch.int32:
        raise FinchMessageError("extract planes must be int32 (u32 bits)")
    if vlo.dim() != 1 or vlo.shape != vhi.shape:
        raise FinchMessageError("extract planes must be 1-D and equal length")
    if not (vlo.is_contiguous() and vhi.is_contiguous()):
        raise FinchMessageError("extract planes must be contiguous")
    if thresh.dtype != torch.int64 or thresh.numel() != 1:
        raise FinchMessageError("thresh must be one int64 (u64 bits)")
    if not (vlo.device == vhi.device == thresh.device):
        raise FinchMessageError("extract operands must share one device")
    if not supports(k, vlo.shape[0]):
        raise FinchMessageError(
            f"extract kernel needs k <= 28 and a multiple of {CHUNK} lanes "
            f"(k={k}, b={vlo.shape[0]})")


def extract_candidates(vlo: torch.Tensor, vhi: torch.Tensor,
                       thresh: torch.Tensor, *, k: int, seed: int,
                       weighted: bool = False):
    """Run the fused extract over b = vlo.numel() lanes (see module doc);
    `weighted` selects the duplicate-absorbing form (k <= 25).

    Returns (cand, slab, hash_lo, hash_hi, covf, aovf). CPU tensors take
    the plain PyTorch version; CUDA tensors launch the kernel. Launches are
    counted in ``extract_candidates.launches`` (unweighted) and
    ``extract_candidates.launches_weighted``."""
    _check(vlo, vhi, thresh, k)
    if weighted and not supports_weighted(k):
        raise FinchMessageError(f"the weighted extract needs k <= 25 (k={k})")
    if vlo.device.type == "cpu":
        return extract_candidates_plain(vlo, vhi, thresh, k=k, seed=seed,
                                        weighted=weighted)
    if vlo.device.type != "cuda":
        raise FinchMessageError(
            f"extract runs on cuda or cpu tensors, not {vlo.device}")
    b = vlo.shape[0]
    nchunks = b // CHUNK
    nslab = nchunks * ROWS_OUT * CHUNK_W
    # one allocation: cand, the slab, then the hash planes and the two
    # flags as int32 words
    buf = torch.empty(ACC_H * CHUNK_W + nslab + b + 1, dtype=torch.int64,
                      device=vlo.device)
    cand, slab, words = buf.split([ACC_H * CHUNK_W, nslab, b + 1])
    h_lo, h_hi, flags = words.view(torch.int32).split([b, b, 2])
    err = cuda_lib.launch(
        cuda_lib.function("extract", "finch_extract", _declare), vlo.device,
        vlo.data_ptr(), vhi.data_ptr(), thresh.data_ptr(), cand.data_ptr(),
        slab.data_ptr(), h_lo.data_ptr(), h_hi.data_ptr(), flags.data_ptr(),
        nchunks, k, u64.to_u64(seed), int(weighted))
    if err != 0:
        raise FinchMessageError(f"extract kernel launch failed: CUDA error "
                                f"{err}")
    cuda_lib.count(extract_candidates,
                   "launches_weighted" if weighted else "launches")
    covf, aovf = flags.unbind()
    return cand, slab, h_lo, h_hi, covf, aovf


extract_candidates.launches = 0
extract_candidates.launches_weighted = 0


def _pad_cols(cols: torch.Tensor, width: int) -> torch.Tensor:
    """Right-pad (CHUNK_W, n) with u64::MAX up to `width` columns."""
    if cols.shape[1] >= width:
        return cols
    return torch.cat([cols, torch.full(
        (cols.shape[0], width - cols.shape[1]), u64.MAX, dtype=torch.int64,
        device=cols.device)], 1)


def _weighted_cand(cols: torch.Tensor, k: int):
    """Weighted cand and aovf from each column's sorted slab entries
    (CHUNK_W, n): the ACC_H smallest distinct values with their counts."""
    n = cols.shape[1]
    real = cols != u64.MAX
    ones = torch.ones((CHUNK_W, 1), dtype=torch.bool, device=cols.device)
    neq = cols[:, 1:] != cols[:, :-1]
    head = real & torch.cat([ones, neq], 1)
    pos = torch.arange(n, dtype=torch.int64, device=cols.device)
    # the last index of each run: suffix-min of the run ends
    end = torch.where(torch.cat([neq, ones], 1), pos, n)
    end = torch.cummin(end.flip(1), 1).values.flip(1)
    heads, order = u64.sort(torch.where(head, cols, u64.MAX), dim=1)
    counts = torch.where(head, end - pos + 1, 0).gather(1, order)
    aovf = (head.sum(1) > ACC_H).any()
    heads = _pad_cols(heads, ACC_H)[:, :ACC_H]
    counts = _pad_cols(counts, ACC_H)[:, :ACC_H]
    kept = heads != u64.MAX
    wshift = 2 * k + 2
    wm1 = counts - 1
    if 64 - wshift < 32:
        aovf = aovf | (kept & ((wm1 >> (64 - wshift)) != 0)).any()
    cand = torch.where(kept, heads + (wm1 << wshift), u64.MAX)
    return cand, aovf


def extract_candidates_plain(vlo: torch.Tensor, vhi: torch.Tensor,
                             thresh: torch.Tensor, *, k: int, seed: int,
                             weighted: bool = False):
    """The same function as the kernel, written with PyTorch ops on int64
    lanes (sorts stand in for the kernel's insertion lists)."""
    b = vlo.shape[0]
    nch = b // CHUNK
    v = u64.join(vlo, vhi)
    pad = (vlo == -1) & (vhi == -1)
    h = hash_packed_kmers(u64.shr(v, 1), k=k, seed=seed)
    keep = ~pad & u64.le(h, thresh.reshape(()))
    row = torch.arange(COLH, dtype=torch.int64, device=v.device)
    e = torch.where(keep.view(nch, COLH, CHUNK_W),
                    (v.view(nch, COLH, CHUNK_W) << ROW_BITS)
                    | row.view(1, COLH, 1), u64.MAX)
    e, _ = u64.sort(e, dim=1)
    covf = (e[:, ROWS_OUT, :] != u64.MAX).any()
    top = e[:, :ROWS_OUT, :]
    slab = torch.where(top != u64.MAX, u64.shr(top, ROW_BITS) + 1,
                       u64.MAX).flip(1)
    cols, _ = u64.sort(slab.permute(2, 0, 1).reshape(CHUNK_W, -1), dim=1)
    if weighted:
        cols, aovf = _weighted_cand(cols, k)
    else:
        aovf = (cols[:, ACC_H:] != u64.MAX).any()
        cols = _pad_cols(cols, ACC_H)[:, :ACC_H]
    cand = cols.t().reshape(-1).contiguous()
    h_lo, h_hi = u64.split(h)
    return (cand, slab.reshape(-1), h_lo, h_hi, covf.to(torch.int32),
            aovf.to(torch.int32))
