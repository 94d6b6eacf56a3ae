"""Weighted dedup of duplicate bursts: tier D and tier D2.

The counterpart of the Pallas TPU kernels ``_dedup_kernel`` (tier D,
``pallas_extract.py:602``, via ``dedup_candidates``) and
``_dedup_slab_kernel`` (tier D2, ``pallas_extract.py:772``, via
``dedup_slab_candidates``). The kernels are hand-written CUDA for Hopper
(``csrc/dedup.cu``), built at first use (``ops/cuda_lib.py``) and called
through a plain C interface with ctypes. Beside each, a ``_plain`` twin
computes the same function with PyTorch ops; the wrappers take it only for
CPU tensors, and for CUDA tensors launch the kernel or raise.

Contract (the TPU kernels', pinned by tests/test_torch_dedup.py). Per
column (one of CHUNK_W=2048), a DUP_ACC_H=96-row weighted accumulator is
carried over the batch in steps:

* new rows: tier D takes one chunk's 32 lanes of the column: a survivor
  (not padding, hash <= thresh, read from the extract kernel's saved hash
  planes) is v + 1 with weight 1, any other lane u64::MAX with weight 0.
  Tier D2 takes 32 rows of the extract kernel's slab (DUP_GROUP=4 chunks
  of 8 rows); every real entry has weight 1.
* step: sort the 96 accumulator rows and the 32 new rows by value. Every
  run of equal real values collapses into its first row, which takes the
  run's total weight; the run's other rows become u64::MAX holes in place
  (compacted only by the next sort). The flag is set by a real head at
  row >= 96 or by a head weight >= 2**(64 - 2k - 2) when that field is
  under 32 bits. Rows 0..95 are kept.
* output: cand int64[96*2048], row-major (96, 2048), the last step's rows
  with the holes where they fall, a real row written
  value + ((weight - 1) << (2k + 2)); and the flag, int32 (dovf / d2ovf).

The output holds every survivor with its exact count iff the flag is 0;
tier D2 also needs the extract's covf to be 0 (else the slab lost
survivors before D2 saw them). Under overflow it is still this function,
bit for bit: the sketch's adaptive-absorb hint reads it. The TPU kernels'
DUP_W lane windows, a VMEM workaround, are gone: columns are independent,
so the windows changed nothing but the OR of the flags.

The kernels (``dedup_lanes_warp``, tier D; ``dedup_slab_warp``, tier D2)
run one warp per column and share one accumulator step. Both are bound
by bytes (16 B a lane for D, 8 B a slab entry for D2) and by the chain of
a column's steps, so their new rows stream through a shared-memory ring
ahead of the steps, tier D sorts a stage's dense steps before the chain
walks them, and steps that cannot drop a head merge into one pass.
"""

from __future__ import annotations

import ctypes

import torch

from finch_tpu_torch import u64
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.ops import cuda_lib
from finch_tpu_torch.ops.extract import CHUNK, CHUNK_W, COLH, ROWS_OUT

DUP_ACC_H = 96
DUP_GROUP = 4
NEW = 32  # rows merged per step


def supports_dedup(k: int, b: int) -> bool:
    """Tier-D preconditions (``pallas_extract.supports_dedup``): whole
    chunks and a weight field of at least 12 bits (k <= 25)."""
    return b % CHUNK == 0 and b >= CHUNK and 64 - (2 * k + 2) >= 12


def supports_dedup_slab(k: int, b: int) -> bool:
    """Tier-D2 preconditions (``pallas_extract.supports_dedup_slab``):
    tier D's, and a chunk count divisible by DUP_GROUP."""
    return supports_dedup(k, b) and (b // CHUNK) % DUP_GROUP == 0


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.finch_dedup.restype = ctypes.c_int
    lib.finch_dedup.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                ctypes.c_int, p, p, p]
    lib.finch_dedup_slab.restype = ctypes.c_int
    lib.finch_dedup_slab.argtypes = [p, ctypes.c_longlong, ctypes.c_int,
                                     p, p, p]


def _device(*ts) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise FinchMessageError("dedup operands must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise FinchMessageError(
            f"dedup runs on cuda or cpu tensors, not {dev}")
    return dev


def _launch(name: str, dev, *args) -> tuple[torch.Tensor, torch.Tensor]:
    # two allocations: cheaper on the host than one split into views
    cand = torch.empty(DUP_ACC_H * CHUNK_W, dtype=torch.int64, device=dev)
    flag = torch.empty((), dtype=torch.int32, device=dev)
    err = cuda_lib.launch(cuda_lib.function("dedup", name, _declare), dev,
                          *args, cand.data_ptr(), flag.data_ptr())
    if err != 0:
        raise FinchMessageError(f"{name} launch failed: CUDA error {err}")
    return cand, flag


def dedup_candidates(vlo, vhi, hash_lo, hash_hi, thresh, *, k: int):
    """Tier D over b = vlo.numel() lanes: vlo/vhi the extract's int32 lane
    planes (u32 bits, both -1 = padding), hash_lo/hash_hi its hash planes,
    thresh one int64 (u64 bits). Returns (cand, dovf); see the module doc.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``dedup_candidates.launches``)."""
    planes = (vlo, vhi, hash_lo, hash_hi)
    b = vlo.shape[0]
    if any(t.dtype != torch.int32 or t.shape != (b,)
           or not t.is_contiguous() for t in planes):
        raise FinchMessageError("dedup planes must be contiguous 1-D int32 "
                                "of one length")
    if thresh.dtype != torch.int64 or thresh.numel() != 1:
        raise FinchMessageError("thresh must be one int64 (u64 bits)")
    if not supports_dedup(k, b):
        raise FinchMessageError(f"tier D needs k <= 25 and a multiple of "
                                f"{CHUNK} lanes (k={k}, b={b})")
    dev = _device(*planes, thresh)
    if dev.type == "cpu":
        return dedup_candidates_plain(vlo, vhi, hash_lo, hash_hi, thresh,
                                      k=k)
    out = _launch("finch_dedup", dev, *(t.data_ptr() for t in planes),
                  thresh.data_ptr(), b // CHUNK, 2 * k + 2)
    cuda_lib.count(dedup_candidates)
    return out


dedup_candidates.launches = 0


def dedup_slab_candidates(slab, *, k: int):
    """Tier D2 over the extract kernel's slab (int64, (b/CHUNK)*8*CHUNK_W
    entries). Returns (cand, d2ovf); see the module doc. CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    ``dedup_slab_candidates.launches``)."""
    rows_per = ROWS_OUT * CHUNK_W
    if (slab.dtype != torch.int64 or slab.dim() != 1
            or not slab.is_contiguous() or slab.shape[0] % rows_per):
        raise FinchMessageError("the slab must be contiguous 1-D int64 of "
                                "whole chunks")
    nchunks = slab.shape[0] // rows_per
    if not supports_dedup_slab(k, nchunks * CHUNK):
        raise FinchMessageError(f"tier D2 needs k <= 25 and a multiple of "
                                f"{DUP_GROUP} chunks (k={k}, "
                                f"chunks={nchunks})")
    dev = _device(slab)
    if dev.type == "cpu":
        return dedup_slab_candidates_plain(slab, k=k)
    out = _launch("finch_dedup_slab", dev, slab.data_ptr(), nchunks,
                  2 * k + 2)
    cuda_lib.count(dedup_slab_candidates)
    return out


dedup_slab_candidates.launches = 0


def _accumulate(steps, k: int, dev):
    """The accumulator over `steps`, each a (CHUNK_W, NEW) int64 block of
    new values (u64::MAX = none), as the TPU kernel computes it: sort,
    collapse runs into their first row, cut to DUP_ACC_H rows."""
    wshift = 2 * k + 2
    wbits = 64 - wshift
    n = DUP_ACC_H + NEW
    acc_v = torch.full((CHUNK_W, DUP_ACC_H), u64.MAX, dtype=torch.int64,
                       device=dev)
    acc_w = torch.zeros((CHUNK_W, DUP_ACC_H), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    pos = torch.arange(n, device=dev)
    ones = torch.ones((CHUNK_W, 1), dtype=torch.bool, device=dev)
    for new in steps:
        v, order = u64.sort(torch.cat([acc_v, new], 1), dim=1)
        w = torch.cat([acc_w, (new != u64.MAX).to(torch.int64)],
                      1).gather(1, order)
        neq = v[:, 1:] != v[:, :-1]
        head = (v != u64.MAX) & torch.cat([ones, neq], 1)
        # the last row of each run: suffix-min of the run ends
        end = torch.where(torch.cat([neq, ones], 1), pos, n)
        end = torch.cummin(end.flip(1), 1).values.flip(1)
        cs = torch.cumsum(w, 1)
        total = cs.gather(1, end) - cs + w
        v = torch.where(head, v, u64.MAX)
        w = torch.where(head, total, 0)
        ovf = ovf | head[:, DUP_ACC_H:].any()
        if wbits < 32:
            ovf = ovf | (w >= (1 << wbits)).any()
        acc_v, acc_w = v[:, :DUP_ACC_H], w[:, :DUP_ACC_H]
    cand = torch.where(acc_v != u64.MAX, acc_v + ((acc_w - 1) << wshift),
                       u64.MAX)
    return cand.t().reshape(-1).contiguous(), ovf.to(torch.int32)


def dedup_candidates_plain(vlo, vhi, hash_lo, hash_hi, thresh, *, k: int):
    """Tier D written with PyTorch ops (a row sort per step)."""
    nch = vlo.shape[0] // CHUNK
    v = u64.join(vlo, vhi)
    pad = (vlo == -1) & (vhi == -1)
    keep = ~pad & u64.le(u64.join(hash_lo, hash_hi), thresh.reshape(()))
    new = torch.where(keep, v + 1, u64.MAX).view(nch, COLH, CHUNK_W)
    return _accumulate((new[c].t() for c in range(nch)), k, vlo.device)


def dedup_slab_candidates_plain(slab, *, k: int):
    """Tier D2 written with PyTorch ops (a row sort per step)."""
    groups = slab.view(-1, NEW, CHUNK_W)
    return _accumulate((groups[g].t() for g in range(groups.shape[0])), k,
                       slab.device)
