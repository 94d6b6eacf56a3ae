"""Sketching engines: fold k-mer batches into a sketch.

The counterpart of ``finch_tpu/models/engine.py``. Interchangeable,
bit-identical backends:

* TorchEngine  — the device path (the counterpart of JaxEngine): a
                 fixed-capacity state on a torch device folded by
                 ops/bottomk.py, whose main path runs the hand-written
                 extract kernel (ops/extract.py) on the card.
* HybridEngine — starts on the host NativeEngine and migrates to a
                 TorchEngine once the stream is large.
* NativeEngine / NumpyEngine — host paths (the C++ fold, and NumPy over
                 the C++ murmur), kept as explicit user choices and as
                 independent oracles.

All compute the batch form of the reference's streaming heaps:
mash  — bottom-K distinct hashes, counts = total stream occurrences
        (finch-rs/lib/src/sketch_schemes/mash.rs:34-63)
scaled — all distinct hashes <= max_hash plus the smallest above-threshold
        hashes topped up to `size` total (scaled.rs:37-61)

Device rule: the device engines run on "cuda" unless the caller asks for
"cpu"; without a card they raise (``resolve_device``) and never fall back
to the CPU silently. Wide k (32..63) and the multi-device engine are not
ported yet: TorchEngine refuses k > 31.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.core.sketch import KmerCount
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.params import SketchParams, U32_MAX, U64_MAX
from finch_tpu_torch.native import murmur3_packed, unpack_kmers


def resolve_device(device="cuda") -> torch.device:
    """The torch device the device engines run on; raises when a card is
    asked for (the default) and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise FinchMessageError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the torch engines on the CPU")
    elif dev.type != "cpu":
        raise FinchMessageError(f"unsupported device {device!r}; use "
                                "'cuda' or 'cpu'")
    return dev


def _retention_keep(params: SketchParams, h: np.ndarray) -> int:
    """How many leading entries of the ascending-hash candidate array the
    scheme retains (mash: size; scaled: all <= max_hash topped up to
    size; none: everything)."""
    if params.sketch_type == "scaled":
        below = int(np.searchsorted(h, np.uint64(params.max_hash()),
                                    side="right"))
        return below + max(0, params.kmers_to_sketch - below)
    if params.sketch_type == "mash":
        return params.kmers_to_sketch
    return len(h)


def _finalize_arrays(params: SketchParams, h, c, e, pk):
    """Retention rule + u32 count saturation on arrays (kmers stay packed
    until the final survivors are known). `pk` is one u64 code array."""
    h = np.asarray(h, dtype=np.uint64)
    c = np.asarray(c, dtype=np.uint64)
    e = np.asarray(e, dtype=np.uint64)
    pk = np.asarray(pk, dtype=np.uint64)
    real = c > 0
    h, c, e, pk = h[real], c[real], e[real], pk[real]
    keep = _retention_keep(params, h)
    h, c, e, pk = h[:keep], c[:keep], e[:keep], pk[:keep]
    c = np.minimum(c, np.uint64(U32_MAX)).astype(np.uint32)
    e = np.minimum(e, np.uint64(U32_MAX)).astype(np.uint32)
    return h, c, e, pk


def kmercounts_from_arrays(params: SketchParams, h, c, e, pk):
    """Materialize KmerCount objects (ascending hash) from arrays."""
    kmer_bytes = unpack_kmers(np.asarray(pk, dtype=np.uint64), params.k)
    return [
        KmerCount(hash=int(h[i]), kmer=bytes(kmer_bytes[i]),
                  count=int(c[i]), extra_count=int(e[i]))
        for i in range(len(h))
    ]


def _finalize(params: SketchParams, h, c, e, pk):
    return kmercounts_from_arrays(
        params, *_finalize_arrays(params, h, c, e, pk))


def _check_narrow(params: SketchParams, engine: str) -> None:
    if params.k > 31:
        raise FinchMessageError(
            f"the {engine} engine of finch_tpu_torch supports k <= 31; "
            "wide k is not ported yet (use finch_tpu)")


class NumpyEngine:
    """Exact host-side batch sketcher (k <= 31)."""

    def __init__(self, params: SketchParams):
        _check_narrow(params, "numpy")
        self.params = params
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.h = np.empty(0, dtype=np.uint64)
        self.c = np.empty(0, dtype=np.uint64)
        self.e = np.empty(0, dtype=np.uint64)
        self.pk = np.empty(0, dtype=np.uint64)

    def _threshold(self) -> int:
        if self.params.sketch_type == "mash":
            if self.size == 0:
                return -1  # nothing is ever admitted
            if len(self.h) >= self.size:
                return int(self.h[self.size - 1])
            return int(U64_MAX)
        # scaled: the state retains all distinct hashes <= max_hash plus the
        # `size` smallest above-threshold candidates.
        if self.size == 0:
            return self.max_hash
        below = int(np.searchsorted(self.h, np.uint64(self.max_hash),
                                    side="right"))
        if len(self.h) - below >= self.size:
            return max(self.max_hash, int(self.h[-1]))
        return int(U64_MAX)

    def update(self, packed, rc: np.ndarray) -> None:
        hashes = murmur3_packed(packed, self.params.k, self.params.hash_seed)
        thresh = self._threshold()
        if thresh < 0:
            mask = np.zeros(len(hashes), dtype=bool)
        else:
            mask = hashes <= np.uint64(thresh)
        hashes = hashes[mask]
        pk = np.asarray(packed, dtype=np.uint64)[mask]
        rc = np.asarray(rc)[mask].astype(np.uint64)

        h = np.concatenate([self.h, hashes])
        c = np.concatenate([self.c, np.ones(len(hashes), dtype=np.uint64)])
        e = np.concatenate([self.e, rc])
        pk = np.concatenate([self.pk, pk])
        order = np.argsort(h, kind="stable")
        h, c, e, pk = h[order], c[order], e[order], pk[order]
        if len(h):
            boundary = np.empty(len(h), dtype=bool)
            boundary[0] = True
            np.not_equal(h[1:], h[:-1], out=boundary[1:])
            idx = np.flatnonzero(boundary)
            h = h[idx]
            c = np.add.reduceat(c, idx)
            e = np.add.reduceat(e, idx)
            pk = pk[idx]  # stable: first-seen kmer per hash
        if self.params.sketch_type == "mash":
            keep = self.size
        else:
            below = int(np.searchsorted(h, np.uint64(self.max_hash),
                                        side="right"))
            keep = below + self.size
        self.h, self.c, self.e, self.pk = h[:keep], c[:keep], e[:keep], \
            pk[:keep]

    def finalize(self):
        return _finalize(self.params, self.h, self.c, self.e, self.pk)

    def finalize_arrays(self):
        return _finalize_arrays(self.params, self.h, self.c, self.e, self.pk)


class NativeEngine:
    """Production host path: the C++ fold (identity-hash table + adaptive
    admission threshold, finch_native.cpp), bit-identical to NumpyEngine."""

    def __init__(self, params: SketchParams):
        from finch_tpu_torch.native import NativeFold

        _check_narrow(params, "native")
        self.params = params
        scheme = 1 if params.sketch_type == "scaled" else 0
        max_hash = params.max_hash() if scheme else 0
        self._fold = NativeFold(scheme, params.k, params.hash_seed,
                                params.kmers_to_sketch, max_hash or 0)

    def update(self, packed, rc: np.ndarray) -> None:
        self._fold.fold(packed, rc)

    def state_arrays(self):
        """(h, c, e, pk) retained-candidate arrays, ascending hash, with
        the retention rule applied (the engine migration input)."""
        h, c, e, pk = self._fold.result()
        keep = _retention_keep(self.params, h)
        return h[:keep], c[:keep], e[:keep], pk[:keep]

    def finalize(self):
        return _finalize(self.params, *self.state_arrays())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self.state_arrays())


class TorchEngine:
    """Device batch sketcher: fixed-capacity state on `device`, one
    bottomk.sketch_step per batch of up to `batch_size` k-mers (k <= 31;
    the extract kernel runs for k <= 28 on batches of >= 128k lanes, in
    the JAX package's default configuration: the weighted extract and
    tiers D and D2 join it for k <= 25).

    `stats` counts the tier each step took and the host syncs it made."""

    wants_composite = True

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21,
                 device="cuda"):
        from finch_tpu_torch.ops import bottomk

        _check_narrow(params, "torch")
        self._bottomk = bottomk
        self.device = resolve_device(device)
        self.params = params
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.batch_size = batch_size
        # mash capacity is fixed at kmers_to_sketch; scaled starts small
        # and grows when below-threshold distinct hashes approach it
        if params.sketch_type == "mash":
            self.capacity = max(1, self.size)
        else:
            self.capacity = max(2 * self.size, 1 << 12)
        self.state = bottomk.empty_state(self.capacity, device=self.device)
        self._mh = self.max_hash if self.max_hash is not None else 0
        self.stats: dict = {}

    def _pad(self, arr: np.ndarray) -> torch.Tensor:
        n = len(arr)
        b = self._bottomk.bucket_pow2(n)
        out = np.zeros(b, dtype=arr.dtype)
        out[:n] = arr
        return u64.from_numpy(out, self.device)

    def update(self, packed, rc: np.ndarray) -> None:
        n = len(packed)
        for off in range(0, n, self.batch_size):
            self._step(packed[off: off + self.batch_size],
                       rc[off: off + self.batch_size])

    def _step(self, chunk_pk, chunk_rc) -> None:
        bk = self._bottomk
        if chunk_pk.dtype != np.uint32:
            # (packed u64, rc) batches -> the parser's composite planes
            comp = ((np.asarray(chunk_pk, dtype=np.uint64) << np.uint64(1))
                    | np.asarray(chunk_rc, dtype=np.uint64))
            chunk_pk = (comp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            chunk_rc = (comp >> np.uint64(32)).astype(np.uint32)
        lo_d = self._pad(chunk_pk)
        hi_d = self._pad(chunk_rc)
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            new_state, below = bk.sketch_step(
                self.state, lo_d, hi_d, len(chunk_pk), self._mh,
                k=self.params.k, seed=self.params.hash_seed,
                has_max_hash=is_scaled, use_kernel=True, stats=self.stats)
            if not is_scaled:
                self.state = new_state
                return
            below = int(below)
            if below + self.size <= self.capacity:
                self.state = new_state
                return
            # grow capacity and redo from the unmodified previous state
            new_cap = max(self.capacity * 2, below + self.size)
            self.state = bk.grow_state(self.state, new_cap)
            self.capacity = new_cap

    def _host_state(self):
        state, _ = self._bottomk.flush_state(
            self.state, self._mh, k=self.params.k,
            seed=self.params.hash_seed)
        return tuple(u64.to_numpy(t) for t in state[:4])

    def finalize(self):
        return _finalize(self.params, *self._host_state())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self._host_state())


class HybridEngine:
    """Host engine that migrates to the device engine for large streams.

    Small inputs finish on the host; once the stream crosses
    `switch_after` k-mers, the host state — already the exact sorted
    bottom-k with counts — seeds a device state (bottomk.state_from_numpy)
    and sketching continues on the card. Bit-identical either way."""

    wants_composite = True

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21,
                 switch_after: int = 4 << 20, device="cuda"):
        _check_narrow(params, "hybrid")
        self.params = params
        self.batch_size = batch_size
        self.switch_after = switch_after
        self.device = resolve_device(device)
        self._host: Optional[NativeEngine] = NativeEngine(params)
        self._dev: Optional[TorchEngine] = None
        self._seen = 0

    def _migrate(self) -> None:
        from finch_tpu_torch.ops import bottomk

        dev = TorchEngine(self.params, batch_size=self.batch_size,
                          device=self.device)
        hh, hc, he, hpk = self._host.state_arrays()
        n = len(hh)
        while dev.capacity < n:
            # a scaled host state may exceed the initial device capacity
            dev.capacity *= 2
        arrays = [np.full(dev.capacity, U64_MAX, dtype=np.uint64),
                  np.zeros(dev.capacity, dtype=np.uint64),
                  np.zeros(dev.capacity, dtype=np.uint64),
                  np.zeros(dev.capacity, dtype=np.uint64)]
        for dst, src in zip(arrays, (hh, hc, he, hpk)):
            dst[:n] = src
        arrays += [np.full(bottomk.spill_capacity(dev.capacity), U64_MAX,
                           dtype=np.uint64),
                   np.zeros(1, dtype=np.int32), np.zeros(1, dtype=np.int32)]
        dev.state = bottomk.state_from_numpy(arrays, self.device)
        self._dev = dev
        self._host = None

    @property
    def stats(self) -> dict:
        return self._dev.stats if self._dev is not None else {}

    def update(self, packed, rc: np.ndarray) -> None:
        if self._dev is not None:
            self._dev.update(packed, rc)
            return
        if packed.dtype == np.uint32:
            # composite planes: decode for the host fold
            comp = ((rc.astype(np.uint64) << np.uint64(32))
                    | packed.astype(np.uint64))
            self._host.update(comp >> np.uint64(1),
                              (packed & np.uint32(1)).astype(np.uint8))
        else:
            self._host.update(packed, rc)
        self._seen += len(packed)
        if self._seen >= self.switch_after:
            self._migrate()

    def finalize(self):
        return (self._host or self._dev).finalize()

    def finalize_arrays(self):
        return (self._host or self._dev).finalize_arrays()


def make_engine(params: SketchParams, backend: str = "auto",
                batch_size: int = 1 << 21, device="cuda"):
    """backend: "auto" (HybridEngine on the card; the host fold when the
    caller asked for device="cpu"), "torch", "native" or "numpy"."""
    if backend == "numpy":
        return NumpyEngine(params)
    if backend == "native":
        return NativeEngine(params)
    if backend == "torch":
        return TorchEngine(params, batch_size=batch_size, device=device)
    if backend == "auto":
        if resolve_device(device).type == "cuda":
            return HybridEngine(params, batch_size=batch_size, device=device)
        return NativeEngine(params)
    raise FinchMessageError(f"unknown backend {backend!r}")
