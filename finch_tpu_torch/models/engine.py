"""Sketching engines: fold k-mer batches into a sketch.

The counterpart of ``finch_tpu/models/engine.py``. Interchangeable,
bit-identical backends:

* TorchEngine  — the device path (the counterpart of JaxEngine): a
                 fixed-capacity state on a torch device folded by
                 ops/bottomk.py, whose main path runs the hand-written
                 extract kernel (ops/extract.py) on the card.
* HybridEngine — starts on the host NativeEngine and migrates to a
                 TorchEngine once the stream is large: after 4M k-mers
                 on a card this process has not yet stepped on (its cold
                 start outweighs a host fold that long), before the batch
                 that reaches WARM_SWITCH_AFTER on one it has, for a
                 stream open alone in the process.
* NativeEngine / NumpyEngine — host paths (the C++ fold, and NumPy over
                 the C++ murmur), kept as explicit user choices and as
                 independent oracles.

All compute the batch form of the reference's streaming heaps:
mash  — bottom-K distinct hashes, counts = total stream occurrences
        (finch-rs/lib/src/sketch_schemes/mash.rs:34-63)
scaled — all distinct hashes <= max_hash plus the smallest above-threshold
        hashes topped up to `size` total (scaled.rs:37-61)

Payloads: one u64 code word for k <= 31, a (lo, hi) pair of word arrays
for wide k (32..63), an (n, k) uint8 ASCII matrix for xwide k (>= 64).
TorchEngine folds wide k on the card (ops/bottomk_wide.py) and xwide k on
the host, as the JAX package does; HybridEngine migrates k <= 63 to the
card and keeps xwide k on the host.

Warm cards: the CUDA context, the kernels' libraries (ops/cuda_lib.py)
and the lazily loaded kernel modules are paid once a process. A
TorchEngine step that returns on a card records the card as warm for the
rest of the process (``card_is_warm``); a CPU TorchEngine records nothing.

Device rule: the device engines run on "cuda" unless the caller asks for
"cpu"; without a card they raise (``resolve_device``) and never fall back
to the CPU silently, at any k. The mesh backend (make_engine "mesh")
shards the stream over every card: one worker process a card
(parallel/process_mesh.py), or the lockstep over one card's logical
shards (parallel/sharded_sketch.py). "auto" stays on one card, also
where several are present.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import numpy as np
import torch

from finch_tpu_torch import u64
from finch_tpu_torch.core.sketch import KmerCount
from finch_tpu_torch.errors import FinchMessageError
from finch_tpu_torch.models.params import SketchParams, U32_MAX, U64_MAX
from finch_tpu_torch.native import (murmur3_batch, murmur3_packed,
                                    murmur3_packed_w, unpack_kmers,
                                    unpack_kmers_w)
from finch_tpu_torch.utils.metrics import get_meter, span


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


def composite_planes(packed: np.ndarray, rc: np.ndarray):
    """(packed u64, rc) batches -> the parser's composite
    ((packed << 1) | rc) u32 planes (lo, hi)."""
    comp = ((np.asarray(packed, dtype=np.uint64) << np.uint64(1))
            | np.asarray(rc, dtype=np.uint64))
    return ((comp & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (comp >> np.uint64(32)).astype(np.uint32))


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


def _is_bytes_payload(pk) -> bool:
    """xwide (k >= 64) payloads are (n, k) uint8 ASCII matrices rather
    than packed code words."""
    return (isinstance(pk, np.ndarray) and pk.ndim == 2
            and pk.dtype == np.uint8)


def _finalize_arrays(params: SketchParams, h, c, e, pk):
    """Retention rule + u32 count saturation on arrays (kmers stay packed
    until the final survivors are known). `pk` is one u64 code array for
    k <= 31, a (plo, phi) tuple of word arrays for 32 <= k <= 63, or an
    (n, k) uint8 ASCII matrix for k >= 64."""
    h = np.asarray(h, dtype=np.uint64)
    c = np.asarray(c, dtype=np.uint64)
    e = np.asarray(e, dtype=np.uint64)
    if isinstance(pk, tuple):
        pks = [np.asarray(w, dtype=np.uint64) for w in pk]
    elif _is_bytes_payload(pk):
        pks = [pk]
    else:
        pks = [np.asarray(pk, dtype=np.uint64)]
    real = c > 0
    h, c, e = h[real], c[real], e[real]
    pks = [w[real] for w in pks]
    keep = _retention_keep(params, h)
    h, c, e = h[:keep], c[:keep], e[:keep]
    pks = [w[:keep] for w in pks]
    c = np.minimum(c, np.uint64(U32_MAX)).astype(np.uint32)
    e = np.minimum(e, np.uint64(U32_MAX)).astype(np.uint32)
    return h, c, e, (tuple(pks) if len(pks) == 2 else pks[0])


def kmercounts_from_arrays(params: SketchParams, h, c, e, pk):
    """Materialize KmerCount objects (ascending hash) from arrays."""
    if isinstance(pk, tuple):
        kmer_bytes = unpack_kmers_w(np.asarray(pk[0], dtype=np.uint64),
                                    np.asarray(pk[1], dtype=np.uint64),
                                    params.k)
    elif _is_bytes_payload(pk):
        kmer_bytes = pk  # already ASCII windows
    else:
        kmer_bytes = unpack_kmers(np.asarray(pk, dtype=np.uint64), params.k)
    return [
        KmerCount(hash=int(h[i]), kmer=bytes(kmer_bytes[i]),
                  count=int(c[i]), extra_count=int(e[i]))
        for i in range(len(h))
    ]


def _finalize(params: SketchParams, h, c, e, pk):
    return kmercounts_from_arrays(
        params, *_finalize_arrays(params, h, c, e, pk))


class NumpyEngine:
    """Exact host-side batch sketcher."""

    def __init__(self, params: SketchParams):
        self.params = params
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.h = np.empty(0, dtype=np.uint64)
        self.c = np.empty(0, dtype=np.uint64)
        self.e = np.empty(0, dtype=np.uint64)
        # payload: one word for k <= 31, (lo, hi) words for 32 <= k <= 63,
        # an (n, k) ASCII byte matrix for k >= 64 (xwide)
        self.xwide = params.k > 63
        self.wide = 31 < params.k <= 63
        if self.xwide:
            self.pks = [np.empty((0, params.k), dtype=np.uint8)]
        else:
            self.pks = [np.empty(0, dtype=np.uint64)
                        for _ in range(2 if self.wide else 1)]

    @property
    def pk(self):
        return tuple(self.pks) if self.wide else self.pks[0]

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
        k, seed = self.params.k, self.params.hash_seed
        if self.xwide:
            kb = np.ascontiguousarray(packed, dtype=np.uint8)
            hashes = murmur3_batch(kb, seed)
            pk_words = [kb]
        elif self.wide:
            plo, phi = packed
            hashes = murmur3_packed_w(plo, phi, k, seed)
            pk_words = [np.asarray(plo, dtype=np.uint64),
                        np.asarray(phi, dtype=np.uint64)]
        else:
            hashes = murmur3_packed(packed, k, seed)
            pk_words = [np.asarray(packed, dtype=np.uint64)]
        thresh = self._threshold()
        if thresh < 0:
            mask = np.zeros(len(hashes), dtype=bool)
        else:
            mask = hashes <= np.uint64(thresh)
        hashes = hashes[mask]
        pk_words = [w[mask] for w in pk_words]
        rc = np.asarray(rc)[mask].astype(np.uint64)

        h = np.concatenate([self.h, hashes])
        c = np.concatenate([self.c, np.ones(len(hashes), dtype=np.uint64)])
        e = np.concatenate([self.e, rc])
        pks = [np.concatenate([s, w]) for s, w in zip(self.pks, pk_words)]
        order = np.argsort(h, kind="stable")
        h, c, e = h[order], c[order], e[order]
        pks = [w[order] for w in pks]
        if len(h):
            boundary = np.empty(len(h), dtype=bool)
            boundary[0] = True
            np.not_equal(h[1:], h[:-1], out=boundary[1:])
            idx = np.flatnonzero(boundary)
            h = h[idx]
            c = np.add.reduceat(c, idx)
            e = np.add.reduceat(e, idx)
            pks = [w[idx] for w in pks]  # stable: first-seen kmer per hash
        if self.params.sketch_type == "mash":
            keep = self.size
        else:
            below = int(np.searchsorted(h, np.uint64(self.max_hash),
                                        side="right"))
            keep = below + self.size
        self.h, self.c, self.e = h[:keep], c[:keep], e[:keep]
        self.pks = [w[:keep] for w in pks]

    def finalize(self):
        return _finalize(self.params, self.h, self.c, self.e, self.pk)

    def finalize_arrays(self):
        return _finalize_arrays(self.params, self.h, self.c, self.e, self.pk)


class NativeEngine:
    """Production host path: the C++ fold (identity-hash table + adaptive
    admission threshold, finch_native.cpp), bit-identical to NumpyEngine."""

    def __init__(self, params: SketchParams):
        from finch_tpu_torch.native import NativeFold

        self.params = params
        self._wide_impl = None
        if params.k > 31:
            # the fold table stores one u64 payload word (a k <= 31 speed
            # optimization); wide and xwide k run the NumPy fold instead,
            # with the same exact semantics
            self._fold = None
            self._wide_impl = NumpyEngine(params)
            return
        scheme = 1 if params.sketch_type == "scaled" else 0
        max_hash = params.max_hash() if scheme else 0
        self._fold = NativeFold(scheme, params.k, params.hash_seed,
                                params.kmers_to_sketch, max_hash or 0)

    def update(self, packed, rc: np.ndarray) -> None:
        if self._wide_impl is not None:
            self._wide_impl.update(packed, rc)
            return
        self._fold.fold(packed, rc)

    def state_arrays(self):
        """(h, c, e, pk) retained-candidate arrays, ascending hash, with
        the retention rule applied (the engine migration input); pk has
        NumpyEngine.pk's form."""
        if self._wide_impl is not None:
            w = self._wide_impl
            keep = _retention_keep(self.params, w.h)
            pks = [x[:keep] for x in w.pks]
            return (w.h[:keep], w.c[:keep], w.e[:keep],
                    tuple(pks) if len(pks) == 2 else pks[0])
        h, c, e, pk = self._fold.result()
        keep = _retention_keep(self.params, h)
        return h[:keep], c[:keep], e[:keep], pk[:keep]

    def finalize(self):
        return _finalize(self.params, *self.state_arrays())

    def finalize_arrays(self):
        return _finalize_arrays(self.params, *self.state_arrays())


# Auto's two switch points (HybridEngine), in k-mers. On a cold card,
# the first use of the card in this process, the host folds the first
# COLD_SWITCH_AFTER k-mers: a fresh process's card start-up costs more
# than that fold (fresh-process walls, tools/switch_point.py; PERF.md
# §6). On a warm card the host folds only a stream that stays
# below WARM_SWITCH_AFTER[k > 31]: the smallest of the isolate's heads
# on which torch beat the host fold in one warm process on an H100
# (tools/switch_point.py --warm; PERF.md §6): 2,000 reads at
# k = 21 (0.975 of the host fold's wall; 1,000 reads, 130,000 k-mers,
# took 1.71 of it), 1,000 reads at k = 51, whose host fold is NumPy's
# (0.59; 500 reads took 1.17). The warm rule holds only for a stream that
# runs alone: in one warm process, 8 genome streams side by side in
# sketch_files' pool took 1.06-1.42 s each on the warm card against
# 0.67-1.00 s under the cold rule, whose host folds run in parallel on
# the host's cores (slower in 8 of 8 rounds); one after another they took
# 0.71-0.81 s on the warm card against 2.83-3.25 s (PERF.md §6).
COLD_SWITCH_AFTER = 4 << 20
WARM_SWITCH_AFTER = {False: 260_000, True: 100_000}

# HybridEngine streams open in this process, from construction to
# finalize (or to close(), or the engine's collection, for a stream that
# raised)
_open_streams = 0
_streams_lock = threading.Lock()


def _stream_closed() -> None:
    global _open_streams
    with _streams_lock:
        _open_streams -= 1

# CUDA device indices on which a TorchEngine step has returned in this
# process; it only grows, and set.add and `in` are each atomic, so
# sketch_files' threads need no lock around it
_warm_cards: set = set()


def _card_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def mark_card_warm(dev: torch.device) -> None:
    """Record that a TorchEngine step has returned on `dev`: its context,
    kernel libraries and modules are loaded. No-op off CUDA."""
    if dev.type == "cuda":
        _warm_cards.add(_card_index(dev))


def card_is_warm(dev: torch.device) -> bool:
    """Whether a TorchEngine step has returned on this CUDA device in this
    process (never for the CPU). Touches no card while none is warm."""
    return (dev.type == "cuda" and bool(_warm_cards)
            and _card_index(dev) in _warm_cards)


# Host slots a slot-fed engine rings: one the parser fills (the one-batch
# prefetch), one the main thread submits, one whose copy to the card may
# still be in flight; the process mesh's depth (parallel/process_mesh.py)
SLOTS = 3


class HostSlot:
    """One batch's composite planes on the host: `planes`, a (2,
    batch_size) int32 tensor, and `lo`, `hi`, its u32 rows as the arrays
    a reader's `fill` parses into; `copied`, the CUDA event behind its
    last copy to the card (None before one)."""

    __slots__ = ("planes", "lo", "hi", "copied")

    def __init__(self, planes: torch.Tensor):
        self.planes = planes
        self.lo, self.hi = planes.numpy().view(np.uint32)
        self.copied = None


class SlotRing:
    """SLOTS host slots of `batch_size` lanes, handed out in turn; in
    pinned memory when `pinned`, so that a slot's copy to the card is
    asynchronous. `take` waits (meter ``engine.slot_wait``, one item a
    slot) until the slot's last copy has finished."""

    def __init__(self, batch_size: int, pinned: bool):
        self.pinned = pinned
        host = torch.empty((SLOTS, 2, batch_size), dtype=torch.int32,
                           pin_memory=pinned)
        self._slots = [HostSlot(planes) for planes in host]
        self._next = 0

    def take(self) -> HostSlot:
        slot = self._slots[self._next]
        self._next = (self._next + 1) % SLOTS
        wait = get_meter("engine.slot_wait")
        wait.start()
        if slot.copied is not None:
            slot.copied.synchronize()
        wait.stop(1)
        return slot


class TorchEngine:
    """Device batch sketcher: fixed-capacity state on `device`, one step
    per batch of up to `batch_size` k-mers. For k <= 31 the step is
    bottomk.sketch_step (the extract kernel runs for k <= 28 on batches of
    >= 128k lanes, in the JAX package's default configuration: the
    weighted extract and tiers D and D2 join it for k <= 25); for
    32 <= k <= 63 it is bottomk_wide.sketch_step. It refuses k >= 64,
    whose payloads are per-k-mer byte windows: make_engine folds those on
    the host (a NumpyEngine), as the JAX package does.

    At k <= 31 the engine takes slots: `sketch_stream` has the reader
    parse each batch into a slot of the engine's ring (`next_slot`, on the
    parse thread; pinned memory on a card) and hands it back with
    `submit(slot, n)`, which copies the planes to the card asynchronously
    and zeroes their padding there; `update(packed, rc)` pads on the host
    and copies for callers that hold arrays, and for wide k.

    `stats` counts the tier each step took (`wide` for wide steps), the
    host syncs it made and `slot_steps`, the batches stepped from a slot
    (absent before the first)."""

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21,
                 device="cuda"):
        from finch_tpu_torch.ops import bottomk

        self.device = resolve_device(device)
        self.params = params
        self.stats: dict = {}
        if params.k > 63:
            raise FinchMessageError(
                f"TorchEngine folds k <= 63, not {params.k}; make_engine "
                "folds larger k on the host")
        self.wants_composite = params.k <= 31
        self.takes_slots = params.k <= 31
        self._bottomk = bottomk
        self.wide = params.k > 31
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.batch_size = batch_size
        # mash capacity is fixed at kmers_to_sketch; scaled starts small
        # and grows when below-threshold distinct hashes approach it
        if params.sketch_type == "mash":
            self.capacity = max(1, self.size)
        else:
            self.capacity = max(2 * self.size, 1 << 12)
        if self.wide:
            from finch_tpu_torch.ops import bottomk_wide

            self._bkw = bottomk_wide
            self.state = bottomk_wide.empty_state(self.capacity,
                                                  device=self.device)
        else:
            self.state = bottomk.empty_state(self.capacity,
                                             device=self.device)
        self._mh = self.max_hash if self.max_hash is not None else 0
        self._ring: Optional[SlotRing] = None
        self._planes: Optional[torch.Tensor] = None  # the slots' device copy

    def next_slot(self) -> HostSlot:
        """The slot the stream's next batch goes into (the parse thread),
        once its last copy to the card has finished."""
        if self._ring is None:
            self._ring = SlotRing(self.batch_size, self.device.type == "cuda")
        return self._ring.take()

    def submit(self, slot: HostSlot, n: int) -> None:
        """Step on the slot's first n lanes (n == 0 gives the slot back):
        each plane's copy to the device and the zeroing of its padding
        there are queued on the step's stream, whose order keeps the one
        pair of device planes safe to reuse."""
        if not n:
            return
        b = self._bottomk.bucket_pow2(n)
        if self._planes is None:
            self._planes = torch.empty(
                (2, self._bottomk.bucket_pow2(self.batch_size)),
                dtype=torch.int32, device=self.device)
        for src, dst in zip(slot.planes, self._planes):
            with span("engine.upload", 4 * b):
                dst[:n].copy_(src[:n], non_blocking=True)
                if n < b:
                    dst[n:b].zero_()
        if self.device.type == "cuda":
            if slot.copied is None:
                slot.copied = torch.cuda.Event()
            slot.copied.record(torch.cuda.current_stream(self.device))
        self.step_planes(self._planes[0, :b], self._planes[1, :b], n)
        self.stats["slot_steps"] = self.stats.get("slot_steps", 0) + 1

    def close(self) -> None:
        """Release the slot ring and its device planes."""
        self._ring = self._planes = None

    def _pad(self, arr: np.ndarray) -> torch.Tensor:
        n = len(arr)
        b = self._bottomk.bucket_pow2(n)
        with span("engine.upload") as s:
            out = np.zeros(b, dtype=arr.dtype)
            out[:n] = arr
            s.items = out.nbytes
            return u64.from_numpy(out, self.device)

    def update(self, packed, rc: np.ndarray) -> None:
        bs = self.batch_size
        if self.wide:
            plo, phi = packed
            for off in range(0, len(plo), bs):
                self._step_wide(plo[off: off + bs], phi[off: off + bs],
                                rc[off: off + bs])
            return
        for off in range(0, len(packed), bs):
            self._step(packed[off: off + bs], rc[off: off + bs])

    def _step_wide(self, plo, phi, rc) -> None:
        """One wide step; a scaled run reads `below` (one host sync) and
        grows the state and redoes the step when it would overflow."""
        bkw = self._bkw
        plo_d = self._pad(np.asarray(plo, dtype=np.uint64))
        phi_d = self._pad(np.asarray(phi, dtype=np.uint64))
        rc_d = self._pad(np.asarray(rc, dtype=np.uint8))
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            with span("engine.step_wide", len(plo)):
                new_state, below = bkw.sketch_step(
                    self.state, plo_d, phi_d, rc_d, len(plo), self._mh,
                    k=self.params.k, seed=self.params.hash_seed,
                    has_max_hash=is_scaled, stats=self.stats)
            mark_card_warm(self.device)
            if not is_scaled:
                self.state = new_state
                return
            below = self._bottomk._read(below, self.stats)
            if below + self.size <= self.capacity:
                self.state = new_state
                return
            # grow capacity and redo from the unmodified previous state
            new_cap = max(self.capacity * 2, below + self.size)
            self.state = bkw.grow_state(self.state, new_cap)
            self.capacity = new_cap

    def _step(self, chunk_pk, chunk_rc) -> None:
        if chunk_pk.dtype != np.uint32:
            chunk_pk, chunk_rc = composite_planes(chunk_pk, chunk_rc)
        self.step_planes(self._pad(chunk_pk), self._pad(chunk_rc),
                         len(chunk_pk))

    def step_planes(self, lo_d: torch.Tensor, hi_d: torch.Tensor,
                    nvalid: int) -> None:
        """One step (k <= 31) on composite planes already on the device:
        int32 tensors of bucket_pow2(nvalid) lanes, zero past nvalid."""
        bk = self._bottomk
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            with span("engine.step", lo_d.shape[0]):
                new_state, below = bk.sketch_step(
                    self.state, lo_d, hi_d, nvalid, self._mh,
                    k=self.params.k, seed=self.params.hash_seed,
                    has_max_hash=is_scaled, use_kernel=True,
                    stats=self.stats)
            mark_card_warm(self.device)
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
        if self.wide:
            h, c, e, plo, phi = self._bkw.state_arrays(self.state)
            return h, c, e, (plo, phi)
        state, _ = self._bottomk.flush_state(
            self.state, self._mh, k=self.params.k,
            seed=self.params.hash_seed)
        return tuple(u64.to_numpy(t) for t in state[:4])

    def finalize(self):
        self.close()
        return _finalize(self.params, *self._host_state())

    def finalize_arrays(self):
        self.close()
        return _finalize_arrays(self.params, *self._host_state())


class HybridEngine:
    """Host engine that migrates to the device engine for large streams.

    Small inputs finish on the host; large ones move to the card, where
    the host state, already the exact sorted bottom-k with counts, seeds
    a device state (bottomk.state_from_numpy, or
    bottomk_wide.state_from_numpy for wide k, 32 <= k <= 63) and
    sketching continues. Bit-identical either way. When it moves:

    * a cold card (no TorchEngine step has returned on it in this
      process): after the batch that takes the stream to `switch_after`
      k-mers (COLD_SWITCH_AFTER, 4M, by default), since up to there the
      host fold beat a fresh process's card start-up;
    * a warm card (``card_is_warm``), for a stream open alone in the
      process: before the batch that would take the stream to
      WARM_SWITCH_AFTER k-mers, which the host never folds; a new
      stream's state is then an empty TorchEngine state. That point is
      where the card won in one warm process; streams side by side
      (sketch_files' pool) take the cold rule, since their host folds
      run in parallel and their card steps do not (PERF.md §6).

    xwide k (k >= 64) stays on the host fold, as in the JAX package,
    which has no device path for it. Unlike the JAX package, wide k
    migrates too: its host fold is the NumPy one (NativeEngine), several
    times slower than the card's wide step on a large stream (PERF.md).

    At k <= 31 it takes slots as TorchEngine does, from a ring of its own
    that outlives the migration (the parser may hold a slot across it):
    the host fold reads a slot's planes, the card steps copy them. The
    ring is pinned when it is made on a warm card; on a cold one it is
    plain memory until the stream moves to the card, and a pinned ring
    replaces it there: pinning before the cold rule's host fold would
    start the card for nothing."""

    def __init__(self, params: SketchParams, batch_size: int = 1 << 21,
                 switch_after: int = COLD_SWITCH_AFTER, device="cuda"):
        self.params = params
        self.wants_composite = params.k <= 31
        self.takes_slots = params.k <= 31
        self.batch_size = batch_size
        self.switch_after = switch_after
        self.device = resolve_device(device)
        self._host: Optional[NativeEngine] = NativeEngine(params)
        self._dev: Optional[TorchEngine] = None
        self._ring: Optional[SlotRing] = None
        self._seen = 0
        global _open_streams
        with _streams_lock:
            _open_streams += 1
        self._close = weakref.finalize(self, _stream_closed)

    def _migrate(self) -> None:
        from finch_tpu_torch.ops import bottomk, bottomk_wide

        with span("engine.migrate") as s:
            dev = TorchEngine(self.params, batch_size=self.batch_size,
                              device=self.device)
            hh, hc, he, hpk = self._host.state_arrays()
            n = s.items = len(hh)
            while dev.capacity < n:
                # a scaled host state may exceed the initial device capacity
                dev.capacity *= 2
            if not n:
                pass  # nothing folded yet: dev's own empty state is it
            elif dev.wide:
                dev.state = bottomk_wide.state_from_numpy(
                    hh, hc, he, *hpk, dev.capacity, self.device)
            else:
                arrays = [np.full(dev.capacity, U64_MAX, dtype=np.uint64),
                          np.zeros(dev.capacity, dtype=np.uint64),
                          np.zeros(dev.capacity, dtype=np.uint64),
                          np.zeros(dev.capacity, dtype=np.uint64)]
                for dst, src in zip(arrays, (hh, hc, he, hpk)):
                    dst[:n] = src
                arrays += [np.full(bottomk.spill_capacity(dev.capacity),
                                   U64_MAX, dtype=np.uint64),
                           np.zeros(1, dtype=np.int32),
                           np.zeros(1, dtype=np.int32)]
                dev.state = bottomk.state_from_numpy(arrays, self.device)
            self._dev = dev
            self._host = None
            if (self._ring is not None and not self._ring.pinned
                    and self.device.type == "cuda"):
                self._ring = self._new_ring()  # pinned from here on

    def _new_ring(self) -> SlotRing:
        pinned = self.device.type == "cuda" and (
            self._dev is not None or card_is_warm(self.device))
        return SlotRing(self.batch_size, pinned)

    def _warm_handoff(self, n: int) -> bool:
        """Whether to move to the card before folding the next `n`
        k-mers: k <= 63, they reach the warm switch point, no other
        stream is open in the process, and the card is warm."""
        k = self.params.k
        return (k <= 63
                and self._seen + n >= WARM_SWITCH_AFTER[k > 31]
                and _open_streams == 1 and card_is_warm(self.device))

    @property
    def stats(self) -> dict:
        return self._dev.stats if self._dev is not None else {}

    def _warm_start(self, n: int) -> None:
        if self._dev is None and self._warm_handoff(n):
            with span("engine.warm_start", 1):
                self._migrate()

    def next_slot(self) -> HostSlot:
        """The slot the stream's next batch goes into (the parse thread)."""
        if self._ring is None:
            self._ring = self._new_ring()
        return self._ring.take()

    def submit(self, slot: HostSlot, n: int) -> None:
        """Fold the slot's first n lanes: on the host before the move to
        the card, else a card step (n == 0 gives the slot back)."""
        if not n:
            return
        self._warm_start(n)
        if self._dev is not None:
            self._dev.submit(slot, n)
        else:
            self._host_fold(slot.lo[:n], slot.hi[:n])

    def close(self) -> None:
        """End the stream (finalize, or a batch that raised): release the
        slot ring (and the card engine's), and leave the streams open in
        the process."""
        self._close()
        self._ring = None
        if self._dev is not None:
            self._dev.close()

    def update(self, packed, rc: np.ndarray) -> None:
        self._warm_start(len(rc))
        if self._dev is not None:
            self._dev.update(packed, rc)
        else:
            self._host_fold(packed, rc)

    def _host_fold(self, packed, rc: np.ndarray) -> None:
        with span("engine.host_fold", len(rc)):
            if self.params.k > 63:
                # xwide k has no device step (TorchEngine refuses it)
                self._host.update(packed, rc)
                return
            if not isinstance(packed, tuple) and packed.dtype == np.uint32:
                # composite planes: decode for the host fold
                comp = ((rc.astype(np.uint64) << np.uint64(32))
                        | packed.astype(np.uint64))
                self._host.update(comp >> np.uint64(1),
                                  (packed & np.uint32(1)).astype(np.uint8))
            else:
                self._host.update(packed, rc)
        self._seen += len(rc)
        if self._seen >= self.switch_after:
            self._migrate()

    def finalize(self):
        self.close()
        return (self._host or self._dev).finalize()

    def finalize_arrays(self):
        self.close()
        return (self._host or self._dev).finalize_arrays()


def _mesh_engine(params: SketchParams, batch_size: int, device="cuda"):
    """Data-parallel sketching over every card, bit-identical to the host
    engines. Over several cards, one worker process a card, each folding
    whole batches (parallel/process_mesh.py); on one card or the CPU (one
    CPU shard with device="cpu"), the lockstep mesh
    (parallel/sharded_sketch.py), whose shards are at least 16384 lanes
    wide, so for up to 16 shards a full default batch gives shards of >=
    131072 lanes, which run the kernels."""
    from finch_tpu_torch.parallel import ShardedSketchEngine, make_mesh

    mesh = make_mesh(device=device)
    if mesh.size > 1 and mesh.devices[0].type == "cuda":
        from finch_tpu_torch.parallel.process_mesh import ProcessMeshEngine

        return ProcessMeshEngine(params, mesh.devices, batch_size=batch_size)
    return ShardedSketchEngine(
        params, mesh,
        batch_size_per_device=max(batch_size // mesh.size, 1 << 14))


def make_engine(params: SketchParams, backend: str = "auto",
                batch_size: int = 1 << 21, device="cuda"):
    """backend: "auto" (HybridEngine on the current card, also where
    several are present; the host fold when the caller asked for
    device="cpu"), "torch", "mesh", "native" or "numpy". The torch
    backend folds k >= 64 on the host (a NumpyEngine), as the JAX
    package does, after the same device check."""
    if backend == "numpy":
        return NumpyEngine(params)
    if backend == "native":
        return NativeEngine(params)
    if backend == "torch":
        resolve_device(device)
        if params.k > 63:
            return NumpyEngine(params)
        return TorchEngine(params, batch_size=batch_size, device=device)
    if backend == "mesh":
        if params.k > 31:
            raise FinchMessageError(
                "the mesh backend supports k <= 31; wide k-mers run on the "
                "numpy/native/torch backends")
        return _mesh_engine(params, batch_size, device)
    if backend == "auto":
        if resolve_device(device).type == "cuda":
            # one card, also where several are present (unlike the JAX
            # package): in fresh processes, what a `finch sketch` user
            # waits for, HybridEngine on one card took about half the wall
            # of either mesh over four cards, whose start-up (a context a
            # card; the process mesh's workers) outweighs their folding
            # (PERF.md §6). It folds on the host up to 4M k-mers while the
            # card is cold (fresh-process walls), and hands a stream open
            # alone that reaches WARM_SWITCH_AFTER to a warm card before
            # folding it (warm-process walls, PERF.md §6)
            return HybridEngine(params, batch_size=batch_size, device=device)
        return NativeEngine(params)
    raise FinchMessageError(f"unknown backend {backend!r}")
