"""Sketch containers.

Mirrors the reference's in-memory model (finch-rs/lib/src/serialization/mod.rs:45-65
`Sketch`, finch-rs/lib/src/sketch_schemes/mod.rs:15-22 `KmerCount`) with
a NumPy struct-of-arrays view for the device/distance paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from finch_tpu_torch.models.params import FilterParams, SketchParams


@dataclass
class KmerCount:
    hash: int
    kmer: bytes
    count: int
    extra_count: int
    label: Optional[bytes] = None

    def astuple(self):
        return (self.hash, self.kmer, self.count, self.extra_count, self.label)


class LazyKmerCounts(list):
    """KmerCount list materialized from struct-of-arrays on first element
    access. Serialization readers hand sketches to the distance/device
    paths, which only consume the SoA views (hash_array & co.) — served
    directly from the arrays, so a 10k-sketch DB load never builds its
    ~10^7 KmerCount objects unless something actually inspects them. No
    code path mutates sketch.hashes in place (they are replaced
    wholesale), so materialize-on-read is sufficient."""

    __slots__ = ("_soa",)

    def __init__(self, h_arr, kmer_list, c_arr, e_arr):
        super().__init__()
        self._soa = (np.asarray(h_arr, dtype=np.uint64), kmer_list,
                     np.asarray(c_arr, dtype=np.uint32),
                     np.asarray(e_arr, dtype=np.uint32))

    def _force(self) -> None:
        soa = self._soa
        if soa is None:
            return
        self._soa = None
        h, ks, c, e = soa
        if callable(ks):
            # deferred kmer/label decode (e.g. per-element capnp Data
            # pointers); returns (kmer_list, label_list or None)
            ks, labels = ks()
        else:
            labels = None
        if isinstance(ks, np.ndarray):
            ks = ks.tolist()  # fixed-width 'S' store -> real bytes
        if labels is None:
            labels = [None] * len(ks)
        super().extend(
            KmerCount(hash=hh, kmer=km, count=cc, extra_count=ee,
                      label=lb)
            for hh, km, cc, ee, lb in zip(h.tolist(), ks, c.tolist(),
                                          e.tolist(), labels))

    def __len__(self):
        if self._soa is not None:
            return len(self._soa[0])
        return super().__len__()

    def __iter__(self):
        self._force()
        return super().__iter__()

    def __getitem__(self, i):
        self._force()
        return super().__getitem__(i)

    def __contains__(self, x):
        self._force()
        return super().__contains__(x)

    def __reversed__(self):
        self._force()
        return super().__reversed__()

    def __repr__(self):
        self._force()
        return super().__repr__()

    # list mutators/readers must force first: operating on the empty
    # backing store of an unforced container would silently reorder or
    # drop elements (public-API footgun — ADVICE r2). Binary ops force
    # the OTHER operand too — list.__add__/__lt__ on an unforced lazy
    # RHS would read its empty backing store.
    def _make_forcing(name):  # noqa: N805 — class-body helper
        def method(self, *args, **kwargs):
            self._force()
            for a in args:
                if isinstance(a, LazyKmerCounts):
                    a._force()
            return getattr(list, name)(self, *args, **kwargs)

        method.__name__ = name
        return method

    for _name in ("append", "extend", "insert", "remove", "pop", "clear",
                  "index", "count", "sort", "reverse", "copy",
                  "__setitem__", "__delitem__", "__add__",
                  "__iadd__", "__mul__", "__rmul__", "__imul__",
                  "__lt__", "__le__", "__gt__", "__ge__"):
        locals()[_name] = _make_forcing(_name)
    del _name, _make_forcing

    def __radd__(self, other):
        # list has no __radd__; plain_list + lazy lands here
        self._force()
        return other + list(self)

    def __eq__(self, other):
        self._force()
        if isinstance(other, LazyKmerCounts):
            other._force()
        return list.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = None


@dataclass
class Sketch:
    name: str
    seq_length: int
    num_valid_kmers: int
    comment: str
    hashes: List[KmerCount]
    filter_params: FilterParams
    sketch_params: SketchParams

    def __len__(self) -> int:
        return len(self.hashes)

    def is_empty(self) -> bool:
        return len(self.hashes) == 0

    # --- struct-of-arrays views (device/distance paths) ---
    # served straight from a lazy container's arrays when nothing has
    # materialized the KmerCount objects yet

    def hash_array(self) -> np.ndarray:
        soa = getattr(self.hashes, "_soa", None)
        if soa is not None:
            return soa[0]
        return np.asarray([kc.hash for kc in self.hashes], dtype=np.uint64)

    def count_array(self) -> np.ndarray:
        soa = getattr(self.hashes, "_soa", None)
        if soa is not None:
            return soa[2]
        return np.asarray([kc.count for kc in self.hashes], dtype=np.uint32)

    def extra_count_array(self) -> np.ndarray:
        soa = getattr(self.hashes, "_soa", None)
        if soa is not None:
            return soa[3]
        return np.asarray([kc.extra_count for kc in self.hashes],
                          dtype=np.uint32)

    def kmer_list(self) -> List[bytes]:
        """The kmer byte strings, without materializing KmerCount objects
        for lazily-loaded sketches (deferred decoders are invoked once)."""
        return self.kmer_label_lists()[0]

    def kmer_label_lists(self):
        """(kmers, labels) without materializing KmerCount objects;
        labels is None when no entry carries a label (the common case —
        only .bsk inputs can set them)."""
        soa = getattr(self.hashes, "_soa", None)
        if soa is not None:
            ks = soa[1]
            labels = None
            if callable(ks):
                ks, labels = ks()
                # cache the decode back into the SoA so every later
                # consumer (re-serialization, _force) pays it once —
                # the deferred decoder is a full per-element pointer
                # walk at DB scale
                pair = (ks, labels)
                new_soa = list(soa)
                new_soa[1] = lambda: pair
                self.hashes._soa = tuple(new_soa)
            if labels is not None and all(lb is None for lb in labels):
                labels = None
            if isinstance(ks, np.ndarray):
                return ks.tolist(), labels
            return list(ks), labels
        labels = [kc.label for kc in self.hashes]
        if all(lb is None for lb in labels):
            labels = None
        return [kc.kmer for kc in self.hashes], labels
