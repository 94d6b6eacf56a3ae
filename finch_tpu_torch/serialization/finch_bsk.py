""".bsk codec — finch's native binary multisketch (Cap'n Proto).

Schema: finch-rs/lib/src/serialization/finch.capnp; writer/reader
semantics: finch-rs/lib/src/serialization/mod.rs:123-224. Field
offsets pinned against the capnpc-generated accessors in
finch_capnp.rs (data/pointer indices noted inline).
"""

from __future__ import annotations

from typing import List

from finch_tpu_torch.core.sketch import (KmerCount, LazyKmerCounts,
                                   Sketch)
from finch_tpu_torch.errors import FinchSchemaError
from finch_tpu_torch.models.params import FilterParams, SketchParams, U32_MAX
from finch_tpu_torch.serialization.capnp_lite import MessageBuilder, MessageReader

# SketchMethod enum (finch.capnp:4-8)
METHOD_MURMUR3 = 0
METHOD_MURMUR3_SCALED = 1
METHOD_NONE = 2

# struct sizes (finch_capnp.rs STRUCT_SIZE constants)
SZ_MULTISKETCH = (0, 1)
SZ_SKETCH = (2, 5)
SZ_KMERCOUNT = (2, 2)
SZ_FILTERPARAMS = (4, 0)
SZ_SKETCHPARAMS = (5, 0)


def _set_sketch_params(b, params: SketchParams) -> None:
    """mod.rs:67-100; offsets per finch_capnp.rs:253-282."""
    if params.sketch_type == "mash":
        b.set("H", 0, METHOD_MURMUR3)
        b.set("B", 2, params.kmer_length)
        b.set("Q", 1, params.kmers_to_sketch)
        b.set("Q", 2, params.hash_seed)
        b.set("Q", 3, params.final_size)
        b.set_bool(24, params.no_strict)
    elif params.sketch_type == "scaled":
        b.set("H", 0, METHOD_MURMUR3_SCALED)
        b.set("B", 2, params.kmer_length)
        b.set("Q", 1, params.kmers_to_sketch)
        b.set("Q", 2, params.hash_seed)
        b.set("d", 4, params.scale)
    else:
        b.set("H", 0, METHOD_NONE)
        b.set("B", 2, params.kmer_length)


def _get_sketch_params(r) -> SketchParams:
    """mod.rs:102-121."""
    method = r.get_u16(0)
    k = r.get_u8(2)
    if method == METHOD_MURMUR3:
        return SketchParams.mash(
            kmers_to_sketch=r.get_u64(1), final_size=r.get_u64(3),
            no_strict=r.get_bool(24), kmer_length=k, hash_seed=r.get_u64(2))
    if method == METHOD_MURMUR3_SCALED:
        return SketchParams.scaled(
            kmers_to_sketch=r.get_u64(1), kmer_length=k, scale=r.get_f64(4),
            hash_seed=r.get_u64(2))
    if method == METHOD_NONE:
        return SketchParams.all_counts(kmer_length=k)
    raise FinchSchemaError(f"unknown sketch method {method}")


def _write_kmercounts_bulk(msg: MessageBuilder, b, sketch: Sketch) -> bool:
    """Vectorized KmerCount composite-list write for the common shape
    (no labels, equal-length kmer byte strings — every sketcher output).

    Emits bytes identical to the per-element loop: same allocation order
    (element region, then kmer payloads in element order), same pointer
    encodings. At DB scale (10k sketches x 1000 hashes) the per-element
    path builds ~1e7 StructBuilders and pack_into calls; this is three
    numpy stores. Returns False (write nothing) when the shape needs the
    general path."""
    import numpy as np

    n = len(sketch.hashes)
    kmers, labels = sketch.kmer_label_lists()
    if labels is not None:
        return False
    lens = {len(km) for km in kmers}
    if len(lens) > 1:
        return False
    klen = lens.pop() if lens else 0

    soa = getattr(sketch.hashes, "_soa", None)
    if soa is not None:
        h = soa[0]
        c = soa[2].astype(np.uint64)
        e = soa[3].astype(np.uint64)
    else:
        h = np.fromiter((kc.hash for kc in sketch.hashes), np.uint64, n)
        c = np.fromiter((min(kc.count, U32_MAX) for kc in sketch.hashes),
                        np.uint64, n)
        e = np.fromiter(
            (min(kc.extra_count, U32_MAX) for kc in sketch.hashes),
            np.uint64, n)

    elem0 = msg.init_composite_region(b.ptr_ofs(2), n, *SZ_KMERCOUNT)
    kw = (klen + 7) // 8
    kdata0 = msg.alloc(n * kw)

    stride = sum(SZ_KMERCOUNT)
    idx = np.arange(n, dtype=np.int64)
    # kmer Data pointers: element e's payload at kdata0 + e*kw (klen == 0
    # collapses every target to the same end-of-list offset, matching the
    # per-element writer's sequence of zero-word allocations)
    targets = kdata0 + idx * kw
    ptr_pos = elem0 + idx * stride + SZ_KMERCOUNT[0]
    off_signed = targets - (ptr_pos + 1)
    # same fail-loudly invariant as MessageBuilder._check_offset: a
    # pointer offset is a signed 30-bit word count, and silently masking
    # an overflow would emit structurally-valid-but-wrong pointers
    if n and not (int(off_signed.min()) >= -(1 << 29)
                  and int(off_signed.max()) < (1 << 29)):
        from finch_tpu_torch.serialization.capnp_lite import CapnpError

        raise CapnpError("message exceeds single-segment pointer range")
    off = off_signed.astype(np.uint64)
    ptr_words = (np.uint64(1) | ((off & np.uint64((1 << 30) - 1)) << np.uint64(2))
                 | np.uint64((2 << 32) | (klen << 35)))

    view = np.frombuffer(msg.buf, dtype=np.uint64,
                         offset=elem0 * 8, count=n * stride)
    try:
        mat = view.reshape(n, stride)
        mat[:, 0] = h
        mat[:, 1] = c | (e << np.uint64(32))
        mat[:, 2] = ptr_words
        # label pointer column stays null (zero-filled by alloc)
    finally:
        del mat, view  # release the buffer export so the bytearray can grow

    if klen:
        if klen % 8 == 0:
            payload = b"".join(kmers)
        else:
            padded = np.zeros((n, kw * 8), dtype=np.uint8)
            if n:
                padded[:, :klen] = np.frombuffer(
                    b"".join(kmers), dtype=np.uint8).reshape(n, klen)
            payload = padded.tobytes()
        msg.buf[kdata0 * 8 : kdata0 * 8 + len(payload)] = payload
    return True


def write_finch_file(sketches: List[Sketch]) -> bytes:
    """mod.rs:123-166."""
    msg = MessageBuilder()
    root = msg.root_struct(*SZ_MULTISKETCH)
    cap_sketches = root.init_composite_list(0, len(sketches), *SZ_SKETCH)
    for sketch, b in zip(sketches, cap_sketches):
        b.set_text(0, sketch.name)
        b.set("Q", 0, sketch.seq_length)
        b.set("Q", 1, sketch.num_valid_kmers)
        b.set_text(1, sketch.comment)

        if not _write_kmercounts_bulk(msg, b, sketch):
            hashes = b.init_composite_list(2, len(sketch.hashes),
                                           *SZ_KMERCOUNT)
            for kc, hb in zip(sketch.hashes, hashes):
                hb.set("Q", 0, kc.hash)
                hb.set_data(0, kc.kmer)
                # counts are u32 in the schema; saturate like the
                # sketcher's saturating_add (mash.rs:47-49) instead of
                # crashing on merged counts past u32::MAX
                hb.set("I", 2, min(kc.count, U32_MAX))
                hb.set("I", 3, min(kc.extra_count, U32_MAX))
                if kc.label is not None:
                    hb.set_data(1, kc.label)

        fp = sketch.filter_params
        fb = b.init_struct(3, *SZ_FILTERPARAMS)
        fb.set_bool(0, fp.filter_on or False)
        fb.set("I", 1, fp.abun_filter[0] or 0)
        fb.set("I", 2, fp.abun_filter[1] if fp.abun_filter[1] is not None
               else U32_MAX)
        fb.set("d", 2, fp.err_filter)
        fb.set("d", 3, fp.strand_filter)

        _set_sketch_params(b.init_struct(4, *SZ_SKETCHPARAMS),
                           sketch.sketch_params)
    return msg.to_bytes()


def read_finch_file(data: bytes) -> List[Sketch]:
    """mod.rs:168-224 (traversal limit 1Gi words, low_abun 0 -> None,
    high_abun u32::MAX -> None)."""
    root = MessageReader(data, traversal_limit_words=1 << 30).root()
    cap_sketches = root.get_ptr(0)
    sketches: List[Sketch] = []
    if cap_sketches is None:
        return sketches
    for cs in cap_sketches.structs():
        hashes = []
        hl = cs.get_ptr(2)
        if hl is not None and hl.composite_layout() == (2, 2):
            # bulk path: hash/count/extra come from a strided view of the
            # element data words; the kmer/label Data pointers decode
            # per-element only if something materializes the KmerCounts
            # (the distance paths read just the SoA views)
            import numpy as np

            dmat = hl.data_words_matrix()
            h_arr = dmat[:, 0].copy()
            c_arr = (dmat[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            e_arr = (dmat[:, 1] >> np.uint64(32)).astype(np.uint32)

            def _decode(hl=hl):
                kmers, labels = [], []
                for ch in hl.structs():
                    # presence (has_label), not truthiness: an empty-but-
                    # present Data field round-trips as b""
                    # (mod.rs:178-182)
                    kmers.append(ch.get_data(0) or b"")
                    labels.append(ch.get_data(1))
                return kmers, labels

            hashes = LazyKmerCounts(h_arr, _decode, c_arr, e_arr)
        elif hl is not None:
            for ch in hl.structs():
                label = ch.get_data(1)
                hashes.append(KmerCount(
                    hash=ch.get_u64(0),
                    kmer=ch.get_data(0) or b"",
                    count=ch.get_u32(2),
                    extra_count=ch.get_u32(3),
                    label=label,
                ))
        sp = cs.get_ptr(4)
        sketch_params = (_get_sketch_params(sp) if sp is not None
                         else SketchParams.mash())
        fpr = cs.get_ptr(3)
        if fpr is not None:
            low = fpr.get_u32(1)
            high = fpr.get_u32(2)
            filter_params = FilterParams(
                filter_on=fpr.get_bool(0),
                abun_filter=(None if low == 0 else low,
                             None if high == U32_MAX else high),
                err_filter=fpr.get_f64(2),
                strand_filter=fpr.get_f64(3),
            )
        else:
            # an absent filterParams struct decodes as all-zero fields in
            # the reference: low=0 -> None, high=0 -> Some(0)
            # (mod.rs:197-204)
            filter_params = FilterParams(filter_on=False,
                                         abun_filter=(None, 0),
                                         err_filter=0.0, strand_filter=0.0)
        sketches.append(Sketch(
            name=cs.get_text(0) or "",
            seq_length=cs.get_u64(0),
            num_valid_kmers=cs.get_u64(1),
            comment=cs.get_text(1) or "",
            hashes=hashes,
            sketch_params=sketch_params,
            filter_params=filter_params,
        ))
    return sketches
