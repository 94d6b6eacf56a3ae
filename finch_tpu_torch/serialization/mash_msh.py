""".msh codec — Mash-compatible binary sketches (Cap'n Proto).

Schema: finch-rs/lib/src/serialization/mash.capnp; writer/reader
semantics: finch-rs/lib/src/serialization/mash.rs:12-132. Offsets
pinned against mash_capnp.rs accessors. Quirks reproduced:
  * hashSeed has wire default 42 (XOR mask; mash.capnp:115)
  * reader builds Mash params with kmers_to_sketch=0, no_strict=true
    (mash.rs:65-73)
  * missing counts -> count=1/extra=0; present -> extra_count = count/2
    (mash.rs:94-118)
"""

from __future__ import annotations

from typing import List

from finch_tpu_torch.core.sketch import (KmerCount,  # noqa: F401
                                   LazyKmerCounts, Sketch)
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.serialization.capnp_lite import MessageBuilder, MessageReader

SZ_MINHASH = (3, 4)
SZ_REFERENCE_LIST = (0, 1)
SZ_REFERENCE = (3, 7)


def write_mash_file(sketches: List[Sketch]) -> bytes:
    """mash.rs:12-58."""
    params = SketchParams.from_sketches(sketches)
    msg = MessageBuilder()
    root = msg.root_struct(*SZ_MINHASH)
    root.set("I", 0, params.k)                          # kmerSize
    root.set("I", 5, params.hash_info()[2] & 0xFFFFFFFF, mask=42)  # hashSeed
    root.set("f", 4, 0.0)                               # error
    root.set_bool(97, False)                            # noncanonical
    root.set_bool(98, False)                            # preserveCase
    root.set_text(2, "ACGT")                            # alphabet
    largest = max((len(s.hashes) for s in sketches), default=1)
    root.set("I", 1, params.k)                          # windowSize
    root.set("I", 2, largest)                           # minHashesPerWindow
    root.set_bool(96, True)                             # concatenated

    ref_list = root.init_struct(3, *SZ_REFERENCE_LIST)  # referenceList @11
    refs = ref_list.init_composite_list(0, len(sketches), *SZ_REFERENCE)
    for sketch, rb in zip(sketches, refs):
        rb.set_text(2, sketch.name)
        rb.set_text(3, sketch.comment)
        rb.set("Q", 1, sketch.seq_length)               # length64
        rb.set("Q", 2, sketch.num_valid_kmers)          # numValidKmers
        # SoA-aware: no KmerCount forcing, one numpy store per list.
        # Counts saturate to u32 like the sketcher's saturating_add
        # (mash.rs:47-49) instead of crashing on merged counts past
        # u32::MAX.
        soa = getattr(sketch.hashes, "_soa", None)
        if soa is not None:
            h_arr, c_arr = soa[0], soa[2]
            import numpy as np

            c_arr = np.minimum(c_arr.astype(np.int64, copy=False),
                               0xFFFFFFFF).astype(np.uint32)
        else:
            import numpy as np

            h_arr = np.fromiter((kc.hash for kc in sketch.hashes),
                                np.uint64, len(sketch.hashes))
            c_arr = np.fromiter(
                (min(kc.count, 0xFFFFFFFF) for kc in sketch.hashes),
                np.uint32, len(sketch.hashes))
        rb.set_primitive_list(5, "Q", h_arr)
        rb.set_primitive_list(6, "I", c_arr)
    return msg.to_bytes()


def read_mash_file(data: bytes) -> List[Sketch]:
    """mash.rs:60-132."""
    root = MessageReader(data, traversal_limit_words=1 << 30).root()
    sketch_params = SketchParams.mash(
        kmers_to_sketch=0, final_size=0, no_strict=True,
        hash_seed=root.get_u32(5, mask=42),
        kmer_length=root.get_u32(0) & 0xFF,
    )
    ref_list = root.get_ptr(3)          # referenceList
    ref_list_old = root.get_ptr(0)      # referenceListOld
    refs = None
    if ref_list is not None:
        refs = ref_list.get_ptr(0)
    if refs is None and ref_list_old is not None:
        refs = ref_list_old.get_ptr(0)
    sketches: List[Sketch] = []
    if refs is None:
        return sketches
    import numpy as np

    for ref in refs.structs():
        hl = ref.get_ptr(5)
        h_arr = (hl.primitives_array(np.uint64).copy()
                 if hl is not None else np.empty(0, dtype=np.uint64))
        cl = ref.get_ptr(6)
        # missing counts -> count=1, extra=0; present -> extra = count/2
        # (mash.rs:94-118); SoA views serve the distance paths without
        # building KmerCount objects
        if cl is None or cl.count == 0:
            c_arr = np.ones(len(h_arr), dtype=np.uint32)
            e_arr = np.zeros(len(h_arr), dtype=np.uint32)
        else:
            c_arr = cl.primitives_array(np.uint32).copy()
            e_arr = c_arr // 2
            if len(c_arr) != len(h_arr):
                # the reference zips hashes64 with counts32, truncating to
                # the shorter (mash.rs:105-118) — keep the SoA views and
                # the materialized list in agreement
                n = min(len(h_arr), len(c_arr))
                h_arr, c_arr, e_arr = h_arr[:n], c_arr[:n], e_arr[:n]
        kmercounts = LazyKmerCounts(h_arr, [b""] * len(h_arr), c_arr,
                                    e_arr)
        sketches.append(Sketch(
            name=ref.get_text(2) or "",
            seq_length=ref.get_u64(1),
            num_valid_kmers=ref.get_u64(2),
            comment=ref.get_text(3) or "",
            hashes=kmercounts,
            sketch_params=sketch_params,
            filter_params=FilterParams(),
        ))
    return sketches
