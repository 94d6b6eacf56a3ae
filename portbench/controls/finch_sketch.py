"""The control of `correct` for the entry ``finch_sketch``: the plain
reference put in the program's place with one stated guarantee broken,
judged by the same comparison as the program's output. It has to come
out as not correct.

The mash state holds n_hashes entries instead of n_hashes x oversketch,
so filtering works on too few candidates (the configuration's "filtering
runs over a state of 200,000 entries").

``python3 -m portbench.controls.run --workload <cell> --seeds a b c``
reads it at the cell's own size, on the card.
"""

from __future__ import annotations

from portbench.reference import sketch as sketch_ref


def sketch_document(ref: dict) -> dict:
    """A reference sketch in the shape of a parsed .sk document."""
    head = ("kmer", "sketchSize", "hashSeed", "hashType", "hashBits",
            "canonical", "scale")
    s = {k: ref[k] for k in ("name", "seqLength", "numValidKmers",
                             "comment", "kmers", "counts")}
    s["filters"] = {k: str(v) for k, v in ref["filters"].items()}
    s["hashes"] = [str(h) for h in ref["hashes"]]
    return {**{k: ref[k] for k in head}, "sketches": [s]}


def numbers(config: dict, traffic: dict, data: dict, device: str) -> dict:
    c = config
    kw = dict(k=c["kmer_length"], n_hashes=c["n_hashes"],
              seed=c["hash_seed"], strand_filter=c["strand_filter"],
              err_filter=float(c["err_filter_percent"]), device=device)
    ref = sketch_ref.reference_sketch(
        data["fastq"], kmers_to_sketch=c["n_hashes"] * c["oversketch"],
        **kw)
    ctl = sketch_ref.reference_sketch(
        data["fastq"], kmers_to_sketch=c["n_hashes"], strict=False, **kw)
    return sketch_ref.compare(sketch_document(ctl), ref)
