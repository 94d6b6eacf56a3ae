"""The control of `correct` for the entry ``finch_sketch_wide``, as
``controls/finch_sketch.py`` is for ``finch_sketch``: the wide plain
reference put in the program's place with its mash state holding
n_hashes entries instead of n_hashes x oversketch (the configuration's
"filtering runs over a state of 200,000 entries" broken), judged by the
same comparison. It has to come out as not correct.

``python3 -m portbench.controls.run --workload <cell> --seeds a b c``
reads it at the cell's own size, on the card.
"""

from __future__ import annotations

from portbench.controls.finch_sketch import sketch_document
from portbench.reference import sketch_wide as sketch_ref


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
