"""Sketching entry points — the equivalents of finch's library API
(finch-rs/lib/src/lib.rs:29-94 `sketch_files` / `sketch_stream`), and the
counterpart of ``finch_tpu/core/sketching.py``.

A sketch job streams batches of packed canonical k-mers from the C++
parser into a sketching engine (device or host backend), then applies
filtering and the scheme's post-filter rule on the (small) candidate set.
The device engines run on `device` ("cuda" unless the caller asks for
"cpu"); without a card they raise.
"""

from __future__ import annotations

import os
import stat
from typing import List, Optional, Sequence

from finch_tpu_torch.core.sketch import Sketch
from finch_tpu_torch.models.allcounts import AllCountsEngine
from finch_tpu_torch.models.engine import (_finalize_arrays,
                                           kmercounts_from_arrays,
                                           make_engine, resolve_device)
from finch_tpu_torch.models.params import FilterParams, SketchParams
from finch_tpu_torch.native import FORMAT_FASTQ, KmerReader
from finch_tpu_torch.utils.metrics import (get_meter, metrics_enabled,
                                           report, span)

def _make_engine(sketch_params: SketchParams, backend: str, batch_size: int,
                 device):
    if sketch_params.sketch_type == "none":
        return AllCountsEngine(sketch_params)
    return make_engine(sketch_params, backend=backend, batch_size=batch_size,
                       device=device)


def _is_stream(source) -> bool:
    """True for a path that cannot be read twice (a FIFO, a process
    substitution): the parallel and fused pipelines sniff its first bytes
    and rewind, so only the serial reader, which streams its fd and replays
    the sniffed bytes, may take it."""
    if isinstance(source, (bytes, bytearray, memoryview)) or source == "-":
        return False
    try:
        return not stat.S_ISREG(os.stat(source).st_mode)
    except OSError:
        return False  # the parser reports the missing file


def _choose_reader(source, k: int, canonical: bool, batch_size: int,
                   parser_threads: Optional[int] = None,
                   composite: bool = False):
    """Within-file parallel parsing via the native streaming pipeline
    whenever more than one core is available; the plain serial parser
    otherwise (and for stdin or a FIFO, whose fd streams with O(1) memory).
    Either way the k-mer stream and totals are identical."""
    from finch_tpu_torch.native import StreamingParallelReader, XWideReader

    if k > 63:
        # arbitrary k (the reference hashes byte windows of any k,
        # mash.rs:73-79): run-mode parser + host byte-window canonicalizer
        return XWideReader(source, k=k, canonical=canonical,
                           batch_size=batch_size)
    if k > 31:
        # wide k (32..=63) streams through the serial reader's two-word
        # path; the parallel pipeline's chunk layout is single-word
        return KmerReader(source, k=k, canonical=canonical,
                          batch_size=batch_size)
    if source == "-" or _is_stream(source):
        return KmerReader(source, k=k, canonical=canonical,
                          batch_size=batch_size, composite=composite)
    cores = (os.cpu_count() or 1) if parser_threads is None \
        else parser_threads
    if cores > 1:
        return StreamingParallelReader(
            source, k=k, canonical=canonical,
            batch_size=batch_size, threads=parser_threads,
            composite=composite)
    return KmerReader(source, k=k, canonical=canonical,
                      batch_size=batch_size, composite=composite)


def _fused_native_ok(source, sketch_params: SketchParams, backend: str,
                     device) -> bool:
    """The fused C++ parse+fold pipeline applies when the work is
    host-bound (native backend, or auto on the CPU), the source is a
    path, and the scheme folds by hash (not AllCounts)."""
    if sketch_params.sketch_type == "none":
        return False
    if sketch_params.k > 31:
        return False  # wide k streams through the two-word serial path
    if isinstance(source, (bytes, bytearray, memoryview)):
        return False
    if source == "-" or _is_stream(source):
        return False  # stdin and FIFOs stream through the serial fd reader
    if backend == "native":
        return True
    return backend == "auto" and resolve_device(device).type == "cpu"


def sketch_stream(source, name: str, sketch_params: SketchParams,
                  filters: FilterParams, backend: str = "auto",
                  batch_size: int = 1 << 21,
                  parser_threads: Optional[int] = None,
                  device="cuda", engine_out: Optional[list] = None
                  ) -> Sketch:
    """Sketch one FASTA/FASTQ(.gz) source (path or bytes). lib.rs:51-94.

    engine_out, when given, receives the engine (its `stats` count the
    device steps per tier).

    The whole call is the span ``sketch.stream`` (utils/metrics.py), the
    root of the spans below it on this thread."""
    with span("sketch.stream") as root:
        sketch = _sketch_stream(source, name, sketch_params, filters,
                                backend, batch_size, parser_threads, device,
                                engine_out)
        root.items = sketch.num_valid_kmers
    if metrics_enabled():
        report()
    return sketch


def _sketch_stream(source, name, sketch_params, filters, backend,
                   batch_size, parser_threads, device, engine_out) -> Sketch:
    if backend in ("auto", "torch", "mesh"):
        resolve_device(device)
    filter_params = filters.copy()
    if _fused_native_ok(source, sketch_params, backend, device):
        return _sketch_stream_fused(source, name, sketch_params,
                                    filter_params, parser_threads)
    with span("sketch.open"):
        engine = _make_engine(sketch_params, backend, batch_size, device)
        if engine_out is not None:
            engine_out.append(engine)
        canonical = sketch_params.sketch_type != "none"
        # ProcessMeshEngine, and TorchEngine and HybridEngine at k <= 31
        takes_slots = getattr(engine, "takes_slots", False)
        if takes_slots:
            batch_size = engine.batch_size  # the reader fills its slots
        reader = _choose_reader(
            source, sketch_params.k, canonical, batch_size,
            parser_threads=parser_threads,
            composite=getattr(engine, "wants_composite", False))
    # the parse thread only meters: a profiler records on this thread alone
    parse_m = get_meter("parse_kmers")

    # one-batch prefetch pipeline: the C++ parser releases the GIL, so the
    # next batch parses while the engine folds the current one
    def timed_next(it):
        parse_m.start()
        batch = next(it, None)
        parse_m.stop(len(batch[1]) if batch is not None else 0)
        return batch

    def batches():
        it = iter(reader)
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(timed_next, it)
            while True:
                with span("sketch.parse_wait") as wait:
                    batch = fut.result()
                    if batch is not None:
                        wait.items = len(batch[1])
                if batch is None:
                    return
                fut = pool.submit(timed_next, it)
                yield batch

    def slot_batches():
        """(slot, n): each batch parsed straight into one of the engine's
        slots, with the same one-batch prefetch."""
        import concurrent.futures as cf

        def fill_next():
            slot = engine.next_slot()
            try:
                parse_m.start()
                n = reader.fill(slot.lo, slot.hi)
                parse_m.stop(n)
            except BaseException:
                engine.submit(slot, 0)
                raise
            return slot, n

        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(fill_next)
            while True:
                with span("sketch.parse_wait") as wait:
                    slot, n = fut.result()
                    wait.items = n
                if n == 0:
                    engine.submit(slot, 0)
                    return
                fut = pool.submit(fill_next)
                yield slot, n

    if takes_slots:
        try:
            for slot, n in slot_batches():
                with span("engine_kmers", n):
                    engine.submit(slot, n)
        except BaseException:
            engine.close()
            raise
    else:
        for packed, rc in batches():
            with span("engine_kmers", len(rc)):
                engine.update(packed, rc)

    # FASTA disables filtering unless explicitly requested (lib.rs:71-76)
    if filter_params.filter_on is None:
        filter_params.filter_on = reader.format == FORMAT_FASTQ

    seq_length, num_valid_kmers, _ = reader.totals
    if sketch_params.sketch_type == "none":
        # AllCounts never updates total_bases (counts.rs:8,25-33) and counts
        # valid kmers via the (saturating) table sum (counts.rs:35-40)
        seq_length = 0
        num_valid_kmers = engine.num_valid_kmers()
    reader.close()

    with span("finalize", 1):
        if hasattr(engine, "finalize_arrays"):
            arrays = engine.finalize_arrays()
            arrays = filter_params.filter_counts_arrays(*arrays)
            arrays = sketch_params.process_post_filter(arrays, name)
            filtered_hashes = kmercounts_from_arrays(sketch_params, *arrays)
        else:
            hashes = engine.finalize()
            filtered_hashes = filter_params.filter_counts(hashes)
            filtered_hashes = sketch_params.process_post_filter(
                filtered_hashes, name)

    return Sketch(
        name=name,
        seq_length=seq_length,
        num_valid_kmers=num_valid_kmers,
        comment="",
        hashes=filtered_hashes,
        filter_params=filter_params,
        sketch_params=sketch_params,
    )


def _sketch_stream_fused(source, name: str, sketch_params: SketchParams,
                         filter_params: FilterParams,
                         parser_threads: Optional[int]) -> Sketch:
    """One native call: parse workers fold record-aligned chunks into
    per-worker tables under a shared admission threshold; exact merge at
    EOF (finch_native.cpp sketch mode)."""
    from finch_tpu_torch.native import FORMAT_FASTQ as FQ, sketch_pipeline

    scheme = 1 if sketch_params.sketch_type == "scaled" else 0
    max_hash = sketch_params.max_hash() if scheme else 0
    with span("fused_parse_fold", 1):
        arrays, totals, fmt = sketch_pipeline(
            source, sketch_params.k, scheme, sketch_params.hash_seed,
            sketch_params.kmers_to_sketch, max_hash or 0,
            threads=parser_threads)
    seq_length, num_valid_kmers, _ = totals
    if filter_params.filter_on is None:
        filter_params.filter_on = fmt == FQ
    with span("finalize", 1):
        arrays = _finalize_arrays(sketch_params, *arrays)
        arrays = filter_params.filter_counts_arrays(*arrays)
        arrays = sketch_params.process_post_filter(arrays, name)
        filtered_hashes = kmercounts_from_arrays(sketch_params, *arrays)
    return Sketch(
        name=name,
        seq_length=seq_length,
        num_valid_kmers=num_valid_kmers,
        comment="",
        hashes=filtered_hashes,
        filter_params=filter_params,
        sketch_params=sketch_params,
    )


def sketch_bytes(data: bytes, name: str, sketch_params: SketchParams,
                 filters: FilterParams, backend: str = "auto",
                 device="cuda") -> Sketch:
    return sketch_stream(data, name, sketch_params, filters, backend=backend,
                         device=device)


def sketch_files(filenames: Sequence[str], sketch_params: SketchParams,
                 filters: FilterParams, backend: str = "auto",
                 batch_size: int = 1 << 21,
                 max_workers: Optional[int] = None,
                 device="cuda") -> List[Sketch]:
    """Sketch many files (lib.rs:29-49). '-' reads stdin.

    Files sketch concurrently in a thread pool (the reference's rayon
    par_iter over filenames); results keep input order."""
    import concurrent.futures as cf
    import os

    def one(filename: str, parser_threads=None) -> Sketch:
        return sketch_stream(filename, filename, sketch_params, filters,
                             backend=backend, batch_size=batch_size,
                             parser_threads=parser_threads, device=device)

    if len(filenames) <= 1:
        return [one(f) for f in filenames]
    workers = max_workers or min(len(filenames), os.cpu_count() or 1)
    if workers <= 1 or "-" in filenames:  # stdin must stay serial
        return [one(f) for f in filenames]
    with cf.ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda f: one(f, parser_threads=1),
                             filenames))
