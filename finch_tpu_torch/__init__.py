"""finch_tpu_torch — the PyTorch/CUDA port of finch_tpu for NVIDIA GPUs.

A second package beside ``finch_tpu`` (the JAX/TPU reference, which it
neither imports nor changes): the same MinHash sketching of FASTA/FASTQ
records, with the device path in PyTorch and each TPU kernel replaced by
one written by hand for Hopper (``csrc/``). It keeps its own copies of the
host layers (C++ parser, serialization, filtering, parameters).

The device entry points run on "cuda" unless the caller passes
``device="cpu"``; without a card they raise.

Numeric contract: hash-for-hash identical sketches and JSON-equal `dist`
output to finch_tpu and the reference CLI.
"""

from finch_tpu_torch.models.params import SketchParams, FilterParams  # noqa: E402
from finch_tpu_torch.core.sketch import Sketch, KmerCount  # noqa: E402
from finch_tpu_torch.core.sketching import (sketch_files, sketch_stream,  # noqa: E402
                                            sketch_bytes)
from finch_tpu_torch.models.engine import make_engine  # noqa: E402
from finch_tpu_torch.serialization import open_sketch_file  # noqa: E402
from finch_tpu_torch.core.distance import distance  # noqa: E402
from finch_tpu_torch.errors import FinchError  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "SketchParams", "FilterParams", "Sketch", "KmerCount",
    "sketch_files", "sketch_stream", "sketch_bytes", "make_engine",
    "open_sketch_file", "distance", "FinchError",
]
