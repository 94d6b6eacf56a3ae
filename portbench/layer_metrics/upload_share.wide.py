"""upload_share.wide (%): ``upload_share.reads`` read in the wide-k cell (a
wide step's three planes, ``plo`` and ``phi`` as u64 and ``rc`` as u8, 17 B
a lane). A name of its own, as ``portbench/tests/test_portbench_spans.py``
declares the ``.reads`` metric for the k = 21 cell alone."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("upload_share.reads.py"),
                   "layer_metrics").read
