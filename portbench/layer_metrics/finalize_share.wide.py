"""finalize_share.wide (%): ``finalize_share.reads`` read in the wide-k cell
(the filters on two-word payloads and the .sk writer). A name of its own, as
``portbench/tests/test_portbench_spans.py`` declares the ``.reads`` metric
for the k = 21 cell alone."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("finalize_share.reads.py"),
                   "layer_metrics").read
