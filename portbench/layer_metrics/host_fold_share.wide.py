"""host_fold_share.wide (%): ``host_fold_share.reads`` read in the wide-k
cell (the warm operation's wide host fold and migration, and each timed
sketch's empty migrate at its warm start). A name of its own, as
``portbench/tests/test_portbench_spans.py`` declares the ``.reads`` metric
for the k = 21 cell alone."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("host_fold_share.reads.py"),
                   "layer_metrics").read
