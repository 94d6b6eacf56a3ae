"""parse_wait_share.wide (%): ``parse_wait_share.reads`` read in the wide-k
cell (the engine's thread waiting for the serial two-word reader). A name of
its own, as ``portbench/tests/test_portbench_spans.py`` declares the
``.reads`` metric for the k = 21 cell alone."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("parse_wait_share.reads.py"),
                   "layer_metrics").read
