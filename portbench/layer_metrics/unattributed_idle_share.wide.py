"""unattributed_idle_share.wide (%): ``unattributed_idle_share.reads`` read
in the wide-k cell (the card's idle time under the root span alone). A name
of its own, as ``portbench/tests/test_portbench_spans.py`` declares the
``.reads`` metric for the k = 21 cell alone."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(
    Path(__file__).with_name("unattributed_idle_share.reads.py"),
    "layer_metrics").read
