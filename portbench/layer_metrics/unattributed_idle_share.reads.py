"""unattributed_idle_share.reads (%): the share of the card's idle time in
the traced window during which no port range but the root `sketch.stream`
was open, so only the root or the benchmark's `bench.*` ranges cover it
(`portbench/port_spans.py`)."""

from portbench.port_spans import unattributed_idle


def read(ctx):
    return unattributed_idle(ctx)
