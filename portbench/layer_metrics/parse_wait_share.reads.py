"""parse_wait_share.reads (%): the union of the port's `sketch.parse_wait`
ranges (the engine's thread waiting for the parser's next batch) over
the traced window, on the device trace's clock (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("sketch.parse_wait",))
