"""sync_wait_share.reads (%): the union of the port's `engine.sync` ranges
(a sketch step's host reads of device values, each waiting for the card)
over the traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("engine.sync",))
