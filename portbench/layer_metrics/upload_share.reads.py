"""upload_share.reads (%): the union of the port's `engine.upload` ranges
(a batch plane padded on the host and copied to the card from pageable
memory) over the traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("engine.upload",))
