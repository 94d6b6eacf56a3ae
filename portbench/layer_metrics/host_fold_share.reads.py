"""host_fold_share.reads (%): the union of the port's `engine.host_fold`
(auto's host fold before migration, with the decode of the composite
planes) and `engine.migrate` (the host state moved to the card) ranges
over the traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("engine.host_fold", "engine.migrate"))
