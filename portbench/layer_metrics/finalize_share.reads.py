"""finalize_share.reads (%): the union of the port's `finalize` (the
filters and post-filter rule over the engine's final state) and
`cli.write_sk` (the .sk file's open, write and close) ranges over the
traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("finalize", "cli.write_sk"))
