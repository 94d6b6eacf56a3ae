"""syncs_per_step.reads (syncs): the port's `engine.sync` ranges over its
`engine.step` ranges (one sketch step on the card), each counted where it
starts inside the traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import per_call


def read(ctx):
    return per_call(ctx, "engine.sync", "engine.step")
