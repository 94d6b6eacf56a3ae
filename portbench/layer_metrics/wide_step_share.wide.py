"""wide_step_share.wide (%): the union of the port's `engine.step_wide`
ranges (the host issuing one wide sketch step, ``ops/bottomk_wide.py``)
over the traced window (`portbench/port_spans.py`)."""

from portbench.port_spans import share


def read(ctx):
    return share(ctx, ("engine.step_wide",))
