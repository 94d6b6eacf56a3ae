"""idle_share.reads (%): 1 - the union of the card's kernel and copy
intervals over the traced window (device trace)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
