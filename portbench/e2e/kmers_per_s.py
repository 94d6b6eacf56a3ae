"""kmers_per_s: k-mers of the input folded, filtered and written to .sk,
over the window (its start to the end of its last operation)."""


def read(ctx):
    if "kmers" not in ctx.work or ctx.window_s <= 0:
        return None
    return ctx.work["kmers"] / ctx.window_s
