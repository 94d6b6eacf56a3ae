"""engine_share.reads (%): the seconds the port's ``engine_kmers`` meter
counted (the engine folding a batch: the host fold, then the card's
steps) over the traced window (host clock)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.host_s <= 0 or "engine_kmers.seconds" not in t.counters:
        return None
    if not t.counters.get("engine_kmers.items"):
        return None
    return 100.0 * t.counters["engine_kmers.seconds"] / t.host_s
