"""parse_share.reads (%): the seconds the port's ``parse_kmers`` meter
counted (the parser handing the engine its next batch; one stream a file
here) over the traced window (host clock)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.host_s <= 0 or "parse_kmers.seconds" not in t.counters:
        return None
    if not t.counters.get("parse_kmers.items"):
        return None
    return 100.0 * t.counters["parse_kmers.seconds"] / t.host_s
