"""The port's spans in a traced window, for the per-layer readers.

The port's stages open ``record_function`` ranges under the profiler
(``finch_tpu_torch/utils/metrics.py``: ``sketch.*``, ``engine*``,
``finalize``, ``cli.write_sk``), on the thread that called
``sketch_stream``. ``Trace`` keeps them in ``ranges`` beside the
benchmark's own ``bench.*`` ranges, on the clock of the card's kernels,
so a span's share of the window and the idle time it covers can be read
there. Every reader returns None where the span never opened (a program
without it) and where nothing ran on the card (no timeline to lay the
spans beside), as ``idle_share.reads`` does.
"""

from __future__ import annotations

ROOT = "sketch.stream"  # the root of one sketch: every span below nests in it


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(iv) -> int:
    return sum(e - s for s, e in iv)


def _overlap(a, b) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _usable(ctx):
    t = ctx.trace
    if t is None or not t.busy or t.w1 <= t.w0:
        return None
    return t


def clipped(t, keep) -> list:
    """Merged intervals of the ranges whose name `keep` accepts, clipped
    to the window [w0, w1]."""
    return _merge((max(s, t.w0), min(e, t.w1)) for s, e, name in t.ranges
                  if keep(name) and e > t.w0 and s < t.w1)


def opened(t, names) -> bool:
    return any(name in names for _, _, name in t.ranges)


def share(ctx, names):
    """% of the traced window inside the union of the ranges `names`."""
    t = _usable(ctx)
    if t is None or not opened(t, names):
        return None
    return 100.0 * _length(clipped(t, lambda n: n in names)) / (t.w1 - t.w0)


def count_in_window(t, name) -> int:
    return sum(1 for s, _, n in t.ranges if n == name and t.w0 <= s < t.w1)


def per_call(ctx, num: str, den: str):
    """Ranges `num` over ranges `den` started in the window."""
    t = _usable(ctx)
    if t is None or not opened(t, (num, den)):
        return None
    d = count_in_window(t, den)
    return count_in_window(t, num) / d if d else None


def unattributed_idle(ctx):
    """% of the window's idle time (the window less the union of the
    card's intervals, as ``idle_share.reads`` has it) under no port range
    but the root ``sketch.stream``: the idle that only the root or the
    benchmark's ``bench.*`` ranges cover."""
    t = _usable(ctx)
    if t is None or not opened(t, (ROOT,)):
        return None
    idle = (t.w1 - t.w0) - _length(t.busy)
    if idle <= 0:
        return None
    named = clipped(t, lambda n: n != ROOT and not n.startswith("bench."))
    named_idle = _length(named) - _overlap(named, t.busy)
    return 100.0 * (idle - named_idle) / idle
