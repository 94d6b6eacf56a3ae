"""wide_roofline.wide (%): the port's wide sketch steps (32 <= k <= 63)
against the bytes their work needs, over the traced window.

Need, counted from the work whatever implements the step, from the port's
``engine.step_wide`` meter (``entries/finch_sketch_wide.py`` snapshots
its calls, and its items, the batches' valid k-mers, as lanes):

* each lane read once: the two u64 code words and the u8 strand flag,
  17 B;
* each call reads and writes the five-word u64 state of capacity
  C = n_hashes x oversketch: 2 x 5 x 8 x C B.

The least time is that need at the card's HBM bandwidth
(``peaks.H100_HBM_BYTES_PER_S``); the share is it over the summed device
time of the window's kernels, copies (``Memcpy``) and sets (``Memset``)
left out. None where the span never opened (a program without it) or no
kernel ran. Where kernels ran under the span and the meter counted no
lanes, the entry no longer reads the meter the port fills: the reader
raises, and the run fails instead of losing the metric unseen.
"""

from portbench.peaks import H100_HBM_BYTES_PER_S
from portbench.port_spans import opened

SPAN = "engine.step_wide"
LANE_BYTES = 8 + 8 + 1
STATE_WORDS = 5


def need_bytes(lanes: int, calls: int, capacity: int) -> float:
    return float(LANE_BYTES * lanes + calls * 2 * STATE_WORDS * 8 * capacity)


def kernel_s(t) -> float:
    """Device seconds of the window's kernels, copies and sets left out."""
    return sum(max(0, min(e, t.w1) - max(s, t.w0))
               for s, e, name in t.device
               if not name.startswith(("Memcpy", "Memset"))) / 1e9


def read(ctx):
    t = ctx.trace
    if t is None or not opened(t, (SPAN,)):
        return None
    dev_s = kernel_s(t)
    if dev_s <= 0:
        return None
    c = ctx.config
    lanes = t.counters.get("step_wide.lanes", 0)
    calls = t.counters.get("step_wide.calls", 0)
    if lanes <= 0 or calls <= 0:
        raise RuntimeError(
            f"wide_roofline.wide: {dev_s!r} s of kernels ran and "
            f"{SPAN} opened, but the meter counted {lanes} lanes in "
            f"{calls} calls: the entry does not read the meter the port "
            "fills (portbench/entries/finch_sketch_wide.py)")
    need = need_bytes(lanes, calls, c["n_hashes"] * c["oversketch"])
    return 100.0 * need / H100_HBM_BYTES_PER_S / dev_s
