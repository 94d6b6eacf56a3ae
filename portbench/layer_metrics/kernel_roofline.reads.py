"""kernel_roofline.reads (%): the card's sketch steps against the bytes
their lanes need, over the traced window.

Need, counted from the lanes handed to each call (``LaneProbe`` in
``entries/finch_sketch.py``), each input read once and each output
written once, as the steps' contract states them (``ops/extract.py``,
``ops/dedup.py``); b lanes a call:

* extract, either form: reads the two u32 planes (8 B a lane) and the
  threshold; writes the hash planes (8 B a lane), the slab (b/4 entries
  of 8 B), 32 x 2048 candidates of 8 B and two flags;
* tier D: reads four u32 planes (16 B a lane) and the threshold; writes
  96 x 2048 candidates of 8 B and a flag;
* tier D2: reads the slab (b/4 entries of 8 B); writes 96 x 2048
  candidates of 8 B and a flag.

The least time is that need at the card's HBM bandwidth
(``peaks.H100_HBM_BYTES_PER_S``); the share is it over the summed device
time of the kernels that run those steps, from the trace. None when no
such kernel ran (the steps were taken off the path or renamed). Where
those kernels ran but ``LaneProbe`` counted no lanes, the port no longer
calls its steps through the attributes the probe wraps: the reader
raises, and the run fails instead of losing the metric unseen.
"""

from portbench.peaks import H100_HBM_BYTES_PER_S

KERNELS = ("extract_select", "extract_warp_merge", "extract_weighted_merge",
           "dedup_lanes_warp", "dedup_slab_warp")
CAND = 32 * 2048 * 8
DUP_CAND = 96 * 2048 * 8


def need_bytes(lanes: dict, calls: dict) -> float:
    ext = lanes.get("extract", 0) + lanes.get("extract_weighted", 0)
    n_ext = calls.get("extract", 0) + calls.get("extract_weighted", 0)
    total = 18 * ext + n_ext * (8 + CAND + 8)
    total += 16 * lanes.get("dedup", 0) + calls.get("dedup", 0) * (
        8 + DUP_CAND + 4)
    total += 2 * lanes.get("dedup_slab", 0) + calls.get("dedup_slab", 0) * (
        DUP_CAND + 4)
    return float(total)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    c = t.counters
    lanes = {k[6:]: v for k, v in c.items() if k.startswith("lanes.")}
    calls = {k[6:]: v for k, v in c.items() if k.startswith("calls.")}
    dev_s = sum(t.kernel_s(KERNELS).values())
    need = need_bytes(lanes, calls)
    if dev_s > 0 and need <= 0:
        raise RuntimeError(
            f"kernel_roofline.reads: {dev_s!r} s of {', '.join(KERNELS)} "
            "ran on the card, but LaneProbe counted no lanes: the port "
            "calls its steps past the attributes it wraps (LaneProbe.SITES "
            "in portbench/entries/finch_sketch.py)")
    if dev_s <= 0 or need <= 0:
        return None
    return 100.0 * need / H100_HBM_BYTES_PER_S / dev_s
