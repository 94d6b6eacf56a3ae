"""Reduce a torch.profiler trace of the traced window to what the
per-layer readers and the result's ``breakdown`` need.

Read from the profiler's raw events (``kineto_results.events()``), which
is far cheaper than its FunctionEvent tree on a window of 10^5 launches:

* device intervals: every kernel, copy and set on the card (user
  annotations left out), clipped to the ``bench.window`` range;
* ranges: every user annotation on the host (``record_function``: the
  benchmark's ``bench.*`` spans, the port's ``dist.*`` and ``wide.*``),
  which label the window's idle gaps.
"""

from __future__ import annotations

import bisect


def _merge(iv):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    GAP_MIN_NS = 20_000      # idle gaps labelled one by one from this long
    GAP_LABELLED = 2000      # at most this many, the longest

    def __init__(self, prof, window: str = "bench.window"):
        from torch.autograd import DeviceType

        self.device = []       # (start_ns, end_ns, name)
        self.ranges = []       # (start_ns, end_ns, name)
        self.host_ops = []     # (start_ns, end_ns, name) of host ops
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                if e.linked_correlation_id():
                    continue   # a runtime call (cudaLaunchKernel, ...)
                if e.is_user_annotation():
                    self.ranges.append((s, end, e.name()))
                else:
                    self.host_ops.append((s, end, e.name()))
            elif not e.is_user_annotation():
                self.device.append((s, end, e.name()))
        wins = [r for r in self.ranges if r[2] == window]
        if wins:
            self.w0, self.w1 = wins[0][0], wins[-1][1]
        else:
            pts = [x for ev in (self.device + self.host_ops)
                   for x in ev[:2]]
            self.w0, self.w1 = (min(pts), max(pts)) if pts else (0, 0)
        self.window_s = (self.w1 - self.w0) / 1e9
        self.busy = _merge([(max(s, self.w0), min(e, self.w1))
                            for s, e, _ in self.device
                            if e > self.w0 and s < self.w1])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.ranges.sort()
        self.host_ops.sort()

    # ------------------------------------------------------------------
    def _clip(self, s, e) -> int:
        return max(0, min(e, self.w1) - max(s, self.w0))

    def idle_share(self):
        """1 - busy / window, in %; None when nothing ran on the card."""
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self, names) -> dict:
        """Device seconds of each kernel whose name holds one of `names`."""
        out = {}
        for s, e, name in self.device:
            for n in names:
                if n in name:
                    out[n] = out.get(n, 0.0) + self._clip(s, e) / 1e9
        return out

    # ------------------------------------------------------------------
    def _innermost(self, events, starts, t, limit=64):
        """The latest-starting event of `events` (sorted by start) that
        covers t, looking back at most `limit` events."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - limit), -1):
            if events[j][1] >= t:
                return events[j][2]
        return None

    def idle_gaps(self) -> list:
        """[[label, seconds]]: the window's idle time, by what the host was
        doing in it (the innermost range and host op at each gap's middle),
        the largest ten labels."""
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        rstarts = [r[0] for r in self.ranges]
        hstarts = [h[0] for h in self.host_ops]
        totals = {}
        short = 0
        for n, (length, start) in enumerate(gaps):
            if n >= self.GAP_LABELLED or length < self.GAP_MIN_NS:
                short += length
                continue
            mid = start + length // 2
            rng = self._innermost(self.ranges, rstarts, mid)
            if rng is None:
                rng = next((r[2] for r in self.ranges
                            if r[0] <= mid <= r[1]
                            and r[2].startswith("bench.")
                            and r[2] != "bench.window"), None)
            op = self._innermost(self.host_ops, hstarts, mid)
            label = " / ".join(x for x in (rng, op) if x) or "host"
            totals[label] = totals.get(label, 0) + length
        if short:
            totals["(gaps under 20 us or past the 2000 longest)"] = short
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        return [[k, v / 1e9] for k, v in top]

    def device_ops(self) -> list:
        """[[name, seconds]]: the ten device operations that took most
        time in the window."""
        tot = {}
        for s, e, name in self.device:
            d = self._clip(s, e)
            if d:
                tot[name] = tot.get(name, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        return [[k[:200], v / 1e9] for k, v in top]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_gaps()}
