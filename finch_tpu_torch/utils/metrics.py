"""Observability: per-stage throughput meters and the profiler hook.

The reference has no tracing/metrics subsystem (README.md:112-121 documents
external profiling only); for a production deployment we need k-mers/s
per stage and device-trace capture as first-class features (SURVEY §5).

Meters are process-local and cheap (two floats + a counter per stage);
they are best-effort under concurrency — parallel streams sharing a stage
meter overlap their intervals, so treat rates as indicative, not exact.
Enable wall-clock reporting with FINCH_TPU_METRICS=1; capture a
torch.profiler trace of a region with:

    with finch_tpu_torch.utils.trace("/tmp/finch-trace") as prof:
        sketch_files(...)

which writes a Chrome trace (open it in chrome://tracing or Perfetto)
into the directory; `prof` is the torch.profiler.profile, for reading its
events in process. The device phases run in ``record_function`` ranges
named ``dist.<phase>`` and ``wide.<phase>``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


def metrics_enabled() -> bool:
    return os.environ.get("FINCH_TPU_METRICS", "") not in ("", "0")


@dataclass
class Meter:
    """Items/second meter for one pipeline stage."""

    name: str
    items: int = 0
    seconds: float = 0.0
    calls: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> None:
        self.seconds += time.perf_counter() - self._t0
        self.items += items
        self.calls += 1

    @contextlib.contextmanager
    def timed(self, items: int = 0) -> Iterator["Meter"]:
        self.start()
        try:
            yield self
        finally:
            self.stop(items)

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def line(self) -> str:
        return (f"{self.name}: {self.items} items in {self.seconds:.3f}s "
                f"({self.rate():,.0f}/s over {self.calls} calls)")


_REGISTRY: Dict[str, Meter] = {}


def get_meter(name: str) -> Meter:
    if name not in _REGISTRY:
        _REGISTRY[name] = Meter(name)
    return _REGISTRY[name]


def report(file=None) -> None:
    """Print all meters (stderr by default); no-op if nothing recorded."""
    out = file or sys.stderr
    for meter in _REGISTRY.values():
        if meter.calls:
            print(f"[finch_tpu_torch] {meter.line()}", file=out)



@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the enclosed region with torch.profiler: host operators,
    and the card's kernels when a card is present. On exit it writes
    ``finch_trace_<pid>_<ns>.json`` (Chrome trace format) into log_dir.

    Unlike the JAX package's hook, a profiler that fails raises: it never
    turns into a silent no-op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"finch_trace_{os.getpid()}_{time.time_ns()}.json"))
