"""Observability: per-stage throughput meters.

The reference has no tracing/metrics subsystem (README.md:112-121 documents
external profiling only); for a production deployment we need k-mers/s
per stage as a first-class feature (SURVEY §5).

Meters are process-local and cheap (two floats + a counter per stage);
they are best-effort under concurrency — parallel streams sharing a stage
meter overlap their intervals, so treat rates as indicative, not exact.
Enable wall-clock reporting with FINCH_TPU_METRICS=1. The JAX package's
device-trace hook (``finch_tpu.utils.trace``) has no counterpart here yet.
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

