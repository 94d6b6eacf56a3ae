"""Observability: the sketch path's spans, their meters, and the
profiler hook.

The reference has no tracing/metrics subsystem (README.md:112-121 documents
external profiling only); for a production deployment we need k-mers/s
per stage and device-trace capture as first-class features (SURVEY §5).

One primitive serves both: ``span(name, items)`` times a stage into the
``Meter`` of that name (calls, seconds, items) and, while a torch profiler
records on the calling thread, also opens a ``record_function(name)``
range, so that the stage sits in the same trace as the card's kernels and
copies, on its clock. With no profiler a span costs one flag check beyond
the meter's update. The profiler records only on the thread that started
it, so the ranges lie on the thread that called ``sketch_stream``; the
parse thread's ``parse_kmers`` (k-mers parsed) and ``engine.slot_wait``
(slots handed out; the parser's wait for a slot's last copy to the card,
at k <= 31 on TorchEngine and HybridEngine) stay plain meters.

An operator has two uses for them:

* ``FINCH_TPU_METRICS=1`` prints each meter's calls, seconds and items to
  stderr after every sketch;
* ``finch_tpu_torch.utils.trace(dir)`` shows the spans as ranges beside
  the card's kernels:

    with finch_tpu_torch.utils.trace("/tmp/finch-trace") as prof:
        sketch_files(...)

  which writes a Chrome trace (open it in chrome://tracing or Perfetto)
  into the directory; `prof` is the torch.profiler.profile, for reading
  its events in process.

The sketch path's spans (items in brackets): ``sketch.stream`` (k-mers;
one sketch_stream call), ``sketch.open`` (engine and reader
construction), ``sketch.parse_wait`` (k-mers; the engine waiting for the
parser), ``engine_kmers`` (k-mers; one engine update), ``engine.host_fold``
(k-mers; HybridEngine's host fold before migration), ``engine.migrate``
(state entries), ``engine.warm_start`` (HybridEngine's move to a warm
card before its first card batch, around that ``engine.migrate``),
``engine.upload`` (bytes of the padded plane; one plane's copy to the
device: on the slot path, k <= 31, queued asynchronously from the
batch's slot with the padding zeroed on the device; through ``update``,
wide k and callers that hold arrays, padded on the host and copied),
``engine.step`` (lanes; one sketch_step, k <= 31),
``engine.step_wide`` (the batch's k-mers, unpadded; one wide
sketch_step, 32 <= k <= 63),
``engine.sync`` (one host read of a device value), ``finalize`` and
``cli.write_sk`` (bytes; the .sk file's open, write and close); on the
host-bound path, ``fused_parse_fold`` (the fused native parse and fold)
and ``finalize``. The device phases of the wide step and of dist run in ``record_function``
ranges named ``wide.<phase>`` and ``dist.<phase>``. Beside them, a
TorchEngine's ``stats["slot_steps"]`` counts the batches it stepped from
a slot: at k <= 31 one a ``engine.step`` but the redo of a scaled step
that grows, and absent (0) at wide k.

Meters are process-local and cheap (two floats + a counter per stage);
they are best-effort under concurrency — parallel streams sharing a stage
meter overlap their intervals, so treat rates as indicative, not exact.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

from torch.autograd import _profiler_enabled
from torch.profiler import record_function


_clock = time.perf_counter


def metrics_enabled() -> bool:
    return os.environ.get("FINCH_TPU_METRICS", "") not in ("", "0")


@dataclass(slots=True)
class Meter:
    """Items/second meter for one pipeline stage."""

    name: str
    items: int = 0
    seconds: float = 0.0
    calls: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = _clock()

    def stop(self, items: int) -> None:
        self.seconds += _clock() - self._t0
        self.items += items
        self.calls += 1

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


class span:
    """Context manager: one call of the meter `name`, adding `items`
    (which the body may set on the returned object, as ``s.items = n``),
    and a ``record_function(name)`` range while a profiler records on this
    thread. A class with slots, not a generator, so that it costs about a
    microsecond with no profiler."""

    __slots__ = ("meter", "items", "_t0", "_range")

    def __init__(self, name: str, items: int = 0):
        self.meter = _REGISTRY.get(name) or get_meter(name)
        self.items = items
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = record_function(self.meter.name)
            self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        m = self.meter
        m.seconds += _clock() - self._t0
        m.items += self.items
        m.calls += 1
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)


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
