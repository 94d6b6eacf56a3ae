"""The benchmark's runner: one cell, one seed, one window.

Everything a cell needs is found by name, so that a configuration, a
traffic mix or a metric is added with new files and new entries of
``BENCHMARK.json``, and no edit:

* ``BENCHMARK.json`` names the cell (``workloads``), its configuration
  (``configs[].file``) and the metrics (``end_to_end``, ``per_layer``);
* ``portbench/traffic/<config>.<traffic>.json``: the mix's parameters and
  the name of its generator, ``portbench/gen/<generator>.py``
  (``generate(config, traffic, seed, workdir) -> data``);
* the configuration's ``entry`` names ``portbench/entries/<entry>.py``,
  whose ``Cell`` drives the port (``setup``, ``op``, ``snapshot``,
  ``release``, ``judge``);
* ``portbench/e2e/<metric>.py`` and ``portbench/layer_metrics/<metric>.py``
  each hold ``read(ctx)``, which returns the metric's value or None when
  it finds nothing to read (the metric is then left out of the line).

A run: the data from the seed (timed apart, ``gen_s``), the entry's
set-up with one warm operation (``setup_s`` runs from the process start
to the window's start), whole operations back to back until ``seconds``
have passed, with ``trace`` the first ``trace_ops`` of them under
torch.profiler, then the program's state freed and every operation's
output judged against the plain reference (``portbench/reference/``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

# top-level module names that no run may load: the JAX package is the
# port's reference in the CPU tests and never runs beside the benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "finch_tpu")


class NoCard(Exception):
    """Fewer cards than the cell asks for."""


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (default: sys.modules),
    compared whole: ``finch_tpu_torch`` is not ``finch_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_module(path: Path, kind: str):
    """Import the file `path` as a module of its own (names may hold dots,
    as metric names do)."""
    tag = "".join(ch if ch.isalnum() else "_" for ch in path.stem)
    name = f"portbench_{kind}_{tag}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> SimpleNamespace:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = json.loads((self.dir / "traffic" /
                              f"{w['config']}.{w['traffic']}.json")
                             .read_text())
        return SimpleNamespace(name=name, chips=int(w.get("chips", 1)),
                               config=config, traffic=traffic)

    def load(self, kind: str, name: str):
        return load_module(self.dir / kind / f"{name}.py", kind)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


class Spans:
    """The benchmark's own host-clock spans around the calls into the
    port, each also a ``bench.<name>`` range in a trace."""

    def __init__(self):
        self.data: dict = {}

    @contextlib.contextmanager
    def range(self, name: str):
        from torch.profiler import record_function

        t = time.perf_counter()
        try:
            with record_function("bench." + name):
                yield
        finally:
            self.data.setdefault(name, []).append(time.perf_counter() - t)

    def mark(self) -> dict:
        return {k: len(v) for k, v in self.data.items()}

    def since(self, mark: dict) -> dict:
        return {k: v[mark.get(k, 0):] for k, v in self.data.items()}


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             *, t0: float | None = None, device: str = "cuda",
             require_card: bool = True, log=None) -> dict:
    """Run one cell once; returns the result object (the last line)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = Bench(root)
    cell = bench.cell(workload)
    import torch

    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise NoCard(f"{workload} needs {cell.chips} CUDA card(s); "
                     f"found {torch.cuda.device_count()}")
    entry = bench.load("entries", cell.config["entry"])  # imports the port
    gen = bench.load("gen", cell.traffic["generator"])
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        tg = time.perf_counter()
        data = gen.generate(cell.config, cell.traffic, seed, workdir)
        gen_s = time.perf_counter() - tg
        log(f"gen_s {gen_s!r} (data from the seed, inside setup_s)")
        spans = Spans()
        runner = entry.Cell(cell.config, cell.traffic, data, device=device,
                            workdir=workdir, spans=spans, trace=trace)
        try:
            runner.setup()
        except Exception:
            # the warm operation failed: no window; judged as not correct
            log(traceback.format_exc().rstrip())
            return _failed_setup(cell, device, log)
        _sync(device)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        log(f"setup_s {setup_s!r}")
        return _window(bench, cell, runner, spans, data, seconds, trace,
                       device, setup_s, gen_s, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _window(bench, cell, runner, spans, data, seconds, trace, device,
            setup_s, gen_s, log) -> dict:
    import torch

    n_trace = int(cell.traffic.get("trace_ops", 1)) if trace else 0
    prof = rf = None
    traced = None
    work: dict = {}
    raised = []
    attempted = 0
    op_s = []
    spans.data.clear()
    if n_trace:
        # the profiler starts (and later stops) outside the window's clock
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)

        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        rf = record_function("bench.window")
        rf.__enter__()
        traced = SimpleNamespace(counters=runner.snapshot(),
                                 spans=spans.mark(), t=time.perf_counter())
    w0 = time.perf_counter()
    w1 = w0
    while True:
        attempted += 1
        t_op = time.perf_counter()
        try:
            with spans.range(runner.span):
                got = runner.op(attempted - 1)
            for k, v in got.items():
                work[k] = work.get(k, 0) + v
        except Exception:
            raised.append(traceback.format_exc())
        w1 = time.perf_counter()
        op_s.append(w1 - t_op)
        done = bool(raised) or w1 - w0 >= seconds
        if prof is not None and (attempted == n_trace or done):
            rf.__exit__(None, None, None)
            traced.host_s = w1 - traced.t
            prof.stop()
            traced.counters = _diff(runner.snapshot(), traced.counters)
            traced.spans = spans.since(traced.spans)
            traced.ops = attempted
            traced.prof, prof = prof, None
            if not done:
                w0 += time.perf_counter() - w1  # the profiler's stop
        if done:
            break
    window_s = w1 - w0
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    for tb in raised:
        log(tb.rstrip())
    log("op_s " + " ".join(f"{x:.4f}" for x in op_s))

    ctx = SimpleNamespace(cell=cell.name, config=cell.config,
                          traffic=cell.traffic, data=data, seconds=seconds,
                          setup_s=setup_s, gen_s=gen_s, window_s=window_s,
                          ops=attempted, work=work, spans=dict(spans.data),
                          trace=None)
    breakdown = None
    if traced is not None:
        from portbench import trace as trace_mod

        t_red = time.perf_counter()
        ctx.trace = trace_mod.Trace(traced.prof)
        ctx.trace.ops = traced.ops
        ctx.trace.counters = traced.counters
        ctx.trace.spans = traced.spans
        ctx.trace.host_s = traced.host_s
        del traced.prof
        breakdown = ctx.trace.breakdown()
        log(f"trace_reduce_s {time.perf_counter() - t_red!r} "
            f"(traced ops {traced.ops}, host {traced.host_s!r} s)")

    metrics = {}
    wanted = bench.per_layer(cell.name) if trace else \
        bench.end_to_end(cell.name)
    for m in wanted:
        kind = "layer_metrics" if trace else "e2e"
        value = bench.load(kind, m["name"]).read(ctx)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    runner.release()
    t_judge = time.perf_counter()
    checks, bad_ops = runner.judge()
    log(f"judge_s {time.perf_counter() - t_judge!r} (the reference and the "
        f"comparison, after the window; ops {attempted}, window_s "
        f"{window_s!r})")
    checks = [("ops_raised", len(raised), 0)] + list(checks)
    failed = len(raised) + bad_ops
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    found = forbidden_modules()
    if found:
        raise RuntimeError("forbidden modules loaded: " + ", ".join(found))

    dev = _device(cell, device, peak)
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v!r} limit {lim!r}")
    return result


def _device(cell, device: str, peak: int) -> dict:
    import torch

    cuda = device.startswith("cuda")
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}


def _failed_setup(cell, device, log) -> dict:
    """The line of a run whose warm operation raised: not correct."""
    import torch

    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") \
        else 0
    log("check ops_raised 1 limit 0")
    return {"correct": False, "attempted": 1, "failed": 1, "metrics": {},
            "device": _device(cell, device, peak),
            "checks": {"ops_raised": {"value": 1, "limit": 0}}}


def main(root, workload: str, seed: int, seconds: float, trace: bool,
         t0: float | None = None) -> int:
    try:
        result = run_cell(root, workload, seed, seconds, trace, t0=t0)
    except NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0
