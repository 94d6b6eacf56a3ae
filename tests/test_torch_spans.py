"""The sketch path's spans (``finch_tpu_torch.utils.metrics.span``) on the
CPU: each times its stage into the meter of its name and, while a
profiler records on the calling thread, opens a range of that name; the
spans sit where the layers meet, count what the engines count, open no
range on the parse thread, and leave the sketch unchanged."""

import os
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import finch_tpu_torch as ft
from finch_tpu_torch import cli
from finch_tpu_torch.core import sketching
from finch_tpu_torch.models import engine as eng
from finch_tpu_torch.utils import get_meter, metrics, span

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
READS_FQ = os.path.join(HERE, "data", "reads.fastq")
BATCH = 1 << 14  # several batches of reads.fastq's ~200k k-mers

SKETCH_SPANS = ("sketch.stream", "sketch.open", "sketch.parse_wait",
                "engine_kmers", "engine.upload", "engine.step",
                "engine.sync", "finalize")


def _counts(names) -> dict:
    return {n: (get_meter(n).calls, get_meter(n).items) for n in names}


def _ranges(prof) -> list:
    """(name, thread) of every user range the profiler recorded."""
    return [(e.name(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.is_user_annotation()]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _params(scheme="mash", k=21):
    if scheme == "mash":
        return ft.SketchParams.mash(kmers_to_sketch=2000, final_size=100,
                                    kmer_length=k)
    return ft.SketchParams.scaled(kmers_to_sketch=100, kmer_length=k,
                                  scale=0.05)


def _filters():
    return ft.FilterParams(filter_on=None, err_filter=0.21,
                           strand_filter=0.1)


def _sketch(params, engine_out=None, **kw):
    return sketching.sketch_stream(READS_FQ, "reads", params, _filters(),
                                   backend="torch", batch_size=BATCH,
                                   device="cpu", engine_out=engine_out, **kw)


def test_span_without_profiler_meters_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "record_function",
                        lambda name: opened.append(name))
    before = _counts(["test.span_off"])["test.span_off"]
    with span("test.span_off", 5) as s:
        s.items += 2
    with span("test.span_off"):
        pass
    m = get_meter("test.span_off")
    assert (m.calls, m.items) == (before[0] + 2, before[1] + 7)
    assert m.seconds >= 0.0
    assert opened == []


def test_span_under_profiler_opens_a_range_of_its_name():
    with _cpu_profile() as prof:
        with span("test.span_on", 3):
            torch.ones(4).sum()
    names = [n for n, _ in _ranges(prof)]
    assert names.count("test.span_on") == 1
    assert get_meter("test.span_on").items >= 3


def test_span_meters_a_raising_body_and_closes_its_range():
    before = get_meter("test.span_raise").calls
    with _cpu_profile() as prof:
        with pytest.raises(ValueError):
            with span("test.span_raise"):
                raise ValueError("boom")
        with span("test.after_raise"):
            pass
    assert get_meter("test.span_raise").calls == before + 1
    names = [n for n, _ in _ranges(prof)]
    assert "test.span_raise" in names and "test.after_raise" in names


def test_sketch_stream_spans_and_meters():
    before = _counts(SKETCH_SPANS)
    with _cpu_profile() as prof:
        sk = _sketch(_params())
    names = {n for n, _ in _ranges(prof)}
    assert set(SKETCH_SPANS) <= names
    # the parse thread only meters
    assert "parse_kmers" not in names
    after = _counts(SKETCH_SPANS)
    calls = {n: after[n][0] - before[n][0] for n in SKETCH_SPANS}
    items = {n: after[n][1] - before[n][1] for n in SKETCH_SPANS}
    assert calls["sketch.stream"] == calls["sketch.open"] == 1
    assert calls["finalize"] == 1
    n_batches = calls["engine_kmers"]
    assert n_batches >= 3
    # one wait a batch, and one for the parser's end of stream
    assert calls["sketch.parse_wait"] == n_batches + 1
    assert calls["engine.step"] == n_batches
    assert calls["engine.upload"] == 2 * n_batches  # the two planes
    assert items["sketch.stream"] == sk.num_valid_kmers
    assert items["engine_kmers"] == items["sketch.parse_wait"] \
        == sk.num_valid_kmers
    # each step's lanes are its batch padded to a power of two, uploaded
    # as two int32 planes
    assert sk.num_valid_kmers <= items["engine.step"] <= n_batches * BATCH
    assert items["engine.upload"] == 2 * 4 * items["engine.step"]


@pytest.mark.parametrize("scheme,k", [("mash", 21), ("scaled", 21),
                                      ("scaled", 51)])
def test_sync_span_counts_the_engine_syncs(scheme, k):
    engines = []
    before = get_meter("engine.sync").calls
    _sketch(_params(scheme, k), engine_out=engines)
    syncs = engines[0].stats["syncs"]
    assert syncs > 0
    assert get_meter("engine.sync").calls - before == syncs


@pytest.mark.parametrize("k", [21, 51])
def test_wide_step_span_only_at_wide_k(k):
    """A wide sketch opens ``engine.step_wide`` once a wide step, its lanes
    the k-mers TorchEngine folded; a k = 21 sketch never opens it, and
    its ``engine.step`` count is one a batch."""
    names = ("engine.step_wide", "engine.step", "engine_kmers")
    before = _counts(names)
    engines = []
    with _cpu_profile() as prof:
        sk = _sketch(_params(k=k), engine_out=engines)
    after = _counts(names)
    calls = {n: after[n][0] - before[n][0] for n in names}
    items = {n: after[n][1] - before[n][1] for n in names}
    ranges = [n for n, _ in _ranges(prof)]
    if k == 51:
        assert calls["engine.step_wide"] == engines[0].stats["wide"] \
            == ranges.count("engine.step_wide") >= 3
        assert items["engine.step_wide"] == sk.num_valid_kmers \
            == items["engine_kmers"]
        assert calls["engine.step"] == 0
        # the wide phases nest inside the span
        assert "wide.hash" in ranges
    else:
        assert calls["engine.step_wide"] == 0
        assert "engine.step_wide" not in ranges
        assert calls["engine.step"] == calls["engine_kmers"] >= 3


def test_hybrid_engine_folds_on_host_then_migrates_once(monkeypatch):
    params = _params()

    def hybrid(sketch_params, backend, batch_size, device):
        return eng.HybridEngine(sketch_params, batch_size=batch_size,
                                switch_after=2 * BATCH, device=device)

    monkeypatch.setattr(sketching, "_make_engine", hybrid)
    names = ("engine.host_fold", "engine.migrate", "engine.step")
    before = _counts(names)
    engines = []
    with _cpu_profile() as prof:
        sk = _sketch(params, engine_out=engines)
    after = _counts(names)
    ranges = [n for n, _ in _ranges(prof)]
    assert ranges.count("engine.migrate") == 1
    assert after["engine.migrate"][0] - before["engine.migrate"][0] == 1
    folds = after["engine.host_fold"][0] - before["engine.host_fold"][0]
    assert folds == ranges.count("engine.host_fold") >= 1
    # the host folds until its k-mers reach the switch point, then migrates
    folded = after["engine.host_fold"][1] - before["engine.host_fold"][1]
    assert folded == engines[0]._seen >= 2 * BATCH
    migrated = after["engine.migrate"][1] - before["engine.migrate"][1]
    assert 0 < migrated <= params.kmers_to_sketch
    assert after["engine.step"][0] > before["engine.step"][0]
    assert engines[0]._dev is not None
    monkeypatch.undo()
    assert sk.hashes == _sketch(params).hashes


def test_no_range_opens_on_the_parse_thread(monkeypatch):
    """With every thread taken as recording, a range would open wherever a
    span runs: only on the thread that called sketch_stream."""
    seen, opened = [], []
    orig_stop = metrics.Meter.stop

    def stop(meter, items):
        if meter.name == "parse_kmers":
            seen.append(threading.get_ident())
        orig_stop(meter, items)

    class Range:
        def __init__(self, name):
            opened.append((name, threading.get_ident()))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(metrics.Meter, "stop", stop)
    monkeypatch.setattr(metrics, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(metrics, "record_function", Range)
    _sketch(_params())
    main = threading.get_ident()
    # the parser ran on another thread than this one
    assert seen and main not in set(seen)
    assert set(SKETCH_SPANS) <= {n for n, _ in opened}
    assert {t for _, t in opened} == {main}


def test_sk_bytes_equal_with_tracing_on_and_off(tmp_path):
    argv = ["sketch", READS_FQ, "--backend", "torch", "--device", "cpu",
            "-n", "100"]
    off, on = tmp_path / "off.sk", tmp_path / "on.sk"
    cli.run(argv + ["-o", str(off)])
    before = _counts(["cli.write_sk"])["cli.write_sk"]
    with _cpu_profile() as prof:
        cli.run(argv + ["-o", str(on)])
    assert on.read_bytes() == off.read_bytes()
    calls, items = _counts(["cli.write_sk"])["cli.write_sk"]
    assert (calls - before[0], items - before[1]) == (1, on.stat().st_size)
    names = {n for n, _ in _ranges(prof)}
    assert {"sketch.stream", "cli.write_sk"} <= names
