"""The readers of the port's spans (``portbench/port_spans.py`` and the
seven ``layer_metrics`` files that use it) on synthetic traces: ranges
clipped to the window, nested and overlapping ranges counted once, the
idle time that only the root span covers, and None where a span never
opened or nothing ran on the card."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
READERS = ("parse_wait_share.reads", "finalize_share.reads",
           "host_fold_share.reads", "upload_share.reads",
           "sync_wait_share.reads", "syncs_per_step.reads",
           "unattributed_idle_share.reads")


def _read(name, trace):
    mod = harness.Bench(ROOT).load("layer_metrics", name)
    return mod.read(SimpleNamespace(trace=trace))


def _trace(ranges, busy, w0=100, w1=1100):
    """A window of 1000 ns; `busy` the card's merged intervals."""
    ranges = [(100, 1100, "bench.window"), (100, 1100, "bench.sketch"),
              *ranges]
    return SimpleNamespace(ranges=sorted(ranges), busy=[list(b) for b in busy],
                           w0=w0, w1=w1)


# one sketch: a root, an open, two batches of a wait, an engine update
# (a step with two syncs and an upload inside it), then finalize and write
SKETCH = [
    (150, 1050, "sketch.stream"),
    (150, 200, "sketch.open"),
    (200, 250, "sketch.parse_wait"),
    (250, 450, "engine_kmers"),
    (260, 300, "engine.upload"),
    (300, 440, "engine.step"),
    (320, 360, "engine.sync"),
    (380, 430, "engine.sync"),
    (450, 480, "sketch.parse_wait"),
    (480, 700, "engine_kmers"),
    (490, 690, "engine.host_fold"),
    (600, 700, "engine.migrate"),   # overlaps the host fold
    (700, 800, "finalize"),
    (800, 900, "cli.write_sk"),
]
BUSY = [(300, 320), (360, 380), (430, 440)]


@pytest.mark.parametrize("name,want", [
    ("parse_wait_share.reads", 8.0),     # 50 + 30 of 1000
    ("finalize_share.reads", 20.0),      # 100 + 100
    ("host_fold_share.reads", 21.0),     # 490..700, counted once
    ("upload_share.reads", 4.0),
    ("sync_wait_share.reads", 9.0),      # 40 + 50
    ("syncs_per_step.reads", 2.0),
])
def test_span_shares(name, want):
    assert _read(name, _trace(SKETCH, BUSY)) == pytest.approx(want)


def test_ranges_clipped_to_the_window():
    spans = [(0, 1200, "sketch.stream"), (0, 300, "sketch.parse_wait"),
             (1000, 1300, "engine.upload"), (50, 90, "engine.step"),
             (60, 80, "engine.sync"), (1000, 1200, "engine.step"),
             (1010, 1020, "engine.sync"), (1030, 1040, "engine.sync")]
    t = _trace(spans, [(500, 600)])
    assert _read("parse_wait_share.reads", t) == pytest.approx(20.0)
    assert _read("upload_share.reads", t) == pytest.approx(10.0)
    # the step and sync that started before the window are not counted
    assert _read("syncs_per_step.reads", t) == pytest.approx(2.0)


def test_unattributed_idle_counts_root_and_bench_only():
    # the card is busy 50 of 1000 ns, all of it under engine.step; the
    # named spans cover 150..900 once merged, so 750 - 50 of the 950 idle
    # ns; left unattributed: 100..150 (bench.* alone) and 900..1100 (the
    # root, then bench.* alone)
    t = _trace(SKETCH, BUSY)
    got = _read("unattributed_idle_share.reads", t)
    assert got == pytest.approx(100.0 * 250 / 950)


def test_unattributed_idle_root_only_is_all_unattributed():
    t = _trace([(100, 1100, "sketch.stream")], [(400, 500)])
    assert _read("unattributed_idle_share.reads", t) == pytest.approx(100.0)
    # a named span over all the idle time leaves nothing unattributed
    t = _trace([(100, 1100, "sketch.stream"), (100, 1100, "engine_kmers")],
               [(400, 500)])
    assert _read("unattributed_idle_share.reads", t) == pytest.approx(0.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_span_or_the_card(name):
    # the parent program opens none of the port's spans
    assert _read(name, _trace([], BUSY)) is None
    # nothing ran on the card: no device timeline to lay the spans beside
    assert _read(name, _trace(SKETCH, [])) is None
    assert _read(name, None) is None


def test_none_when_only_other_spans_opened():
    spans = [(150, 1050, "sketch.stream"), (200, 300, "sketch.parse_wait")]
    t = _trace(spans, BUSY)
    assert _read("upload_share.reads", t) is None
    assert _read("host_fold_share.reads", t) is None
    assert _read("syncs_per_step.reads", t) is None
    assert _read("parse_wait_share.reads", t) == pytest.approx(10.0)


def test_readers_declared_for_the_reads_cell():
    bench = harness.Bench(ROOT)
    entries = {m["name"]: m for m in bench.spec["per_layer"]}
    layers = {m["layer"] for m in bench.spec["per_layer"][:4]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["reads_k21.isolate_30x"]
        assert (m["moves"], m["better"], m["source"]) == (
            "kmers_per_s", "lower", "program_span")
        assert m["layer"] in layers
        assert callable(bench.load("layer_metrics", name).read)
