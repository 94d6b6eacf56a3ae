"""The wide-k cell (entry ``finch_sketch_wide``) found from new files and
entries alone: a tiny wide cell added to a copy of the benchmark runs on
the CPU, is judged correct by the wide reference, reports its readers or
leaves them out without raising, and edits no file that is there; a
fault in the wide step is judged not correct; ``wide_roofline.wide``
prices the meter's lanes and calls, and reads nothing from a program
without the span."""

import hashlib
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
WIDE = {"name": "reads_tiny_k51", "entry": "finch_sketch_wide",
        "sketch_type": "mash", "kmer_length": 51, "n_hashes": 100,
        "oversketch": 20, "hash_seed": 0, "err_filter_percent": 1,
        "strand_filter": 0.1, "backend": "torch", "reduced": []}
TRAFFIC = {"generator": "isolate_fastq", "trace_ops": 1,
           "params": {"genome_len": 10000, "coverage": 30, "read_len": 150,
                      "err": 0.005}}
CELL = "reads_tiny_k51.isolate_small"
# ``.reads`` readers of the layers the wide path shares with k <= 31,
# each read in the wide cell under its own name, or as itself where no
# test pins its list to the k = 21 cell; the other ``.reads`` readers
# price the extract and dedup kernels, which no wide step calls
ALIASES = ("upload_share", "parse_wait_share", "finalize_share",
           "host_fold_share", "unattributed_idle_share")
WIDE_READERS = ("wide_roofline.wide", "wide_step_share.wide",
                *(a + ".wide" for a in ALIASES))
SHARED = ("parse_share.reads", "engine_share.reads", "idle_share.reads")
READERS = WIDE_READERS + SHARED


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*.py")}


@pytest.fixture(scope="module")
def wide_root(tiny_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("wide") / "b"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    (root / "portbench" / "configs" / "reads_tiny_k51.json").write_text(
        json.dumps(WIDE))
    (root / "portbench" / "traffic" / f"{CELL}.json").write_text(
        json.dumps(TRAFFIC))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": WIDE["name"], "source": "test",
                            "file": "portbench/configs/reads_tiny_k51.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": WIDE["name"],
                              "traffic": "isolate_small", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "kmers_per_s" or m["name"] in READERS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root, before


def _run(root, trace):
    return harness.run_cell(root, CELL, 2**31 + 21, 0.3, trace, device="cpu",
                            require_card=False, log=lambda s: None)


@pytest.mark.parametrize("trace", [False, True])
def test_wide_cell_from_new_files(wide_root, trace):
    root, before = wide_root
    bench = harness.Bench(root)
    assert {m["name"] for m in bench.per_layer(CELL)} == set(READERS)
    r = _run(root, trace)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"ops_raised", "header_fields_differing",
                                "entries_differing"}
    # on the CPU no kernel runs on a card: the readers of the device and of
    # the spans on its timeline read nothing, and are left out
    want = ({"parse_share.reads", "engine_share.reads"} if trace
            else {"kmers_per_s", "setup_s"})
    assert set(r["metrics"]) == want
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_wide_step_fault_is_not_correct(wide_root, monkeypatch):
    from finch_tpu_torch.ops import bottomk_wide

    step = bottomk_wide.sketch_step

    def half(state, plo, phi, rc, nvalid, *args, **kwargs):
        return step(state, plo, phi, rc, nvalid // 2, *args, **kwargs)

    monkeypatch.setattr(bottomk_wide, "sketch_step", half)
    r = _run(wide_root[0], False)
    assert r["correct"] is False and r["failed"] >= 1


def _trace(ranges, device, counters, w0=0, w1=10**9):
    return SimpleNamespace(ranges=ranges, device=device, counters=counters,
                           w0=w0, w1=w1)


def _roofline(trace, n_hashes=1000, oversketch=200):
    mod = harness.Bench(ROOT).load("layer_metrics", "wide_roofline.wide")
    return mod.read(SimpleNamespace(
        trace=trace, config={"n_hashes": n_hashes, "oversketch": oversketch}))


SPAN = [(10, 20, "engine.step_wide")]
# 0.1 s of kernels in the window (one clipped), and copies and sets that
# do not count
KERNELS = [(0, 50_000_000, "void at::native::radixSort"),
           (-10_000_000, 50_000_000, "hash"),
           (0, 10**9, "Memcpy HtoD (Pageable -> Device)"),
           (0, 10**9, "Memset (Device)")]


def test_wide_roofline_prices_the_meter():
    lanes, calls = 2_000_000, 1
    got = _roofline(_trace(SPAN, KERNELS, {"step_wide.lanes": lanes,
                                           "step_wide.calls": calls}))
    need = 17 * lanes + calls * 2 * 5 * 8 * 200_000
    assert got == pytest.approx(100.0 * need / 3.35e12 / 0.1)


def test_wide_roofline_none_without_the_span_or_kernels():
    counters = {"step_wide.lanes": 5, "step_wide.calls": 1}
    # the parent program opens no engine.step_wide: nothing to read
    assert _roofline(_trace([], KERNELS, {})) is None
    assert _roofline(_trace([], KERNELS, counters)) is None
    # only copies on the card, or no trace
    assert _roofline(_trace(SPAN, KERNELS[2:], counters)) is None
    assert _roofline(None) is None


def test_wide_roofline_raises_when_the_meter_is_not_read():
    with pytest.raises(RuntimeError, match="wide_roofline.wide"):
        _roofline(_trace(SPAN, KERNELS, {}))


def test_wide_readers_declared_for_the_wide_cell():
    bench = harness.Bench(ROOT)
    entries = {m["name"]: m for m in bench.spec["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"][-1] == "reads_k51.isolate_30x"
        assert m["workloads"][:-1] == ([] if name in WIDE_READERS
                                       else ["reads_k21.isolate_30x"])
        assert m["moves"] == "kmers_per_s"
        assert callable(bench.load("layer_metrics", name).read)
        if name in WIDE_READERS[2:]:  # an alias keeps its metric's layer
            same = entries[name.replace(".wide", ".reads")]
            assert (m["layer"], m["source"]) == (same["layer"], same["source"])
    cell = bench.cell("reads_k51.isolate_30x")
    assert cell.chips == 1 and cell.config["kmer_length"] == 51
    assert {m["name"] for m in bench.per_layer(cell.name)} == set(READERS)


@pytest.mark.parametrize("base", ALIASES)
def test_wide_alias_reads_as_the_reads_metric(base):
    from test_portbench_spans import BUSY, SKETCH, _trace

    bench = harness.Bench(ROOT)
    alias = bench.load("layer_metrics", base + ".wide").read
    same = bench.load("layer_metrics", base + ".reads").read
    ctx = SimpleNamespace(trace=_trace(SKETCH, BUSY))
    assert alias(ctx) is not None and alias(ctx) == same(ctx)
    for trace in (_trace([], BUSY), None):  # nothing to read
        assert alias(SimpleNamespace(trace=trace)) is None
