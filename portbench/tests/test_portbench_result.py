"""The result line: its keys, their order and types, and the run
script's refusal without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import tiny
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(tiny_root, trace):
    r = harness.run_cell(tiny_root, "reads_tiny.isolate_small", 2**31 + 11,
                         0.5, trace, device="cpu", require_card=False)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == trace
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    # on the CPU no kernel runs on a card: the device metrics read nothing
    want = ({"parse_share.reads", "engine_share.reads"} if trace
            else {"kmers_per_s", "setup_s"})
    assert set(r["metrics"]) == want
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


class _Trace:
    def __init__(self, kernel_s, counters):
        self.counters, self._k = counters, kernel_s

    def kernel_s(self, names):
        return self._k


@pytest.mark.parametrize("case", ["probe_bypassed", "kernels_gone", "both"])
def test_kernel_roofline_reads_or_fails(case):
    from types import SimpleNamespace

    bench = harness.Bench(ROOT)
    read = bench.load("layer_metrics", "kernel_roofline.reads").read
    lanes = {"lanes.extract": 2 << 20, "calls.extract": 1}
    ran = {"extract_select": 1e-3}
    if case == "probe_bypassed":
        # the kernels ran while the probe saw no lanes: a fault, not None
        with pytest.raises(RuntimeError, match="LaneProbe"):
            read(SimpleNamespace(trace=_Trace(ran, {})))
    elif case == "kernels_gone":
        # lanes but none of the kernels: the steps left the path, silent
        assert read(SimpleNamespace(trace=_Trace({}, lanes))) is None
    else:
        v = read(SimpleNamespace(trace=_Trace(ran, lanes)))
        assert 0 < v < 100


def test_refuses_without_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "reads_k21.isolate_30x", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""


def test_every_cell_is_found():
    bench = harness.Bench(ROOT)
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        bench.load("entries", cell.config["entry"])
        bench.load("gen", cell.traffic["generator"])
        for m in bench.end_to_end(w["name"]):
            assert callable(bench.load("e2e", m["name"]).read)
        for m in bench.per_layer(w["name"]):
            assert callable(bench.load("layer_metrics", m["name"]).read)


@pytest.mark.cuda
def test_tiny_cells_on_card(tiny_root, card):
    for name in tiny.CELLS:
        r = harness.run_cell(tiny_root, name, 5, 0.5, False, device=card)
        assert r["correct"] is True, r["checks"]
