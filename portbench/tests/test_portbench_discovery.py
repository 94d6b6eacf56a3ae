"""A configuration, a traffic mix and a per-layer metric added as new
files, with new BENCHMARK.json entries, are found without editing any
file that is there."""

import hashlib
import json
from pathlib import Path

from portbench import harness

READER = '''
def read(ctx):
    t = ctx.trace
    return None if t is None else float(t.ops)
'''


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*.py")}


def test_new_metric_by_new_files(tiny_root, tmp_path):
    import shutil

    root = tmp_path / "b"
    shutil.copytree(tiny_root, root)
    before = _digests(root)
    (root / "portbench" / "layer_metrics" / "ops_traced.test.py").write_text(
        READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "ops_traced.test", "unit": "ops", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "kmers_per_s",
        "workloads": ["reads_tiny.isolate_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell(root, "reads_tiny.isolate_small", 3, 0.3, True,
                         device="cpu", require_card=False)
    assert r["metrics"]["ops_traced.test"]["value"] == 1.0
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_tiny_cells_are_new_files(tiny_root):
    bench = harness.Bench(tiny_root)
    names = {w["name"] for w in bench.spec["workloads"]}
    assert "reads_tiny.isolate_small" in names
    cell = bench.cell("reads_tiny.isolate_small")
    assert cell.config["name"] == "reads_tiny"
    assert cell.traffic["generator"] == "isolate_fastq"
