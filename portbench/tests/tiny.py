"""A copy of the benchmark with tiny cells added as new files, for the CPU
tests: the same harness, generators, entries and reference at sizes a
test run holds, with the port on the CPU (``--device cpu``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

READS = {"name": "reads_tiny", "entry": "finch_sketch", "sketch_type": "mash",
         "kmer_length": 21, "n_hashes": 200, "oversketch": 20,
         "hash_seed": 0, "err_filter_percent": 1, "strand_filter": 0.1,
         "backend": "torch", "reduced": []}
READS_TRAFFIC = {"generator": "isolate_fastq", "trace_ops": 1,
                 "params": {"genome_len": 30000, "coverage": 8,
                            "read_len": 150, "err": 0.005}}
CELLS = ("reads_tiny.isolate_small",)


def make_root(dst: Path) -> Path:
    """dst/BENCHMARK.json and dst/portbench: the benchmark's files with
    the tiny configurations, traffic mixes and cells added."""
    dst = Path(dst)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in (READS,):
        path = dst / "portbench" / "configs" / f"{conf['name']}.json"
        path.write_text(json.dumps(conf))
        spec["configs"].append({"name": conf["name"], "source": "test",
                                "file": f"portbench/configs/{path.name}",
                                "reduced": [], "why": "test"})
    for name, traffic in zip(CELLS, (READS_TRAFFIC,)):
        (dst / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        config, mix = name.split(".")
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": mix, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(CELLS)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst
